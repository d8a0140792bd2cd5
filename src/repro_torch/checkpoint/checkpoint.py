"""Reader for the checkpoint layout of ``src/repro/checkpoint/checkpoint.py``.

A checkpoint is a directory ``step_<n>`` holding ``arrays.npz`` (leaves keyed
by their flattened pytree path, e.g. ``scan/0/attn/w_q``; bf16 leaves stored
as fp32) and ``meta.msgpack`` (step, the original dtype of every leaf, and
free metadata).  Only numpy and msgpack are needed to read it.
"""
from __future__ import annotations

import os
from typing import Dict, Tuple

import msgpack
import numpy as np


def read_checkpoint(ckpt_dir: str, step: int) -> Tuple[Dict[str, np.ndarray], dict]:
    """Returns (flat {path: array}, meta); ``meta["dtypes"]`` names each leaf's
    original dtype (a bf16 leaf comes back as its fp32 copy)."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "meta.msgpack"), "rb") as f:
        meta = msgpack.unpackb(f.read())
    with np.load(os.path.join(path, "arrays.npz")) as data:
        flat = {k: data[k] for k in data.files}
    missing = set(meta["dtypes"]) - set(flat)
    if missing:
        raise ValueError(f"checkpoint {path} lacks arrays for {sorted(missing)}")
    return flat, meta
