"""Reader and writer of the checkpoint layout of
``src/repro/checkpoint/checkpoint.py``.

A checkpoint is a directory ``step_<n>`` holding ``arrays.npz`` (leaves keyed
by their flattened pytree path, e.g. ``scan/0/attn/w_q``; bf16 leaves stored
as fp32) and ``meta.msgpack`` (step, the original dtype of every leaf, and
free metadata), written atomically through a temporary directory.  Only
numpy and msgpack are needed; the JAX package's ``load_checkpoint`` restores
what ``save_checkpoint`` writes.
"""
from __future__ import annotations

import os
import shutil
from typing import Dict, Optional, Tuple

import msgpack
import numpy as np


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """{"a/b/0": leaf} of a tree of dicts, lists and arrays."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    flat = {}
    for key, sub in items:
        flat.update(_flatten(sub, f"{prefix}/{key}" if prefix else str(key)))
    return flat


def save_checkpoint(ckpt_dir: str, step: int, tree, metadata: Optional[dict] = None, *,
                    dtypes: Optional[Dict[str, str]] = None) -> str:
    """Write ``tree`` (numpy leaves; a flat ``{path: array}`` such as
    ``convert.torch_params_to_jax`` returns is a tree too) as
    ``ckpt_dir/step_<step>``; returns that path.  ``dtypes`` names the
    original dtype of leaves held here in a wider one: a "bfloat16" leaf is
    stored as its exact fp32 copy and restored as bf16 by the reader
    (``convert.torch_param_dtypes`` gives them for port parameters)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step}")
    final = os.path.join(ckpt_dir, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = _flatten(tree)
    names = {k: str(v.dtype) for k, v in flat.items()}
    names.update(dtypes or {})
    np.savez_compressed(os.path.join(tmp, "arrays.npz"),
                        **{k: v.astype(np.float32) if names[k] == "bfloat16" else v
                           for k, v in flat.items()})
    meta = {"step": step, "dtypes": names, "metadata": metadata or {}}
    with open(os.path.join(tmp, "meta.msgpack"), "wb") as f:
        f.write(msgpack.packb(meta))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_checkpoint(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_")]
    return max(steps) if steps else None


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
