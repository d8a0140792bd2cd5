"""Cache lookup entry point: the Hopper kernel on CUDA, plain on CPU.

Replaces ``src/repro/kernels/cosine_topk/kernel.py::cosine_topk_pallas``
with ``csrc/cosine_topk.cu``.
"""
from __future__ import annotations

import torch

from .. import build
from .ref import cosine_topk_ref

launches = 0
"""Kernel launches since the last reset (a plain count, read by callers)."""

MAX_K = 8


def cosine_topk(queries, db, valid, *, k: int = 4, block_n: int = 1024):
    """queries (B,D) f32 x db (N,D) f32, valid (N,) bool -> (scores, indices).

    ``block_n`` is the number of bank rows one kernel block scans.
    """
    if queries.device.type == "cpu":
        return cosine_topk_ref(queries, db, k, valid)
    global launches
    dev = build.require_cuda("cosine_topk", queries, db, valid)
    b, d = queries.shape
    n = db.shape[0]
    if queries.dtype != torch.float32 or db.dtype != torch.float32 or valid.dtype != torch.bool:
        raise ValueError("cosine_topk: queries and db must be float32, valid bool")
    if db.shape != (n, d) or valid.shape != (n,) or d % 32 or not 1 <= k <= min(MAX_K, n):
        raise ValueError(f"cosine_topk: unsupported shapes q {tuple(queries.shape)} "
                         f"db {tuple(db.shape)} k {k} (D % 32 == 0, k <= {MAX_K})")
    nchunks = -(-n // block_n)
    part_s = torch.empty(nchunks * b * k, dtype=torch.float32, device=dev)
    part_i = torch.empty(nchunks * b * k, dtype=torch.int32, device=dev)
    out_s = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    lib = build.load_library()
    rc = lib.cosine_topk_launch(
        queries.data_ptr(), db.data_ptr(), valid.data_ptr(), part_s.data_ptr(),
        part_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr(), b, n, d, k, block_n,
        build.stream_ptr(dev))
    build.check(rc, "cosine_topk")
    launches += 1
    return out_s, out_i
