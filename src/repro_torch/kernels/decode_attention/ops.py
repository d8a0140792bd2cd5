"""Decode attention entry point: the Hopper kernel on CUDA, plain on CPU.

Replaces ``src/repro/kernels/decode_attention/kernel.py::
decode_attention_pallas`` with ``csrc/decode_attention.cu``.
"""
from __future__ import annotations

import torch

from .. import build
from .ref import decode_attention_ref

launches = 0
"""Kernel launches since the last reset (a plain count, read by callers)."""

TARGET_BLOCKS = 264   # two blocks per SM of an H100 (132 SMs)
MIN_CHUNK = 64        # fewest cache slots one block walks


def split_plan(batch: int, hk: int, tlen: int):
    """(chunk, nsplit): split the cache so that about TARGET_BLOCKS blocks
    run, never giving a block fewer than MIN_CHUNK slots."""
    nsplit = max(1, min(tlen // MIN_CHUNK, -(-TARGET_BLOCKS // (batch * hk))))
    chunk = -(-tlen // nsplit)
    return chunk, -(-tlen // chunk)


def decode_attention(q, k, v, cache_len):
    """q (B,H,dh) vs cache k/v (B,T,Hk,dh), valid prefix cache_len (B,) int32."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, cache_len)
    global launches
    dev = build.require_cuda("decode_attention", q, k, v, cache_len)
    b, h, dh = q.shape
    t, hk = k.shape[1], k.shape[2]
    if q.dtype not in build.DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"decode_attention: q/k/v must share fp32 or bf16, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    g = h // hk if hk and h % hk == 0 else 0
    if (dh not in (64, 128) or g not in (1, 2, 4, 8) or k.shape != (b, t, hk, dh)
            or v.shape != k.shape):
        raise ValueError(f"decode_attention: unsupported shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} (dh 64/128, H/Hk in 1,2,4,8)")
    if cache_len.dtype != torch.int32 or cache_len.shape != (b,):
        raise ValueError("decode_attention: cache_len must be (B,) int32")
    chunk, nsplit = split_plan(b, hk, t)
    out = torch.empty_like(q)
    parts = b * hk * nsplit * g
    part_m = torch.empty(parts, dtype=torch.float32, device=dev)
    part_l = torch.empty(parts, dtype=torch.float32, device=dev)
    part_acc = torch.empty(parts * dh, dtype=torch.float32, device=dev)
    lib = build.load_library()
    rc = lib.decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), cache_len.data_ptr(), out.data_ptr(),
        part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(), b, t, hk, g, dh,
        build.DTYPE_CODES[q.dtype], chunk, nsplit, float(dh) ** -0.5,
        build.stream_ptr(dev))
    build.check(rc, "decode_attention")
    launches += 1
    return out
