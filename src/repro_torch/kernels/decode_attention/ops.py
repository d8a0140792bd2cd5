"""Decode attention entry points: the Hopper kernels on CUDA, plain on CPU.

``decode_attention`` replaces ``src/repro/kernels/decode_attention/
kernel.py::decode_attention_pallas`` with ``csrc/decode_attention.cu``;
``decode_attention_block`` (the speculative verify block) replaces
``decode_attention_block_pallas`` with ``csrc/decode_attention_block.cu``.
"""
from __future__ import annotations

import torch

from .. import build
from .ref import decode_attention_block_ref, decode_attention_ref

launches = 0
"""Kernel launches since the last reset (a plain count, read by callers)."""
block_launches = 0
"""The same count for ``decode_attention_block``."""

TARGET_BLOCKS = 264   # two blocks per SM of an H100 (132 SMs)
MIN_CHUNK = 64        # fewest cache slots one block walks


def split_plan(batch: int, hk: int, tlen: int):
    """(chunk, nsplit): split the cache so that about TARGET_BLOCKS blocks
    run, never giving a block fewer than MIN_CHUNK slots."""
    nsplit = max(1, min(tlen // MIN_CHUNK, -(-TARGET_BLOCKS // (batch * hk))))
    chunk = -(-tlen // nsplit)
    return chunk, -(-tlen // chunk)


def _check_qkv(name, q, k, v, kq_axis: bool):
    """(b, kq, t, hk, g, dh) of a decode call; raises on what the kernels
    do not take."""
    if q.dtype not in build.DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: q/k/v must share fp32 or bf16, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    b, h, dh = q.shape[0], q.shape[-2], q.shape[-1]
    kq = q.shape[1] if kq_axis else 1
    t, hk = k.shape[1], k.shape[2]
    g = h // hk if hk and h % hk == 0 else 0
    if (dh not in (64, 128) or g not in (1, 2, 4, 8) or k.shape != (b, t, hk, dh)
            or v.shape != k.shape or q.dim() != (4 if kq_axis else 3)):
        raise ValueError(f"{name}: unsupported shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} (dh 64/128, H/Hk in 1,2,4,8)")
    return b, kq, t, hk, g, dh


def _scratch(dev, b, hk, nsplit, rows, dh):
    parts = b * hk * nsplit * rows
    return (torch.empty(parts, dtype=torch.float32, device=dev),
            torch.empty(parts, dtype=torch.float32, device=dev),
            torch.empty(parts * dh, dtype=torch.float32, device=dev))


def decode_attention(q, k, v, cache_len):
    """q (B,H,dh) vs cache k/v (B,T,Hk,dh), valid prefix cache_len (B,) int32."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, cache_len)
    global launches
    dev = build.require_cuda("decode_attention", q, k, v, cache_len)
    b, _, t, hk, g, dh = _check_qkv("decode_attention", q, k, v, False)
    if cache_len.dtype != torch.int32 or cache_len.shape != (b,):
        raise ValueError("decode_attention: cache_len must be (B,) int32")
    chunk, nsplit = split_plan(b, hk, t)
    out = torch.empty_like(q)
    part_m, part_l, part_acc = _scratch(dev, b, hk, nsplit, g, dh)
    lib = build.load_library()
    rc = lib.decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), cache_len.data_ptr(), out.data_ptr(),
        part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(), b, t, hk, g, dh,
        build.DTYPE_CODES[q.dtype], chunk, nsplit, float(dh) ** -0.5,
        build.stream_ptr(dev))
    build.check(rc, "decode_attention")
    launches += 1
    return out


def decode_attention_block(q, k, v, cache_len):
    """q (B,K,H,dh) whose keys sit at slots ``cache_len + i`` of cache k/v
    (B,T,Hk,dh); query i keeps slots ``t < cache_len + i + 1``; cache_len
    (B,) int32 counts the slots filled before the block."""
    if q.device.type == "cpu":
        return decode_attention_block_ref(q, k, v, cache_len)
    global block_launches
    dev = build.require_cuda("decode_attention_block", q, k, v, cache_len)
    b, kq, t, hk, g, dh = _check_qkv("decode_attention_block", q, k, v, True)
    if cache_len.dtype != torch.int32 or cache_len.shape != (b,):
        raise ValueError("decode_attention_block: cache_len must be (B,) int32")
    chunk, nsplit = split_plan(b, hk, t)
    out = torch.empty_like(q)
    part_m, part_l, part_acc = _scratch(dev, b, hk, nsplit, kq * g, dh)
    lib = build.load_library()
    rc = lib.decode_attention_block_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), cache_len.data_ptr(), out.data_ptr(),
        part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(), b, kq, t, hk, g, dh,
        build.DTYPE_CODES[q.dtype], chunk, nsplit, float(dh) ** -0.5, build.stream_ptr(dev))
    build.check(rc, "decode_attention_block")
    block_launches += 1
    return out
