"""Paged decode attention entry points: the Hopper kernels on CUDA, plain
on CPU.

``paged_decode_attention`` replaces ``src/repro/kernels/paged_attention/
kernel.py::paged_decode_attention_pallas`` and ``paged_decode_attention_
block`` replaces ``paged_decode_attention_block_pallas``; both launch
``csrc/paged_attention.cu``.  The kernels read K/V through the block table
and never build the dense cache.

Both are cut by ``decode_attention.ops.launch_plan`` with ``cap`` slots, as
the dense kernels are with T: bf16 runs on the tensor cores
(``csrc/panel_mma.cuh``), fp32 on the CUDA-core panel body.
"""
from __future__ import annotations

import torch

from .. import build
from ..decode_attention.ops import (check_aligned, launch_plan, partial_states, ptr,
                                    shapes_taken)
from .ref import paged_decode_attention_block_ref, paged_decode_attention_ref

launches = 0
"""``paged_decode_attention`` launches since the last reset."""
block_launches = 0
"""``paged_decode_attention_block`` launches since the last reset."""


def _check_paged(name, q, kp, vp, block_tbl, slot_pos, kq_axis: bool):
    """(b, kq, cap, hk, g, dh, page, npg) of a paged call; raises on what
    the kernels do not take."""
    if q.dtype not in build.DTYPE_CODES or kp.dtype != q.dtype or vp.dtype != q.dtype:
        raise ValueError(f"{name}: q/kp/vp must share fp32 or bf16, got "
                         f"{q.dtype}/{kp.dtype}/{vp.dtype}")
    b, h, dh = q.shape[0], q.shape[-2], q.shape[-1]
    kq = q.shape[1] if kq_axis else 1
    hk = kp.shape[2] if kp.dim() == 4 else 0
    g = h // hk if hk and h % hk == 0 else 0
    dims, groups = shapes_taken(q.dtype, single=False)
    if (dh not in dims or g not in groups or kp.dim() != 4 or kp.shape[3] != dh
            or vp.shape != kp.shape or q.dim() != (4 if kq_axis else 3)):
        raise ValueError(f"{name}: unsupported shapes q {tuple(q.shape)} "
                         f"kp {tuple(kp.shape)} (dh in {dims}, H/Hk in {groups} "
                         f"for {q.dtype})")
    page = kp.shape[1]
    npg, cap = block_tbl.shape[-1], slot_pos.shape[-1]
    if (block_tbl.dtype != torch.int32 or slot_pos.dtype != torch.int32
            or block_tbl.shape != (b, npg) or slot_pos.shape != (b, cap) or npg * page < cap):
        raise ValueError(f"{name}: block_tbl (B,npg) and slot_pos (B,cap) must be int32 "
                         f"with npg * page >= cap, got {tuple(block_tbl.shape)} "
                         f"{tuple(slot_pos.shape)} page {page}")
    check_aligned(name, q, kp, vp)
    return b, kq, cap, hk, g, dh, page, npg


def _launch(entry, name, dev, q, kp, vp, block_tbl, slot_pos, q_pos, shape):
    b, kq, cap, hk, g, dh, page, npg = shape
    plan = launch_plan(b, kq, cap, hk, g, dh, q.dtype)
    parts = partial_states(name, dev, plan, b, hk, kq * g, dh)
    out = torch.empty_like(q)
    block = () if q_pos is None else (q_pos.data_ptr(),)   # the verify block's extra
    rc = build.launch(dev, entry, q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                      block_tbl.data_ptr(), slot_pos.data_ptr(), *block, out.data_ptr(),
                      *map(ptr, parts), b, *(() if q_pos is None else (kq,)), cap, hk, g, dh,
                      page, npg, build.DTYPE_CODES[q.dtype], plan.chunk, plan.splits,
                      plan.kq_panel, dh ** -0.5)
    build.check(rc, name)
    return out


def paged_decode_attention(q, kp, vp, block_tbl, slot_pos):
    """q (B,H,dh) vs pool pages kp/vp (P+1,page,Hk,dh) through block_tbl
    (B,npg) int32; slots with ``slot_pos`` (B,cap) int32 < 0 are masked."""
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, kp, vp, block_tbl, slot_pos)
    global launches
    dev = build.require_cuda("paged_decode_attention", q, kp, vp, block_tbl, slot_pos)
    shape = _check_paged("paged_decode_attention", q, kp, vp, block_tbl, slot_pos, False)
    out = _launch(build.load_library().paged_decode_attention_launch, "paged_decode_attention",
                  dev, q, kp, vp, block_tbl, slot_pos, None, shape)
    launches += 1
    return out


def paged_decode_attention_block(q, kp, vp, block_tbl, slot_pos, q_pos):
    """q (B,K,H,dh), query i at absolute position ``q_pos + i`` (q_pos (B,)
    int32), against pool pages through block_tbl; keeps ``slot_pos >= 0 &
    slot_pos <= q_pos + i``."""
    if q.device.type == "cpu":
        return paged_decode_attention_block_ref(q, kp, vp, block_tbl, slot_pos, q_pos)
    global block_launches
    dev = build.require_cuda("paged_decode_attention_block", q, kp, vp, block_tbl,
                             slot_pos, q_pos)
    shape = _check_paged("paged_decode_attention_block", q, kp, vp, block_tbl, slot_pos, True)
    if q_pos.dtype != torch.int32 or q_pos.shape != (shape[0],):
        raise ValueError("paged_decode_attention_block: q_pos must be (B,) int32")
    out = _launch(build.load_library().paged_decode_attention_block_launch,
                  "paged_decode_attention_block", dev, q, kp, vp, block_tbl, slot_pos, q_pos,
                  shape)
    block_launches += 1
    return out
