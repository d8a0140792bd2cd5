"""Paged decode attention entry points: the Hopper kernels on CUDA, plain
on CPU.

``paged_decode_attention`` replaces ``src/repro/kernels/paged_attention/
kernel.py::paged_decode_attention_pallas`` and ``paged_decode_attention_
block`` replaces ``paged_decode_attention_block_pallas``; both launch
``csrc/paged_attention.cu``.  The kernels read K/V through the block table
and never build the dense cache.

:func:`launch_plan` states how a call is cut (it mirrors the constants of
``csrc/panel_mma.cuh`` and ``csrc/attention_panel.cuh``): bf16 runs on the
tensor cores, one block per (row, KV head, split of 64-slot tiles, panel
of at most 16 (query, head) rows); fp32 runs the CUDA-core panel body.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import build
from ..decode_attention.ops import TARGET_BLOCKS, _scratch, split_plan
from .ref import paged_decode_attention_block_ref, paged_decode_attention_ref

launches = 0
"""``paged_decode_attention`` launches since the last reset."""
block_launches = 0
"""``paged_decode_attention_block`` launches since the last reset."""

TILE = 64          # slots per tile of the tensor-core body (kTile)
MAX_COLS = 16      # (query, head) rows per tensor-core panel (kMaxCols)
MAX_SPLITS = 8     # splits of one thread-block cluster (kMaxSplits)
PANEL_ROWS = 16    # (query, head) rows per fp32 panel (kMaxRows)


@dataclass(frozen=True)
class LaunchPlan:
    """How one call is cut into blocks.

    ``route`` "mma" (bf16, tensor cores) or "panel" (fp32, CUDA cores);
    ``grid`` the (B*Hk, splits, panels) block counts; ``tile`` the slots a
    block gathers at once (the whole split on the panel route);
    ``chunk`` slots per split; ``kq_panel`` queries per panel;
    ``smem_bytes`` the dynamic shared memory of a block.  The mma route
    merges its splits inside their thread-block cluster, the panel route in
    a second launch.
    """
    route: str
    grid: tuple
    tile: int
    chunk: int
    splits: int
    kq_panel: int
    smem_bytes: int

    def tiles(self, split: int, cap: int):
        """(start, stop) of each tile of ``split``, in slot order."""
        lo, hi = split * self.chunk, min((split + 1) * self.chunk, cap)
        return [(s, min(s + self.tile, hi)) for s in range(lo, hi, self.tile)]

    def panel_queries(self, z: int, kq: int):
        """The queries of panel ``z``."""
        return range(z * self.kq_panel, min((z + 1) * self.kq_panel, kq))


def _pick_kq(kq: int, g: int) -> int:
    """Queries per fp32 panel: the fewest powers of two covering K, at most
    4 and PANEL_ROWS / G (attention_panel.cuh::pick_kq's rule; the kernel
    takes the number from here)."""
    cap, t = min(PANEL_ROWS // g, 4), 1
    while t < kq and t < cap:
        t *= 2
    return t


def launch_plan(b: int, kq: int, cap: int, hk: int, g: int, dh: int, page: int,
                dtype) -> LaunchPlan:
    """The cut of a paged call of ``kq`` queries (1 for the single-token
    kernel).  bf16: ~TARGET_BLOCKS blocks, each split a whole number of
    ``TILE``-slot tiles, panels of ``min(K, MAX_COLS // G)`` queries."""
    del page   # the cut does not depend on it: tiles are counted in slots
    if dtype == torch.bfloat16:
        ntiles = -(-cap // TILE)
        kqp = min(kq, MAX_COLS // g)
        panels = -(-kq // kqp)
        want = -(-TARGET_BLOCKS // (b * hk * panels))
        per_split = -(-ntiles // min(ntiles, want, MAX_SPLITS))
        splits = -(-ntiles // per_split)
        # two (K, V) tile buffers, the positions and rows of both, the Q panel,
        # a flag per tile
        smem = (4 * TILE * dh * 2 + 2 * TILE * (4 + 8) + MAX_COLS * dh * 2
                + -(-per_split // 16) * 16)
        return LaunchPlan("mma", (b * hk, splits, panels), TILE, per_split * TILE, splits,
                          kqp, smem)
    chunk, nsplit = split_plan(b, hk, cap)
    kqp = _pick_kq(kq, g)
    return LaunchPlan("panel", (b * hk, nsplit, -(-kq // kqp)), chunk, chunk, nsplit, kqp, 0)


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
    if (dh not in (64, 128) or g not in (1, 2, 4, 8) or kp.dim() != 4 or kp.shape[3] != dh
            or vp.shape != kp.shape or q.dim() != (4 if kq_axis else 3)):
        raise ValueError(f"{name}: unsupported shapes q {tuple(q.shape)} "
                         f"kp {tuple(kp.shape)} (dh 64/128, H/Hk in 1,2,4,8)")
    page = kp.shape[1]
    npg, cap = block_tbl.shape[-1], slot_pos.shape[-1]
    if (block_tbl.dtype != torch.int32 or slot_pos.dtype != torch.int32
            or block_tbl.shape != (b, npg) or slot_pos.shape != (b, cap) or npg * page < cap):
        raise ValueError(f"{name}: block_tbl (B,npg) and slot_pos (B,cap) must be int32 "
                         f"with npg * page >= cap, got {tuple(block_tbl.shape)} "
                         f"{tuple(slot_pos.shape)} page {page}")
    if q.dtype == torch.bfloat16 and (kp.data_ptr() % 16 or vp.data_ptr() % 16):
        raise ValueError(f"{name}: kp and vp must be 16-byte aligned")
    return b, kq, cap, hk, g, dh, page, npg


def _launch(entry, name, dev, q, kp, vp, block_tbl, slot_pos, q_pos, shape, plan):
    b, kq, cap, hk, g, dh, page, npg = shape
    if plan.smem_bytes > build.SMEM_PER_BLOCK:
        raise ValueError(f"{name}: {plan.smem_bytes} bytes of shared memory exceed "
                         f"{build.SMEM_PER_BLOCK} (cap {cap})")
    out = torch.empty_like(q)
    # partial states through device memory only where a second launch merges
    parts = ((None,) * 3 if plan.splits == 1 or plan.route == "mma" else
             [x.data_ptr() for x in _scratch(dev, b, hk, plan.splits, kq * g, dh)])
    block = () if q_pos is None else (q_pos.data_ptr(),)   # the verify block's extra
    rc = entry(q.data_ptr(), kp.data_ptr(), vp.data_ptr(), block_tbl.data_ptr(),
               slot_pos.data_ptr(), *block, out.data_ptr(), *parts, b,
               *(() if q_pos is None else (kq,)), cap, hk, g, dh, page, npg,
               build.DTYPE_CODES[q.dtype], plan.chunk, plan.splits, plan.kq_panel,
               float(dh) ** -0.5, build.stream_ptr(dev))
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
    plan = launch_plan(*shape[:7], q.dtype)
    out = _launch(build.load_library().paged_decode_attention_launch, "paged_decode_attention",
                  dev, q, kp, vp, block_tbl, slot_pos, None, shape, plan)
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
    plan = launch_plan(*shape[:7], q.dtype)
    out = _launch(build.load_library().paged_decode_attention_block_launch,
                  "paged_decode_attention_block", dev, q, kp, vp, block_tbl, slot_pos, q_pos,
                  shape, plan)
    block_launches += 1
    return out
