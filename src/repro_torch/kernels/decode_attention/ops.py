"""Decode attention entry points: the Hopper kernels on CUDA, plain on CPU.

``decode_attention`` replaces ``src/repro/kernels/decode_attention/
kernel.py::decode_attention_pallas`` with ``csrc/decode_attention.cu``;
``decode_attention_block`` (the speculative verify block) replaces
``decode_attention_block_pallas`` with ``csrc/decode_attention_block.cu``.

:func:`launch_plan` states how a call of these kernels, and of the paged
ones (``paged_attention.ops``), is cut; it mirrors the constants of
``csrc/panel_mma.cuh`` and ``csrc/attention_panel.cuh``.  bf16 runs on the
tensor cores, one block per (row, KV head, split of 64-slot tiles, panel
of at most 16 (query, head) rows), its splits merged inside their
thread-block cluster: one launch, no scratch.  fp32 runs on the CUDA cores
and merges its splits in a second launch through fp32 scratch.  A meta
tensor given to ``decode_attention`` (the dry-run) gets an empty output and
adds 4 * dh FLOPs per (head, cache slot) to ``kernels.meta.flops``, the
whole capacity taken as live since meta lengths have no values.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import build, meta
from .ref import decode_attention_block_ref, decode_attention_ref

launches = 0
"""Kernel launches since the last reset (a plain count, read by callers)."""
block_launches = 0
"""The same count for ``decode_attention_block``."""

TARGET_BLOCKS = 264   # two blocks per SM of an H100 (132 SMs)
MIN_CHUNK = 64        # fewest cache slots one CUDA-core block walks
TILE = 64             # slots per tile of the tensor-core body (kTile)
MAX_COLS = 16         # (query, head) rows per tensor-core panel (kMaxCols)
MAX_SPLITS = 8        # splits of one thread-block cluster (kMaxSplits)
PANEL_ROWS = 16       # (query, head) rows per fp32 panel (kMaxRows)
# Clusters of 1..8 blocks (the splits of a panel) of the tensor-core body
# that an H100 SXM holds at once at dh 128, two blocks per SM
# (cudaOccupancyMaxActiveClusters; chip_smoke.py checks them on the card).
# More clusters than that run a second wave, which doubles a call's time.
WAVE_CLUSTERS = (264, 132, 79, 62, 47, 39, 32, 30)
# The same at dh 256, whose ~141 KB of shared memory leave one block a SM
# (chip_smoke.py checks them too).
WAVE_CLUSTERS_ONE_A_SM = (132, 66, 39, 30, 22, 17, 15, 15)
# The shapes each body has instances for: bf16 the tensor-core panel body
# (panel_mma.cuh; a panel of at most MAX_COLS rows takes any G, these are the
# configs' G: G 16, qwen3-moe's and recurrentgemma's, fills a panel with one
# query; G 6, internvl2's, takes two queries a panel of a K-4 verify block),
# dh 256 (recurrentgemma's) in the dense single-token kernel only; fp32 the
# CUDA-core bodies, the single-token one (decode_attention.cu) and the verify
# and paged panel (attention_panel.cuh) alike: below dh 32 a cache slot's row
# is spread over 16 lanes (dh 16) or 8 lanes of 3 elements (dh 24), a warp
# taking 2 or 4 slots at once (the smoke configs, the serve CLI's tiny stack,
# the small LM of the reference's examples/serve_e2e.py).
BF16_SHAPES = ((64, 80, 128, 192), (1, 2, 4, 6, 7, 8, 12, 16))
BF16_DECODE_SHAPES = ((64, 80, 128, 192, 256), BF16_SHAPES[1])
FP32_SHAPES = ((16, 24, 32, 64, 128), (1, 2, 4, 8))


def split_plan(batch: int, hk: int, tlen: int):
    """(chunk, nsplit) of the CUDA-core route: split the cache so that about
    TARGET_BLOCKS blocks run, never giving a block fewer than MIN_CHUNK
    slots."""
    nsplit = max(1, min(tlen // MIN_CHUNK, -(-TARGET_BLOCKS // (batch * hk))))
    chunk = -(-tlen // nsplit)
    return chunk, -(-tlen // chunk)


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
    4 and PANEL_ROWS / G (the panel instances attention_panel.cuh has)."""
    cap, t = min(PANEL_ROWS // g, 4), 1
    while t < kq and t < cap:
        t *= 2
    return t


def launch_plan(b: int, kq: int, cap: int, hk: int, g: int, dh: int, dtype) -> LaunchPlan:
    """The cut of a call of ``kq`` queries (1 for the single-token kernels)
    over ``cap`` slots: the dense cache's T, or the paged cache's cap.
    bf16: ~TARGET_BLOCKS blocks, each split a whole number of ``TILE``-slot
    tiles counted from slot 0, panels of ``min(K, MAX_COLS // G)`` queries,
    and no more clusters (one per (row, KV head, panel)) than
    ``WAVE_CLUSTERS`` (``WAVE_CLUSTERS_ONE_A_SM`` at dh 256) holds at once
    for their split count.  The cut does not
    depend on the page size: tiles are counted in slots."""
    if dtype == torch.bfloat16:
        ntiles = -(-cap // TILE)
        kqp = min(kq, MAX_COLS // g)
        panels = -(-kq // kqp)
        clusters = b * hk * panels
        waves = WAVE_CLUSTERS if dh <= 192 else WAVE_CLUSTERS_ONE_A_SM
        splits = min(ntiles, -(-TARGET_BLOCKS // clusters), MAX_SPLITS)
        while splits > 1 and clusters > waves[splits - 1]:
            splits -= 1
        per_split = -(-ntiles // splits)
        splits = -(-ntiles // per_split)
        # two (K, V) tile buffers, the positions and rows of both, the Q panel,
        # a flag per tile
        row = build.smem_row_bytes(dh)
        smem = 4 * TILE * row + 2 * TILE * (4 + 8) + MAX_COLS * row + -(-per_split // 16) * 16
        return LaunchPlan("mma", (b * hk, splits, panels), TILE, per_split * TILE, splits,
                          kqp, smem)
    chunk, nsplit = split_plan(b, hk, cap)
    kqp = _pick_kq(kq, g)
    return LaunchPlan("panel", (b * hk, nsplit, -(-kq // kqp)), chunk, chunk, nsplit, kqp, 0)


def partial_states(name, dev, plan: LaunchPlan, b, hk, rows, dh):
    """The three partial-state buffers (m, l, acc) a launch takes: fp32
    scratch of ``b * hk * splits * rows`` (query, head) rows, allocated only
    where the panel route merges its splits in a second launch (None
    otherwise); the caller holds them until the launch is enqueued.  Raises
    when the plan's shared memory exceeds a block's."""
    if plan.smem_bytes > build.SMEM_PER_BLOCK:
        raise ValueError(f"{name}: {plan.smem_bytes} bytes of shared memory exceed "
                         f"{build.SMEM_PER_BLOCK}")
    if plan.route == "mma" or plan.splits == 1:
        return (None,) * 3
    parts = b * hk * plan.splits * rows
    return tuple(torch.empty(n, dtype=torch.float32, device=dev)
                 for n in (parts, parts, parts * dh))


def ptr(x):
    """A tensor's device address for ctypes, or None (a null pointer)."""
    return None if x is None else x.data_ptr()


def check_aligned(name, q, *cache):
    """cp.async on the tensor-core route copies 16 bytes at a time."""
    if q.dtype == torch.bfloat16 and any(x.data_ptr() % 16 for x in (q, *cache)):
        raise ValueError(f"{name}: q and the cache must be 16-byte aligned")


def shapes_taken(dtype, single: bool):
    """(head dims, groups H/Hk) the kernels take for ``dtype``; ``single``:
    the dense single-token kernel, whose bf16 body also takes dh 256 (its
    fp32 body takes what the verify and paged panel takes)."""
    if dtype == torch.bfloat16:
        return BF16_DECODE_SHAPES if single else BF16_SHAPES
    return FP32_SHAPES


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
    dims, groups = shapes_taken(q.dtype, single=not kq_axis)
    if (dh not in dims or g not in groups or k.shape != (b, t, hk, dh)
            or v.shape != k.shape or q.dim() != (4 if kq_axis else 3)):
        raise ValueError(f"{name}: unsupported shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} (dh in {dims}, H/Hk in {groups} "
                         f"for {q.dtype})")
    check_aligned(name, q, k, v)
    return b, kq, t, hk, g, dh


def decode_attention(q, k, v, cache_len):
    """q (B,H,dh) vs cache k/v (B,T,Hk,dh), valid prefix cache_len (B,) int32."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, cache_len)
    if q.device.type == "meta":
        b, h, dh = q.shape
        return meta.output(q, 4 * dh * b * h * k.shape[1])
    global launches
    dev = build.require_cuda("decode_attention", q, k, v, cache_len)
    b, _, t, hk, g, dh = _check_qkv("decode_attention", q, k, v, False)
    if cache_len.dtype != torch.int32 or cache_len.shape != (b,):
        raise ValueError("decode_attention: cache_len must be (B,) int32")
    plan = launch_plan(b, 1, t, hk, g, dh, q.dtype)
    parts = partial_states("decode_attention", dev, plan, b, hk, g, dh)
    out = torch.empty_like(q)
    rc = build.launch(
        dev, build.load_library().decode_attention_launch, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), cache_len.data_ptr(), out.data_ptr(), *map(ptr, parts), b, t, hk, g, dh,
        build.DTYPE_CODES[q.dtype], plan.chunk, plan.splits, dh ** -0.5)
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
    plan = launch_plan(b, kq, t, hk, g, dh, q.dtype)
    parts = partial_states("decode_attention_block", dev, plan, b, hk, kq * g, dh)
    out = torch.empty_like(q)
    rc = build.launch(
        dev, build.load_library().decode_attention_block_launch, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), cache_len.data_ptr(), out.data_ptr(), *map(ptr, parts), b, kq, t, hk, g,
        dh, build.DTYPE_CODES[q.dtype], plan.chunk, plan.splits, plan.kq_panel,
        dh ** -0.5)
    build.check(rc, "decode_attention_block")
    block_launches += 1
    return out
