"""Cache lookup entry points: the Hopper kernels on CUDA, plain on CPU.

Replaces ``src/repro/kernels/cosine_topk/kernel.py::cosine_topk_pallas``
with ``csrc/cosine_topk.cu`` and ``cosine_topk_gather_pallas`` with
``csrc/cosine_topk_gather.cu``.  :func:`scan_plan` and :func:`gather_plan`
state how a call of each is cut.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import build
from .ref import cosine_topk_gather_ref, cosine_topk_ref

launches = 0
"""Flat-scan kernel launches since the last reset (a plain count)."""
gather_launches = 0
"""Shortlist-scan kernel launches since the last reset (a plain count)."""

MAX_K = 8
QUERIES_PER_BLOCK = 8   # kQB: queries one scan block scores
ROWS_PER_STAGE = 128    # two threads per row, 4 queries each
SLICE = 32              # floats of a row per stage (kSliceF), so D % 32 == 0
STAGES = 4              # stages of the shared-memory ring
# the shortlist kernel (csrc/cosine_topk_gather.cu)
GATHER_THREADS = 256             # kThreads
GATHER_WARPS = GATHER_THREADS // 32
GATHER_ROUND = 4 * GATHER_THREADS   # kRound: positions loaded and compacted at once
GATHER_ROWS = 8                  # kRows: live rows a warp has in flight (a batch)
GATHER_ROW_FLOATS = 32 * 3 * 4   # floats of a row one pass reads (kF float4 a lane)
MAX_CLUSTER = 8                  # kMaxCluster: blocks of one query, one cluster
# Clusters of 1..8 blocks of the shortlist kernel that an H100 SXM holds at
# once, the least over its k instances (cudaOccupancyMaxActiveClusters;
# chip_smoke.py checks them on the card).
GATHER_WAVE_CLUSTERS = (132, 66, 39, 30, 22, 17, 15, 15)


@dataclass(frozen=True)
class ScanPlan:
    """How one flat scan is cut (mirrors ``csrc/cosine_topk.cu``): ``grid``
    (chunks of ``block_n`` rows, query groups of 8), ``smem_bytes`` a scan
    block's dynamic shared memory (the query group and the ring of row
    slices, rows padded by 4 floats)."""
    grid: tuple
    smem_bytes: int
    n: int
    block_n: int

    @property
    def chunks(self):
        """(start, stop) bank rows of each scan block."""
        return tuple((s, min(s + self.block_n, self.n)) for s in range(0, self.n, self.block_n))


def scan_plan(b: int, n: int, d: int, block_n: int) -> ScanPlan:
    smem = 4 * (QUERIES_PER_BLOCK * d + STAGES * ROWS_PER_STAGE * (SLICE + 4))
    return ScanPlan(grid=(-(-n // block_n), -(-b // QUERIES_PER_BLOCK)), smem_bytes=smem,
                    n=n, block_n=block_n)


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
    if queries.data_ptr() % 16 or db.data_ptr() % 16:
        raise ValueError("cosine_topk: queries and db must be 16-byte aligned")
    plan = scan_plan(b, n, d, block_n)
    if plan.smem_bytes > build.SMEM_PER_BLOCK:
        raise ValueError(f"cosine_topk: D {d} needs {plan.smem_bytes} bytes of shared "
                         f"memory, more than {build.SMEM_PER_BLOCK}")
    nchunks = plan.grid[0]
    part_s = torch.empty(nchunks * b * k, dtype=torch.float32, device=dev)
    part_i = torch.empty(nchunks * b * k, dtype=torch.int32, device=dev)
    out_s = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    lib = build.load_library()
    rc = build.launch(
        dev, lib.cosine_topk_launch, queries.data_ptr(), db.data_ptr(), valid.data_ptr(), part_s.data_ptr(),
        part_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr(), b, n, d, k, block_n)
    build.check(rc, "cosine_topk")
    launches += 1
    return out_s, out_i


@dataclass(frozen=True)
class GatherPlan:
    """How one shortlist scan is cut (mirrors ``csrc/cosine_topk_gather.cu``):
    ``grid`` (blocks of a query, queries), the blocks of a query one
    thread-block cluster of ``cluster`` blocks; each block scores ``block_m``
    positions in ``rounds`` rounds of GATHER_ROUND (loaded, compacted,
    scored) with ``rows_in_flight`` live rows in flight (GATHER_ROWS a warp),
    in ``row_passes`` passes over a row; ``smem_bytes`` a block's static
    shared memory."""
    grid: tuple
    cluster: int
    block_m: int
    rounds: int
    rows_in_flight: int
    row_passes: int
    smem_bytes: int
    m: int

    @property
    def blocks(self):
        """(start, stop) positions of each block of a query's cluster."""
        return tuple((s, min(s + self.block_m, self.m)) for s in range(0, self.m, self.block_m))


def _per_block(m: int, cluster: int) -> int:
    """Positions per block for ``cluster`` blocks over M: a multiple of 4 (the
    kernel's vector loads), so fewer blocks may be needed."""
    per = -(-m // cluster)
    return -(-per // 4) * 4


def gather_plan(b: int, m: int, d: int, k: int, block_m: int = 64) -> GatherPlan:
    """The cut of a call: each query's M positions over 1..MAX_CLUSTER blocks
    of at least ``block_m`` positions (all M where M < ``block_m``), choosing
    the count that gives the fewest positions per block times waves
    (clusters past ``GATHER_WAVE_CLUSTERS``, what the card holds at once, run
    in a second wave), the larger count on a tie."""
    most = max(1, min(MAX_CLUSTER, m // block_m))

    def cost(c):
        return -(-b // GATHER_WAVE_CLUSTERS[c - 1]) * _per_block(m, c)

    c = min(range(1, most + 1), key=lambda c: (cost(c), -c))
    per = _per_block(m, c)
    c = -(-m // per)
    # positions and rows of a round, warp counts, the warps' lists, rank 0's
    # barrier (8 bytes) and the cluster's lists (score, position, row)
    smem = 4 * (2 * GATHER_ROUND + GATHER_WARPS + 2 * GATHER_WARPS * k
                + 3 * MAX_CLUSTER * k) + 8
    return GatherPlan(grid=(c, b), cluster=c, block_m=per, rounds=-(-per // GATHER_ROUND),
                      rows_in_flight=GATHER_WARPS * GATHER_ROWS,
                      row_passes=-(-d // GATHER_ROW_FLOATS), smem_bytes=smem, m=m)


def cosine_topk_gather(queries, db, cand_idx, cand_valid, *, k: int = 4, block_m: int = 64):
    """Score only a per-query shortlist of bank rows.

    queries (B,D) f32 x db (N,D) f32, cand_idx (B,M) i32 bank rows (-1 =
    padding), cand_valid (B,M) bool -> (scores (B,k), global rows (B,k)).  A
    candidate is live where ``cand_valid & cand_idx >= 0`` (the kernel also
    counts an index >= N as dead).  On CUDA one kernel launch reads each
    live row of ``db`` by its index and never builds the (B,M,D) shortlist,
    and allocates only the outputs; ``block_m`` is the fewest candidate
    positions one kernel block scores: :func:`gather_plan` gives each block
    more where a query would otherwise need more than ``MAX_CLUSTER`` blocks
    (at B 8, M 2,048: 8 blocks of 256 positions per query).
    """
    if queries.device.type == "cpu":
        live = cand_valid & (cand_idx >= 0)
        cand_emb = db[cand_idx.clamp(min=0).long()]
        return cosine_topk_gather_ref(queries, cand_emb, cand_idx, live, k)
    global gather_launches
    dev = build.require_cuda("cosine_topk_gather", queries, db, cand_idx, cand_valid)
    b, d = queries.shape
    m = cand_idx.shape[1]
    if (queries.dtype != torch.float32 or db.dtype != torch.float32
            or cand_idx.dtype != torch.int32 or cand_valid.dtype != torch.bool):
        raise ValueError("cosine_topk_gather: queries and db must be float32, cand_idx "
                         "int32, cand_valid bool")
    if (db.dim() != 2 or db.shape[1] != d or cand_idx.shape != (b, m)
            or cand_valid.shape != (b, m) or d % 4 or m < 1 or block_m < 1
            or not 1 <= k <= MAX_K or b > 65535):
        raise ValueError(f"cosine_topk_gather: unsupported shapes q {tuple(queries.shape)} "
                         f"db {tuple(db.shape)} cand {tuple(cand_idx.shape)} k {k} "
                         f"(D % 4 == 0, 1 <= k <= {MAX_K}, B <= 65535)")
    if queries.data_ptr() % 16 or db.data_ptr() % 16:
        raise ValueError("cosine_topk_gather: queries and db must be 16-byte aligned")
    plan = gather_plan(b, m, d, k, block_m)
    out_s = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    lib = build.load_library()
    rc = build.launch(
        dev, lib.cosine_topk_gather_launch, queries.data_ptr(), db.data_ptr(),
        cand_idx.data_ptr(), cand_valid.data_ptr(), out_s.data_ptr(), out_i.data_ptr(), b,
        db.shape[0], m, d, k, plan.block_m)
    build.check(rc, "cosine_topk_gather")
    gather_launches += 1
    return out_s, out_i
