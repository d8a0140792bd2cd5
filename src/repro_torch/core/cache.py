"""Semantic vector cache (counterpart of ``src/repro/core/cache.py``).

Fixed-capacity state on the device: unit-norm embeddings, token buffers of
the cached query/response texts, a validity mask, and the bookkeeping of
the FIFO (ring pointer), LRU (``last_used`` against ``clock``) and LFU
(``hits``) policies.  Lookup is the flat cosine top-k scan
(``kernels.cosine_topk``) or, with ``index="ivf"``, the clustered index of
``core/index.py`` (``kernels.cosine_topk`` shortlist scan), beside which
the state carries the per-cluster admission statistics (``adm_ema``,
``adm_count``).  The kernels run on CUDA; their plain versions on the CPU.
``make_second_stage`` builds the router cascade's stage 2, which rereads
the shortlist's cached queries with the cross-encoder reranker.

Updates happen in place: the JAX package donates the state buffers to each
jitted step, so no caller may hold an older state.  The functions still
return the state dict for the JAX package's calling convention.

Scatters with "no row" (-1) indices: the JAX package routes them out of
bounds and relies on ``mode="drop"``.  In torch a negative index wraps and
an out-of-bounds one raises, so every such write here goes through a count
of touches per slot (``index_add_`` of 0/1, harmless for -1 rows mapped to
slot 0) or through row ranges the host already knows.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.cosine_topk import ops as cosine_ops

from . import index as index_lib
from . import router as router_lib

POLICIES = ("fifo", "lru", "lfu")
INDEXES = ("flat", "ivf")
INT32_MAX = 2 ** 31 - 1


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    capacity: int = 4096
    dim: int = 384
    max_query_tokens: int = 64
    max_response_tokens: int = 256
    policy: str = "fifo"
    topk: int = 4
    block_n: int = 1024       # bank rows one lookup-kernel block scans
    # clustered (IVF) index, DESIGN.md §7; 0 = resolved from the capacity
    # (index.resolve): nclusters ~ capacity/128 within [64, 2048], bucket
    # ceil(capacity/nclusters) with 2x slack
    index: str = "flat"       # flat | ivf
    nclusters: int = 0
    nprobe: int = 8
    ivf_bucket: int = 0
    reindex_every: int = 0    # writes between k-means rebuilds (0 = auto)
    kmeans_iters: int = 10

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(f"policy {self.policy!r} not in {POLICIES}")
        if self.index not in INDEXES:
            raise ValueError(f"index {self.index!r} not in {INDEXES}")


def init_cache(cfg: CacheConfig, device):
    c = cfg.capacity
    z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)
    state = {
        "emb": z((c, cfg.dim), torch.float32),
        "q_tokens": z((c, cfg.max_query_tokens), torch.int32),
        "q_mask": z((c, cfg.max_query_tokens), torch.float32),
        "r_tokens": z((c, cfg.max_response_tokens), torch.int32),
        "r_mask": z((c, cfg.max_response_tokens), torch.float32),
        "valid": z((c,), torch.bool),
        "ptr": z((), torch.int32),          # ring pointer (fifo)
        "last_used": z((c,), torch.int32),  # lru clock
        "hits": z((c,), torch.int32),       # lfu counter
        "clock": z((), torch.int32),
        "size": z((), torch.int32),
    }
    if cfg.index == "ivf":
        state.update(index_lib.init_ivf(cfg, device))
        state.update(init_admission(cfg, device))
    return state


def init_admission(cfg: CacheConfig, device):
    """Per-cluster admission state, optimistic: every cluster admits until
    ``admit_min`` observations say otherwise."""
    n = index_lib.resolve(cfg).nclusters
    return {"adm_ema": torch.ones((n,), dtype=torch.float32, device=device),
            "adm_count": torch.zeros((n,), dtype=torch.int32, device=device)}


def _normalize(embs):
    return embs / torch.clamp(torch.linalg.norm(embs, dim=-1, keepdim=True), min=1e-8)


def _write_rows(state, slots, rows, embs, q_tokens, q_mask, r_tokens, r_mask, stamps):
    """Write ``rows`` of the batch into ``slots`` (device int64 (n,)) of every
    buffer; ``stamps`` (n,) are the rows' ``last_used`` values."""
    state["emb"].index_copy_(0, slots, embs[rows])
    state["q_tokens"].index_copy_(0, slots, q_tokens[rows].to(torch.int32))
    state["q_mask"].index_copy_(0, slots, q_mask[rows].to(torch.float32))
    state["r_tokens"].index_copy_(0, slots, r_tokens[rows].to(torch.int32))
    state["r_mask"].index_copy_(0, slots, r_mask[rows].to(torch.float32))
    state["valid"].index_fill_(0, slots, True)
    state["last_used"].index_copy_(0, slots, stamps.to(torch.int32))
    state["hits"].index_fill_(0, slots, 0)


def _victim_slot(state, cfg: CacheConfig):
    """The slot the next insert takes, a 0-d device tensor (no host sync):
    the ring pointer for FIFO, and for LRU/LFU once the bank is full the
    least recently / least often used valid slot (the first on ties)."""
    if cfg.policy == "fifo":
        return state["ptr"] % cfg.capacity
    score = state["last_used"] if cfg.policy == "lru" else state["hits"]
    evict = torch.argmin(torch.where(state["valid"], score, INT32_MAX))
    full = state["size"] >= cfg.capacity
    return torch.where(full, evict.to(torch.int32), state["ptr"] % cfg.capacity)


def insert_batch(state, cfg: CacheConfig, embs, q_tokens, q_mask, r_tokens, r_mask,
                 count=None):
    """Insert the first ``count`` rows of a padded batch; rows past ``count``
    are padding.  ``count`` is a host int (eager torch has no recompiles to
    bound).  Returns ``(state, slots)``: slots (B,) int32, -1 for padding.

    FIFO lands row i at ring slot ``(ptr + i) % capacity``; when the batch
    laps the ring the later row wins, so only rows ``[count - capacity,
    count)`` are written, and only they are filed in an IVF table.  LRU/LFU
    pick each victim after the previous insert, one row at a time, on the
    device, and file it right after.
    """
    b = embs.shape[0]
    count = min(b if count is None else int(count), b)
    dev = embs.device
    embs = _normalize(embs.to(torch.float32))
    row = torch.arange(b, dtype=torch.int32, device=dev)
    if cfg.policy == "fifo":
        slots = (state["ptr"] + row) % cfg.capacity
        lo = max(0, count - cfg.capacity)
        if count > lo:
            rows = slice(lo, count)
            _write_rows(state, slots[rows].long(), rows, embs, q_tokens, q_mask,
                        r_tokens, r_mask, state["clock"] + row[rows])
        state["ptr"] += count
        state["clock"] += count
        state["size"].copy_(torch.clamp(state["size"] + count, max=cfg.capacity))
        if cfg.index == "ivf" and count > lo:
            index_lib.update_batch(state, cfg, embs[lo:count], slots[lo:count])
        return state, torch.where(row < count, slots, -1).to(torch.int32)
    slots = torch.full((b,), -1, dtype=torch.int32, device=dev)
    if cfg.index == "ivf":
        # nearest clusters in one product; only the filing is sequential
        cn = index_lib.nearest_clusters(state["ivf_centroids"], embs)
    for i in range(count):
        slot = _victim_slot(state, cfg)
        _write_rows(state, slot.long().view(1), slice(i, i + 1), embs, q_tokens,
                    q_mask, r_tokens, r_mask, state["clock"].view(1))
        slots[i] = slot
        state["ptr"] += 1
        state["clock"] += 1
        state["size"].copy_(torch.clamp(state["size"] + 1, max=cfg.capacity))
        if cfg.index == "ivf":
            index_lib.file_row(state, cn[i:i + 1], slot.view(1))
    return state, slots


def insert(state, cfg: CacheConfig, emb, q_tokens, q_mask, r_tokens, r_mask):
    """Insert ONE entry (emb (D,), token rows already padded to the config's
    lengths) at ``_victim_slot``, in place: ``insert_batch`` of that one row."""
    one = lambda t: t.reshape(1, *t.shape)
    state, _ = insert_batch(state, cfg, one(emb), one(q_tokens), one(q_mask), one(r_tokens),
                            one(r_mask), 1)
    return state


def lookup(state, cfg: CacheConfig, q_embs):
    """q_embs (B,D) unit vectors -> (scores (B,k), indices (B,k)): the flat
    scan, or the IVF probe of the ``nprobe`` nearest clusters (the flat
    scan's scores at ``nprobe == nclusters``)."""
    if cfg.index == "ivf":
        return index_lib.lookup(state, cfg, q_embs)
    k = min(cfg.topk, cfg.capacity)
    return cosine_ops.cosine_topk(q_embs.contiguous(), state["emb"], state["valid"],
                                  k=k, block_n=min(cfg.block_n, cfg.capacity))


def _parts(state):
    """``(part, its first global slot)`` of a state's rows: the state itself
    at 0, or each shard of a row-sharded state (``core/distributed.py``)."""
    shards = state.get("shards")
    if shards is None:
        return [(state, 0)]
    local_c = shards[0]["valid"].shape[0]
    return [(sh, j * local_c) for j, sh in enumerate(shards)]


def gather_rows(state, key: str, idx):
    """``state[key][idx]`` of a local or row-sharded state, on ``idx``'s
    device; ``idx`` (...) int64 global slots in [0, capacity).  A sharded
    state reads each slot from the shard that owns it."""
    if "shards" not in state:
        return state[key][idx]
    out = None
    for part, base in _parts(state):
        t = part[key]
        mine = (idx >= base) & (idx < base + t.shape[0])
        v = t[torch.where(mine, idx - base, 0).to(t.device)].to(idx.device)
        if out is None:
            out = v
        else:
            out = torch.where(mine.reshape(mine.shape + (1,) * (v.dim() - mine.dim())), v, out)
    return out


def _touch_rows(state, cfg: CacheConfig, indices, hit):
    """Record a hit on ``indices[hit]``: last_used <- clock, hits += 1;
    rows with ``hit`` False (or index -1) touch nothing.  The clock ticks.
    On a row-sharded state each touch lands on the shard owning its slot."""
    for part, base in _parts(state):
        local_c = part["hits"].shape[0]
        mine = hit & (indices >= base) & (indices < base + local_c)
        w = torch.where(mine, indices - base, 0).long()
        n = torch.zeros(local_c, dtype=torch.int32, device=indices.device)
        n.index_add_(0, w, mine.to(torch.int32))
        n = n.to(part["hits"].device)
        part["hits"] += n
        part["last_used"].copy_(torch.where(n > 0, state["clock"].to(n.device),
                                            part["last_used"]))
    state["clock"] += 1
    return state


def touch(state, cfg: CacheConfig, indices):
    """Record hits for LRU/LFU accounting.  indices (B,) top-1 hits; -1 is a
    no-op (an unguarded scatter at -1 would touch the last slot)."""
    return _touch_rows(state, cfg, indices, indices >= 0)


def lookup_and_touch(state, cfg: CacheConfig, router_cfg, q_embs):
    """Fused lookup + routing + hit accounting.
    Returns ``(state, scores (B,k), indices (B,k), decisions (B,))``."""
    scores, idx = lookup(state, cfg, q_embs)
    decisions = router_lib.route(scores[:, 0], router_cfg)
    top1 = idx[:, 0]
    _touch_rows(state, cfg, top1, (decisions != router_lib.MISS) & (top1 >= 0))
    return state, scores, idx, decisions


def route_touch_core(state, cfg: CacheConfig, router_cfg, q_embs, scores, idx, cost):
    """Route the top-k at per-row operating points and touch committed hits.
    Returns ``(state, decisions, tau, cluster, admit)``.  An IVF cache reads
    each query's cluster and its admission flag (from the statistics before
    this batch) and folds the batch's certain outcomes into the cluster hit
    EMA; a flat cache has no clusters (-1) and admits every row."""
    tau = router_lib.threshold_for(cost, router_cfg)
    decisions = router_lib.route_cascade(scores[:, 0], tau, router_cfg)
    top1 = idx[:, 0]
    hit = ((decisions == router_lib.TWEAK) | (decisions == router_lib.EXACT)) & (top1 >= 0)
    _touch_rows(state, cfg, top1, hit)
    b = scores.shape[0]
    if cfg.index == "ivf":
        # a cold index (zero centroids) puts every query in cluster 0:
        # harmless, the EMA starts optimistic
        cluster = index_lib.nearest_clusters(state["ivf_centroids"], q_embs)
        admit = router_lib.admission_admit(state["adm_ema"], state["adm_count"], cluster,
                                           router_cfg)
        # UNCERTAIN rows are observed by stage 2
        ema, cnt = router_lib.admission_update(
            state["adm_ema"], state["adm_count"], cluster, hit,
            decisions != router_lib.UNCERTAIN, router_cfg)
        state["adm_ema"].copy_(ema)
        state["adm_count"].copy_(cnt)
    else:
        cluster = torch.full((b,), -1, dtype=torch.int32, device=scores.device)
        admit = torch.ones((b,), dtype=torch.bool, device=scores.device)
    return state, decisions, tau, cluster, admit


def lookup_route_touch(state, cfg: CacheConfig, router_cfg, q_embs, cost):
    """Fused stage 1: lookup, route at per-row costs, touch.
    Returns ``(state, scores, indices, decisions, tau, cluster, admit)``."""
    scores, idx = lookup(state, cfg, q_embs)
    state, decisions, tau, cluster, admit = route_touch_core(
        state, cfg, router_cfg, q_embs, scores, idx, cost)
    return state, scores, idx, decisions, tau, cluster, admit


def make_second_stage(cfg: CacheConfig, router_cfg, rr_params, rr_cfg):
    """The stage-2 resolver of UNCERTAIN rows:

    ``(state, q_tokens, q_mask, scores, idx, decisions, tau, cluster) ->
    (state, final decisions (B,), slot (B,), conf (B,))``

    It gathers the shortlist candidates' cached query tokens (a dead
    candidate's mask zeroed), scores them against the live query with the
    reranker, and ``router.stage2_combine`` commits TWEAK or MISS.  A
    committed row serves the blended-evidence pick, not necessarily the
    top-1; other rows keep their stage-1 decision and top-1 slot.  Committed
    rows are touched here (stage 1 skipped them; the clock ticks once more),
    and an IVF bank folds the uncertain rows' outcomes into the admission
    EMA.  The state is updated in place.  A row-sharded state works the
    same: the token gather and the touch go to the shards owning the slots.
    """
    from repro_torch.models.reranker import score_shortlist

    def second_stage(state, q_tokens, q_mask, scores, idx, decisions, tau, cluster):
        live = idx >= 0
        safe = idx.clamp(0, cfg.capacity - 1).long()
        cand_t = gather_rows(state, "q_tokens", safe)                 # (B,K,S)
        cand_m = gather_rows(state, "q_mask", safe) * live[..., None].to(torch.float32)
        rr = score_shortlist(rr_params, q_tokens, q_mask, cand_t, cand_m, rr_cfg)
        commit, best, conf = router_lib.stage2_combine(scores, rr, live, tau, router_cfg)
        unc = decisions == router_lib.UNCERTAIN
        final = torch.where(unc, torch.where(commit, router_lib.TWEAK, router_lib.MISS),
                            decisions).to(torch.int32)
        chosen = idx.gather(1, best[:, None].long())[:, 0]
        slot = torch.where(unc & commit, chosen, idx[:, 0])
        _touch_rows(state, cfg, slot, unc & commit & (slot >= 0))
        if cfg.index == "ivf":
            ema, cnt = router_lib.admission_update(state["adm_ema"], state["adm_count"],
                                                   cluster, commit, unc, router_cfg)
            state["adm_ema"].copy_(ema)
            state["adm_count"].copy_(cnt)
        return state, final, slot, conf

    return second_stage
