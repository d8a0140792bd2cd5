"""A row-sharded semantic cache (counterpart of ``src/repro/core/distributed.py``).

The bank's rows are split over the devices of a cache mesh
(``launch/mesh.py::make_cache_mesh``): shard ``j`` on ``mesh[j]`` owns global
slots ``[j * local_c, (j + 1) * local_c)``.  One process drives every shard,
as the reference's single controller does through ``shard_map``.

A sharded state is a dict of the replicated entries (ring pointer, clock,
size, and for an IVF bank the centroids, ``ivf_pending``, ``ivf_overflow``
and the admission statistics), on ``mesh[0]``, plus ``"shards"``: one dict
per shard of its rows (``ROW_KEYS``) and, for an IVF bank, its own member
table ``(nclusters, bucket)`` of LOCAL slot ids with its counts, so a probe
never leaves its shard.  ``"ring"`` mirrors the FIFO ring pointer on the
host: sharded inserts are FIFO only, so the host knows where every row of a
batch lands and each shard writes exactly its own rows, with no host sync
and no dropped writes (the reference drops out-of-shard writes with
``mode="drop"``, which torch's scatters lack).

Lookups run the port's kernels once per shard on its own rows
(``cosine_topk``, or ``cosine_topk_gather`` on the shard's shortlist), then
merge the (B, k) winners: a stable sort over the shard-major concatenation,
so ties go to the lowest global index as the local kernels break them, and
empty slots (-inf, -1) sort last.  Routing, the touch and the admission EMA
are then the local ``cache.route_touch_core`` on the merged winners; the
touch lands on the shard owning each slot.  There is no host sync between
the per-shard launches.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.cosine_topk import ops as cosine_ops

from . import cache as cache_lib
from . import index as index_lib

# per-shard arrays of the bank rows, sliced by global slot
ROW_KEYS = ("emb", "q_tokens", "q_mask", "r_tokens", "r_mask", "valid", "last_used",
            "hits", "ivf_assign", "ivf_pos")
# per-shard IVF member tables (nclusters, bucket) of local slot ids and counts
TABLE_KEYS = ("ivf_members", "ivf_count")


def _local_capacity(capacity: int, n_shards: int) -> int:
    if capacity % n_shards:
        raise ValueError(f"capacity {capacity} does not split into {n_shards} shards")
    return capacity // n_shards


def _split(state, mesh, skip=()):
    """Copy ``state`` into the sharded layout: rows sliced to the shards,
    everything else replicated on ``mesh[0]``."""
    n = len(mesh)
    local_c = state["valid"].shape[0] // n
    shards = [{k: state[k][j * local_c:(j + 1) * local_c].to(dev, copy=True)
               for k in ROW_KEYS if k in state} for j, dev in enumerate(mesh)]
    out = {k: v.to(mesh[0], copy=True) for k, v in state.items()
           if k not in ROW_KEYS and k not in skip}
    out["shards"] = shards
    # hostsync: ok the ring-pointer mirror, read once at sharding set-up
    out["ring"] = int(state["ptr"])
    return out


def shard_cache_state(state, mesh):
    """A local flat cache state split over ``mesh`` (a copy; the input is
    left as it was).  IVF states go through :func:`shard_ivf_cache_state`:
    their member table needs a regroup, not just a split."""
    if "ivf_members" in state:
        raise ValueError("an IVF cache state is sharded by shard_ivf_cache_state")
    _local_capacity(state["valid"].shape[0], len(mesh))
    return _split(state, mesh)


def _regroup(valid, assign, n_shards: int, local_c: int, nclusters: int, bucket: int):
    """Member tables rebuilt from ``(valid, assign)`` host arrays, rows filed
    in slot order: shard ``r // local_c``'s table row ``assign[r]`` gets the
    local id ``r % local_c``.  Returns ``(members (n * nclusters, bucket),
    count (n * nclusters,), pos (capacity,), fits)``; ``fits`` is False when
    a table row would need more than ``bucket`` entries (those are left out)."""
    rows = np.flatnonzero(valid & (assign >= 0))
    key = (rows // local_c) * nclusters + assign[rows]
    order = np.argsort(key, kind="stable")
    rows, key = rows[order], key[order]
    posn = np.arange(len(rows)) - np.searchsorted(key, np.arange(n_shards * nclusters))[key]
    keep = posn < bucket
    members = np.full((n_shards * nclusters, bucket), -1, np.int32)
    members[key[keep], posn[keep]] = rows[keep] % local_c
    count = np.minimum(np.bincount(key, minlength=n_shards * nclusters), bucket)
    pos = np.full(valid.shape, -1, np.int32)
    pos[rows[keep]] = posn[keep]
    return members, count.astype(np.int32), pos, bool(keep.all())  # hostsync: ok host numpy array


def shard_ivf_cache_state(state, mesh, cfg):  # hostsync: ok set-up regroup on the host
    """A local IVF cache state split over ``mesh``: each shard's member table
    is rebuilt from ``(valid, assign)`` restricted to its rows, with LOCAL
    slot ids; centroids and the pending/overflow scalars replicate.  A host
    regroup (one read of the state), run at set-up and after a rebuild.  An
    overflowed table raises: it can hold more valid rows per cluster than a
    table row takes, so run ``index.build_index`` first."""
    n = len(mesh)
    local_c = _local_capacity(cfg.capacity, n)
    if bool(state["ivf_overflow"]):
        raise ValueError("IVF member table overflowed; run index.build_index(state, cfg) "
                         "before sharding")
    p = index_lib.resolve(cfg)
    members, count, pos, fits = _regroup(state["valid"].cpu().numpy(),
                                         state["ivf_assign"].cpu().numpy(), n, local_c,
                                         p.nclusters, p.bucket)
    if not fits:
        raise ValueError("a shard's member-table row overflows despite the table slack")
    out = _split(dict(state, ivf_pos=torch.from_numpy(pos)), mesh, skip=TABLE_KEYS)
    for j, (sh, dev) in enumerate(zip(out["shards"], mesh)):
        sh["ivf_members"] = torch.from_numpy(
            members[j * p.nclusters:(j + 1) * p.nclusters]).to(dev)
        sh["ivf_count"] = torch.from_numpy(count[j * p.nclusters:(j + 1) * p.nclusters]).to(dev)
    return out


def gather_cache_state(state, cfg, device=None):  # hostsync: ok a host copy of the bank
    """The local-layout state of a sharded one (a copy, on ``device`` or
    ``mesh[0]``): rows concatenated in slot order.  An IVF bank's member
    table is rebuilt from ``(valid, assign)`` in slot order, the layout
    :func:`shard_ivf_cache_state` inverts; if a cluster holds more rows than
    one table row takes, the extra rows are left out and ``ivf_overflow`` is
    raised, which tells the next ``maybe_reindex`` to rebuild."""
    home = torch.device(device) if device is not None else state["ptr"].device
    shards = state["shards"]
    out = {k: v.to(home, copy=True) for k, v in state.items() if k not in ("shards", "ring")}
    for k in ROW_KEYS:
        if k in shards[0]:
            out[k] = torch.cat([sh[k].to(home) for sh in shards])
    if "ivf_assign" in out:
        p = index_lib.resolve(cfg)
        members, count, pos, fits = _regroup(out["valid"].cpu().numpy(),
                                             out["ivf_assign"].cpu().numpy(), 1,
                                             cfg.capacity, p.nclusters, p.bucket)
        for k, v in (("ivf_members", members), ("ivf_count", count), ("ivf_pos", pos)):
            out[k] = torch.from_numpy(v).to(home)
        out["ivf_overflow"] |= not fits
    return out


# ---------------------------------------------------------------- lookup

def merge_shard_topk(parts, k: int, device):
    """Merge per-shard ``(scores (B, k_j), global idx (B, k_j))`` winners into
    a global top-k on ``device``: a stable descending sort over the
    shard-major concatenation, so ties go to the lowest global index and
    empty slots (-inf, -1) come last."""
    s = torch.cat([ps.to(device) for ps, _ in parts], dim=1)
    i = torch.cat([pi.to(device) for _, pi in parts], dim=1)
    top_s, sel = torch.sort(s, dim=1, descending=True, stable=True)
    top_s = top_s[:, :k]
    top_i = i.gather(1, sel[:, :k])
    return top_s, torch.where(torch.isfinite(top_s), top_i, -1).to(torch.int32)


def lookup(state, cfg, q_embs):
    """The sharded lookup: ``(scores (B, k), indices (B, k))`` on the queries'
    device, equal to the local lookup of the same rows.  Each shard runs the
    flat scan, or for an IVF bank the probe of the ``nprobe`` clusters
    nearest the query (chosen once from the replicated centroids) over its
    own member table, on its own rows."""
    shards = state["shards"]
    local_c = _local_capacity(cfg.capacity, len(shards))
    k = min(cfg.topk, cfg.capacity)
    kl = min(k, local_c)
    q = q_embs.contiguous()
    probe = None
    if cfg.index == "ivf":
        probe = index_lib.probe_clusters(state["ivf_centroids"], q,
                                         index_lib.resolve(cfg).nprobe)
    parts = []
    for j, sh in enumerate(shards):
        dev = sh["emb"].device
        qj = q.to(dev)
        if probe is None:
            s, i = cosine_ops.cosine_topk(qj, sh["emb"], sh["valid"], k=kl,
                                          block_n=min(cfg.block_n, local_c))
        else:
            cand, live = index_lib.shortlist(sh["ivf_members"], sh["ivf_count"], sh["valid"],
                                             sh["ivf_assign"], sh["ivf_pos"], probe.to(dev))
            s, i = cosine_ops.cosine_topk_gather(qj, sh["emb"], cand, live, k=kl)
        gi = torch.where(i >= 0, i + j * local_c, -1)
        if kl < k:
            s = F.pad(s, (0, k - kl), value=-torch.inf)
            gi = F.pad(gi, (0, k - kl), value=-1)
        parts.append((s, gi))
    return merge_shard_topk(parts, k, q_embs.device)


def lookup_route_touch(state, cfg, router_cfg, q_embs, cost):
    """Sharded ``cache.lookup_route_touch``: the merged winners go through the
    same ``route_touch_core`` as a local bank's, so routing, the touch and
    the admission EMA see only the global shortlist.  Returns ``(state,
    scores, indices, decisions, tau, cluster, admit)``."""
    scores, idx = lookup(state, cfg, q_embs)
    state, decisions, tau, cluster, admit = cache_lib.route_touch_core(
        state, cfg, router_cfg, q_embs, scores, idx, cost)
    return state, scores, idx, decisions, tau, cluster, admit


def make_distributed_lookup_and_touch(mesh, cfg, router_cfg):
    """``(state, q_embs, cost) -> (state, scores, idx, decisions, tau,
    cluster, admit)`` over a state sharded on ``mesh``."""
    _local_capacity(cfg.capacity, len(mesh))
    return lambda state, q_embs, cost: lookup_route_touch(state, cfg, router_cfg, q_embs,
                                                          cost)


# ---------------------------------------------------------------- insert

def insert_batch(state, cfg, embs, q_tokens, q_mask, r_tokens, r_mask, count=None):
    """Sharded FIFO ``cache.insert_batch``, in place: row i of the first
    ``count`` lands at global slot ``(ptr + i) % capacity`` and only the
    shard owning that slot writes it (when the batch laps the ring only the
    last ``capacity`` rows are written, as locally).  An IVF bank files each
    shard's rows in that shard's member table; ``ivf_pending`` counts every
    written row and ``ivf_overflow`` is the OR over shards.  Returns
    ``(state, slots (B,) int32)``, -1 for padding."""
    if cfg.policy != "fifo":
        raise ValueError("a sharded insert_batch is FIFO only")
    shards = state["shards"]
    local_c = _local_capacity(cfg.capacity, len(shards))
    b = embs.shape[0]
    count = min(b if count is None else int(count), b)  # hostsync: ok count is a host int
    home = embs.device
    embs = cache_lib._normalize(embs.to(torch.float32))
    ptr = state["ring"]
    row = np.arange(b)
    gslot = (ptr + row) % cfg.capacity
    lo = max(0, count - cfg.capacity)
    for j, sh in enumerate(shards):
        mine = np.flatnonzero((row >= lo) & (row < count) & (gslot // local_c == j))
        if not mine.size:
            continue
        dev = sh["emb"].device
        r = torch.from_numpy(mine).to(home)
        ls = torch.from_numpy(gslot[mine] % local_c).to(dev)
        sel = lambda t: t[r].to(dev)
        cache_lib._write_rows(sh, ls, slice(None), sel(embs), sel(q_tokens), sel(q_mask),
                              sel(r_tokens), sel(r_mask), (state["clock"] + r).to(dev))
        if cfg.index == "ivf":
            tbl = {k: sh[k] for k in ("ivf_members", "ivf_count", "ivf_assign", "ivf_pos")}
            tbl.update(ivf_centroids=state["ivf_centroids"].to(dev),
                       ivf_pending=torch.zeros((), dtype=torch.int32, device=dev),
                       ivf_overflow=torch.zeros((), dtype=torch.bool, device=dev))
            index_lib.update_batch(tbl, cfg, sel(embs), ls)
            state["ivf_overflow"] |= tbl["ivf_overflow"].to(home)
    state["ptr"] += count
    state["clock"] += count
    state["size"].copy_(torch.clamp(state["size"] + count, max=cfg.capacity))
    state["ring"] = ptr + count
    if cfg.index == "ivf":
        state["ivf_pending"] += count - lo
    slots = np.where(row < count, gslot, -1).astype(np.int32)
    return state, torch.from_numpy(slots).to(home)


def make_distributed_insert_batch(mesh, cfg):
    """``(state, embs, q_tokens, q_mask, r_tokens, r_mask, count) -> (state,
    slots)`` over a state sharded on ``mesh``; FIFO only, as the reference
    asserts."""
    if cfg.policy != "fifo":
        raise ValueError("a sharded insert_batch is FIFO only")
    _local_capacity(cfg.capacity, len(mesh))
    return lambda state, *args: insert_batch(state, cfg, *args)


def insert(state, cfg, emb, q_tokens, q_mask, r_tokens, r_mask):
    """Sharded single-row ``cache.insert`` (emb (D,), token rows padded to the
    config's lengths), any policy, flat banks only.  FIFO is a batch of one;
    LRU/LFU pick the victim over every shard on the device (once the bank is
    full) and only its owner writes."""
    if cfg.index == "ivf":
        raise ValueError("a sharded single-row insert has no IVF filing; use insert_batch")
    one = lambda t: t.reshape(1, *t.shape)
    if cfg.policy == "fifo":
        return insert_batch(state, cfg, one(emb), one(q_tokens), one(q_mask),
                            one(r_tokens), one(r_mask), 1)[0]
    parts = cache_lib._parts(state)
    key = "last_used" if cfg.policy == "lru" else "hits"
    score = torch.cat([p[key].to(emb.device) for p, _ in parts])
    valid = torch.cat([p["valid"].to(emb.device) for p, _ in parts])
    evict = torch.argmin(torch.where(valid, score, cache_lib.INT32_MAX)).to(torch.int32)
    slot = torch.where(state["size"] >= cfg.capacity, evict, state["ptr"] % cfg.capacity)
    vals = {"emb": cache_lib._normalize(emb.to(torch.float32)), "q_tokens": q_tokens,
            "q_mask": q_mask, "r_tokens": r_tokens, "r_mask": r_mask,
            "valid": torch.ones((), dtype=torch.bool, device=emb.device),
            "last_used": state["clock"], "hits": torch.zeros_like(state["clock"])}
    for part, base in parts:
        dev = part["valid"].device
        mine = ((slot >= base) & (slot < base + part["valid"].shape[0])).to(dev)
        ls = torch.where(mine, slot.to(dev) - base, 0).long().view(1)
        for k, v in vals.items():
            t = part[k]
            t.index_copy_(0, ls, torch.where(mine, v.to(dev, t.dtype), t[ls[0]])[None])
    state["ptr"] += 1
    state["clock"] += 1
    state["size"].copy_(torch.clamp(state["size"] + 1, max=cfg.capacity))
    state["ring"] += 1
    return state


def make_distributed_insert(mesh, cfg):
    """``(state, emb, q_tokens, q_mask, r_tokens, r_mask) -> state`` over a
    state sharded on ``mesh``; IVF banks are rejected, as the reference
    asserts."""
    if cfg.index == "ivf":
        raise ValueError("a sharded single-row insert has no IVF filing; use "
                         "make_distributed_insert_batch")
    _local_capacity(cfg.capacity, len(mesh))
    return lambda state, *args: insert(state, cfg, *args)
