"""Clustered (IVF) index over the cache bank (counterpart of
``src/repro/core/index.py``, DESIGN.md §7).

The flat lookup scans every row; the IVF lookup scores only the members of
the ``nprobe`` clusters whose centroids are closest to the query:

* **Centroids** (nclusters, D): spherical k-means over the bank, trained on
  the host in :func:`build_index` (the maintenance path).
* **Member table** (nclusters, bucket): a padded list of the bank rows filed
  under each cluster, so a probe has a fixed shape.
* **Back-pointers** ``ivf_assign``/``ivf_pos`` (capacity,): the cluster and
  table position each slot is filed under now.  Member lists only grow
  between rebuilds; an overwritten slot's old entry goes stale, and an entry
  (c, p) = s is live iff ``valid[s] & assign[s] == c & pos[s] == p``.  Every
  valid slot has exactly one live entry, so a lookup at ``nprobe ==
  nclusters`` gives the flat scan's scores.
* **Rebalance**: a row goes to its nearest centroid's list, or to the least
  loaded cluster when that list is full; when that one is full too, the
  row overwrites its last entry and raises ``ivf_overflow``, which with the
  ``ivf_pending`` write count tells :func:`maybe_reindex` to rebuild.

The state lives in the cache dict and is updated in place, as the rest of
the port's cache is.  The JAX package files padding rows too and drops
their writes (``mode="drop"``); here the host knows which rows were written
(``count``, the FIFO rows a lapping batch keeps), files only those, and no
index leaves its tensor.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.cosine_topk import ops as cosine_ops

IVF_KEYS = ("ivf_centroids", "ivf_members", "ivf_count", "ivf_assign",
            "ivf_pos", "ivf_pending", "ivf_overflow")

# member-table slack: total member slots = SLACK * capacity, so the least
# loaded fallback has space until churn piles up that many stale entries
# (a rebuild fires long before); every unit is paid on every probe
SLACK = 2
# rows per matmul of the k-means assignment and the rebuild's filing
CHUNK = 8192


@dataclasses.dataclass(frozen=True)
class IVFParams:
    nclusters: int
    bucket: int
    nprobe: int
    reindex_every: int


def resolve(cfg) -> IVFParams:
    """The auto (0) knobs of a CacheConfig as table shapes.  ``bucket`` is
    at least ``ceil(capacity / nclusters)`` and topk, so the table can hold
    every valid slot; auto ``nclusters`` is capacity/128 within [64, 2048]."""
    nclusters = cfg.nclusters or min(max(64, cfg.capacity // 128), 2048)
    nclusters = min(nclusters, cfg.capacity)
    bucket = cfg.ivf_bucket or -(-cfg.capacity // nclusters) * SLACK
    bucket = max(bucket, -(-cfg.capacity // nclusters), min(cfg.topk, cfg.capacity))
    bucket = min(bucket, cfg.capacity)
    nprobe = min(cfg.nprobe or 8, nclusters)
    reindex_every = cfg.reindex_every or max(64, cfg.capacity // 4)
    return IVFParams(nclusters, bucket, nprobe, reindex_every)


def init_ivf(cfg, device):
    p = resolve(cfg)
    full = lambda shape, v: torch.full(shape, v, dtype=torch.int32, device=device)
    return {
        "ivf_centroids": torch.zeros((p.nclusters, cfg.dim), dtype=torch.float32,
                                     device=device),
        "ivf_members": full((p.nclusters, p.bucket), -1),
        "ivf_count": full((p.nclusters,), 0),
        "ivf_assign": full((cfg.capacity,), -1),
        "ivf_pos": full((cfg.capacity,), -1),
        "ivf_pending": full((), 0),
        "ivf_overflow": torch.zeros((), dtype=torch.bool, device=device),
    }


# ---------------------------------------------------------------- insert

def nearest_clusters(centroids, embs):
    """(B,) int32 nearest centroid per row (the first on ties: a cold
    index's zero centroids send every row to cluster 0)."""
    return torch.argmax(embs.float() @ centroids.T, dim=1).to(torch.int32)


def file_row(state, c_near, slot):
    """File one written row under its precomputed nearest cluster, in place
    (``c_near`` and ``slot`` are (1,) int device tensors).  A full nearest
    list sends the row to the least-loaded cluster (the first on ties); if
    that one is full too, the row overwrites its last entry and raises
    ``ivf_overflow``."""
    members, count = state["ivf_members"], state["ivf_count"]
    bucket = members.shape[1]
    c_near = c_near.long()
    full = count.index_select(0, c_near) >= bucket
    c = torch.where(full, torch.argmin(count).view(1), c_near)
    cnt = count.index_select(0, c)
    ovf = cnt >= bucket
    p = torch.clamp(cnt, max=bucket - 1).long()
    s = slot.long()
    members.index_put_((c, p), slot.to(torch.int32))
    count.index_add_(0, c, (~ovf).to(torch.int32))
    state["ivf_assign"].index_put_((s,), c.to(torch.int32))
    state["ivf_pos"].index_put_((s,), p.to(torch.int32))
    state["ivf_pending"] += 1
    state["ivf_overflow"] |= ovf[0]
    return state


def update_batch(state, cfg, embs, slots):
    """File rows just written at ``slots`` (B,) device int.  Filing is
    sequential (two rows of one cluster take consecutive positions): one
    loop over the rows, device ops only; the nearest clusters come from one
    (B, nclusters) product.  ``embs`` must be unit vectors."""
    cn = nearest_clusters(state["ivf_centroids"], embs)
    for i in range(embs.shape[0]):
        file_row(state, cn[i:i + 1], slots[i:i + 1])
    return state


# ---------------------------------------------------------------- lookup

def probe_clusters(centroids, q_embs, nprobe: int):
    """(B, nprobe) clusters with the closest centroids, ties to the lowest id
    (``lax.top_k``'s rule; ``torch.topk`` promises no order on ties)."""
    csims = q_embs.float() @ centroids.T
    return torch.sort(csims, dim=1, descending=True, stable=True)[1][:, :nprobe]


def _entry_live(entries, cnt, cid, valid, assign, slot_pos):
    """Live mask of member-table rows ``entries`` (..., bucket) of clusters
    ``cid`` (...) that hold ``cnt`` (...) entries: (c, p) = s is live iff
    s >= 0, p < count[c], valid[s], assign[s] == c and pos[s] == p."""
    pcol = torch.arange(entries.shape[-1], dtype=torch.int32, device=entries.device)
    s = entries.clamp(min=0).long()
    return ((entries >= 0) & (pcol < cnt[..., None]) & valid[s]
            & (assign[s] == cid[..., None]) & (slot_pos[s] == pcol))


def live_entries_per_slot(state):
    """Live member entries of each bank slot: exactly 1 for every valid slot
    (what makes a full probe equal the flat scan), 0 elsewhere.  An overflow
    may break it until the next rebuild."""
    members = state["ivf_members"]
    cid = torch.arange(members.shape[0], device=members.device)
    live = _entry_live(members, state["ivf_count"], cid, state["valid"], state["ivf_assign"],
                       state["ivf_pos"])
    return torch.bincount(members[live].long(), minlength=state["valid"].numel())


def shortlist(members, count, valid, assign, slot_pos, probe):
    """The padded member shortlist of the probed clusters ``probe`` (B,
    nprobe): (cand_idx (B, nprobe*bucket) int32 bank rows, live (B, M))."""
    cand = members[probe]                                       # (B, np, bucket)
    live = _entry_live(cand, count[probe], probe, valid, assign, slot_pos)
    b = probe.shape[0]
    return cand.reshape(b, -1), live.reshape(b, -1)


def candidates(members, count, valid, assign, slot_pos, centroids, q_embs, nprobe: int):
    """Two-stage probe: centroid route -> padded member shortlist.
    Returns (cand_idx (B, nprobe*bucket) int32 bank rows, live (B, M) bool)."""
    return shortlist(members, count, valid, assign, slot_pos,
                     probe_clusters(centroids, q_embs, nprobe))


def lookup(state, cfg, q_embs):
    """IVF lookup: (scores (B, k), indices (B, k)) like the flat scan; at
    ``nprobe == nclusters`` it gives the flat scan's scores."""
    p = resolve(cfg)
    cand, live = candidates(state["ivf_members"], state["ivf_count"], state["valid"],
                            state["ivf_assign"], state["ivf_pos"], state["ivf_centroids"],
                            q_embs, p.nprobe)
    k = min(cfg.topk, cfg.capacity)
    return cosine_ops.cosine_topk_gather(q_embs.contiguous(), state["emb"], cand, live, k=k)


# ------------------------------------------------------------- rebuild

def _spherical_kmeans(x: np.ndarray, k: int, iters: int, rng: np.random.Generator,
                      device) -> np.ndarray:
    """Lloyd iterations with cosine assignment (rows of x unit-norm).  The
    (n, k) assignment product runs on ``device``; the centroid updates stay
    in numpy, as the JAX package has them.  Empty clusters reseed to a
    random training row."""
    n = x.shape[0]
    init = rng.choice(n, size=k, replace=n < k)
    cent = x[init].copy()
    xd = torch.from_numpy(x).to(device)
    for _ in range(iters):
        cd = torch.from_numpy(cent).to(device)
        a = np.concatenate([torch.argmax(xd[i:i + CHUNK] @ cd.T, dim=1).cpu().numpy()
                            for i in range(0, n, CHUNK)])
        sums = np.zeros_like(cent)
        np.add.at(sums, a, x)
        counts = np.bincount(a, minlength=k)
        empty = counts == 0
        norms = np.linalg.norm(sums, axis=1, keepdims=True)
        cent = np.where(empty[:, None], x[rng.choice(n, size=k)],
                        sums / np.maximum(norms, 1e-8))
    return cent.astype(np.float32)


def build_index(state, cfg, seed: int = 0, sample: int = 65536):
    """Host-side recluster: fresh k-means and a compact member table, in place.

    k-means trains on at most ``sample`` valid rows; every valid row is then
    filed under its nearest centroid, and clusters past ``bucket`` spill
    their farthest members to the nearest cluster with space, so no valid
    row is dropped.  The per-cluster admission statistics restart
    optimistic: a recluster renames every cluster.
    """
    p = resolve(cfg)
    dev = state["emb"].device
    emb = state["emb"].cpu().numpy()
    rows = np.nonzero(state["valid"].cpu().numpy())[0]
    for key, val in init_ivf(cfg, dev).items():
        state[key].copy_(val)
    if "adm_ema" in state:
        state["adm_ema"].fill_(1.0)
        state["adm_count"].zero_()
    if len(rows) == 0:
        return state
    rng = np.random.default_rng(seed)
    train = emb[rng.choice(rows, size=min(len(rows), sample), replace=False)]
    cent = _spherical_kmeans(train, p.nclusters, cfg.kmeans_iters, rng, dev)
    cd = torch.from_numpy(cent).to(dev)

    assign = np.full((cfg.capacity,), -1, np.int64)
    best_sim = np.zeros((cfg.capacity,), np.float32)
    for i in range(0, len(rows), CHUNK):
        chunk = rows[i:i + CHUNK]
        s = state["emb"][torch.from_numpy(chunk).to(dev)] @ cd.T
        arg = torch.argmax(s, dim=1)
        assign[chunk] = arg.cpu().numpy()
        best_sim[chunk] = s.gather(1, arg[:, None])[:, 0].cpu().numpy()

    counts = np.bincount(assign[rows], minlength=p.nclusters)
    for c in np.nonzero(counts > p.bucket)[0]:
        mem = rows[assign[rows] == c]
        spill = mem[np.argsort(best_sim[mem])[:len(mem) - p.bucket]]
        sims = (state["emb"][torch.from_numpy(spill).to(dev)] @ cd.T).cpu().numpy()
        for r, s in zip(spill, sims):
            s = np.where(counts < p.bucket, s, -np.inf)
            tgt = int(s.argmax())
            assign[r] = tgt
            counts[tgt] += 1
            counts[c] -= 1

    # stable sort of rows by cluster; positions are ranks within each run
    order = rows[np.argsort(assign[rows], kind="stable")]
    sorted_c = assign[order]
    starts = np.searchsorted(sorted_c, np.arange(p.nclusters))
    posn = (np.arange(len(order)) - starts[sorted_c]).astype(np.int32)
    members = np.full((p.nclusters, p.bucket), -1, np.int32)
    count = np.bincount(sorted_c, minlength=p.nclusters).astype(np.int32)
    slot_pos = np.full((cfg.capacity,), -1, np.int32)
    members[sorted_c, posn] = order
    slot_pos[order] = posn

    state["ivf_centroids"].copy_(cd)
    for key, val in (("ivf_members", members), ("ivf_count", count),
                     ("ivf_assign", assign.astype(np.int32)), ("ivf_pos", slot_pos)):
        state[key].copy_(torch.from_numpy(val))
    return state


def maybe_reindex(state, cfg, seed: int = 0):
    """Rebuild when stale entries pile up or the table overflowed.  Returns
    (state, rebuilt); one host read of the two scalars, none for a flat
    cache."""
    if cfg.index != "ivf":
        return state, False
    flags = torch.stack([state["ivf_overflow"].to(torch.int32), state["ivf_pending"]])
    overflow, pending = flags.cpu().tolist()
    if overflow or pending >= resolve(cfg).reindex_every:
        return build_index(state, cfg, seed=seed), True
    return state, False
