"""Plain PyTorch cosine top-k: the flat scan over the cache bank and the
shortlist scan of the IVF probe.

Scores by one product, dead rows to -inf, then an explicitly stable
descending sort (``torch.topk`` promises nothing about ties), so ties go to
the lowest index (flat) or the lowest candidate position (shortlist).  Slots
with no valid row come back as score -inf with index -1, the semantics of
``src/repro/kernels/cosine_topk/ops.py`` on its Pallas path.
"""
from __future__ import annotations

import torch


def _top_sorted(scores, k: int):
    top_s, pos = torch.sort(scores, dim=1, descending=True, stable=True)
    return top_s[:, :k], pos[:, :k]


def cosine_topk_ref(queries, db, k: int, valid=None):
    """queries (B,D), db (N,D) -> (scores (B,k) f32 desc, indices (B,k) i32)."""
    scores = queries.float() @ db.float().T
    if valid is not None:
        scores = torch.where(valid[None, :], scores, torch.full_like(scores, -torch.inf))
    top_s, top_i = _top_sorted(scores, k)
    top_i = top_i.to(torch.int32)
    return top_s, torch.where(torch.isfinite(top_s), top_i, torch.full_like(top_i, -1))


def cosine_topk_gather_ref(queries, cand_emb, cand_idx, cand_valid, k: int):
    """Shortlist scan: queries (B,D) against per-query candidates cand_emb
    (B,M,D) gathered beforehand, cand_idx (B,M) global rows, cand_valid (B,M)
    bool -> (scores (B,k) f32 desc, global rows (B,k) i32).  Ties go to the
    lowest candidate position; a row listed twice is reported twice."""
    scores = torch.einsum("bd,bmd->bm", queries.float(), cand_emb.float())
    scores = torch.where(cand_valid, scores, torch.full_like(scores, -torch.inf))
    top_s, pos = _top_sorted(scores, k)
    top_i = torch.gather(cand_idx, 1, pos).to(torch.int32)
    return top_s, torch.where(torch.isfinite(top_s), top_i, torch.full_like(top_i, -1))
