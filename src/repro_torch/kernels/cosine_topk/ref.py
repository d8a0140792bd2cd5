"""Plain PyTorch cosine top-k over the flat cache bank.

Scores by one matmul, invalid rows to -inf, then an explicitly stable
descending sort (``torch.topk`` promises nothing about ties), so ties go to
the lowest index.  Slots with no valid row come back as score -inf with
index -1, the semantics of ``src/repro/kernels/cosine_topk/ops.py`` on its
Pallas path.
"""
from __future__ import annotations

import torch


def cosine_topk_ref(queries, db, k: int, valid=None):
    """queries (B,D), db (N,D) -> (scores (B,k) f32 desc, indices (B,k) i32)."""
    scores = queries.float() @ db.float().T
    if valid is not None:
        scores = torch.where(valid[None, :], scores, torch.full_like(scores, -torch.inf))
    top_s, top_i = torch.sort(scores, dim=1, descending=True, stable=True)
    top_s, top_i = top_s[:, :k], top_i[:, :k].to(torch.int32)
    return top_s, torch.where(torch.isfinite(top_s), top_i, torch.full_like(top_i, -1))
