"""Plain PyTorch decode attention over a paged KV pool.

Mirrors ``src/repro/kernels/paged_attention/ref.py``: the pages are
gathered back into logical-slot order through the block table, then the
same masked fp32 softmax runs (slots with ``slot_pos < 0`` masked with
-1e30; the q-block form also masks ``slot_pos > q_pos + i``).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def gather_pages(kp, block_tbl, cap: int):
    """(P+1,page,Hk,dh) pages -> (B,cap,Hk,dh) logical slots of each row."""
    b, npg = block_tbl.shape
    page = kp.shape[1]
    return kp[block_tbl.long()].reshape(b, npg * page, *kp.shape[2:])[:, :cap]


def paged_decode_attention_ref(q, kp, vp, block_tbl, slot_pos):
    """q (B,H,dh); kp/vp (P+1,page,Hk,dh); block_tbl (B,npg); slot_pos
    (B,cap), -1 = empty -> (B,H,dh) in q.dtype."""
    b, h, dh = q.shape
    hk = kp.shape[2]
    cap = slot_pos.shape[1]
    k = gather_pages(kp, block_tbl, cap)
    v = gather_pages(vp, block_tbl, cap)
    qg = q.reshape(b, hk, h // hk, dh)
    s = torch.einsum("bkgd,btkd->bkgt", qg.float(), k.float()) * (dh ** -0.5)
    valid = slot_pos >= 0
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", w, v.float())
    return out.reshape(b, h, dh).to(q.dtype)


def paged_decode_attention_block_ref(q, kp, vp, block_tbl, slot_pos, q_pos):
    """q (B,K,H,dh), query i at absolute position ``q_pos + i`` (q_pos (B,));
    keeps ``slot_pos >= 0 & slot_pos <= q_pos + i`` -> (B,K,H,dh)."""
    b, kq, h, dh = q.shape
    hk = kp.shape[2]
    cap = slot_pos.shape[1]
    k = gather_pages(kp, block_tbl, cap)
    v = gather_pages(vp, block_tbl, cap)
    qg = q.reshape(b, kq, hk, h // hk, dh)
    s = torch.einsum("bikgd,btkd->bkgit", qg.float(), k.float()) * (dh ** -0.5)
    limit = q_pos[:, None] + torch.arange(kq, device=q.device)[None, :]       # (B,K)
    sp = slot_pos[:, None, :]
    valid = (sp >= 0) & (sp <= limit[:, :, None])                              # (B,K,cap)
    s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgit,btkd->bikgd", w, v.float())
    return out.reshape(b, kq, h, dh).to(q.dtype)
