"""Plain PyTorch single-token decode attention over a dense KV cache.

Mirrors ``src/repro/kernels/decode_attention/ref.py::decode_attention_ref``:
fp32 scores, slots ``t >= cache_len`` masked with -1e30, fp32 softmax.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def decode_attention_ref(q, k, v, cache_len):
    """q (B,H,dh); k/v (B,T,Hk,dh); cache_len (B,) -> (B,H,dh) in q.dtype."""
    b, h, dh = q.shape
    t, hk = k.shape[1], k.shape[2]
    qg = q.reshape(b, hk, h // hk, dh)
    s = torch.einsum("bkgd,btkd->bkgt", qg.float(), k.float()) * (dh ** -0.5)
    valid = torch.arange(t, device=q.device)[None, :] < cache_len[:, None]
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", w, v.float())
    return out.reshape(b, h, dh).to(q.dtype)


def decode_attention_block_ref(q, k, v, cache_len):
    """q (B,K,H,dh): K queries per row whose keys sit at slots
    ``cache_len + i``; k/v (B,T,Hk,dh); query i keeps slots
    ``t < cache_len + i + 1`` -> (B,K,H,dh) in q.dtype (mirrors the JAX
    ``decode_attention_block_ref``)."""
    b, kq, h, dh = q.shape
    t, hk = k.shape[1], k.shape[2]
    qg = q.reshape(b, kq, hk, h // hk, dh)
    s = torch.einsum("bikgd,btkd->bkgit", qg.float(), k.float()) * (dh ** -0.5)
    limit = cache_len[:, None] + torch.arange(kq, device=q.device)[None, :] + 1   # (B,K)
    valid = torch.arange(t, device=q.device)[None, None, :] < limit[:, :, None]  # (B,K,T)
    s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgit,btkd->bikgd", w, v.float())
    return out.reshape(b, kq, h, dh).to(q.dtype)
