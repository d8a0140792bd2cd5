"""Plain PyTorch prefill attention: the naive and the fixed-block flash forms.

Both mirror ``src/repro/models/attention.py`` (``_attend_naive`` and
``_attend_xla_flash``): GQA by head grouping, positions given explicitly,
scores from an einsum in the input dtype then cast to fp32 (the JAX
package's order), fp32 softmax.  The CPU path of ``ops.flash_attention``
runs these; on the card they are what the kernel is held against.
``attend_grads`` is the backward of either form, what autodiff of the
reference's XLA attention computes, written out.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def position_mask(q_pos, k_pos, causal: bool, window: int):
    """(..., Sq, Sk) boolean allowed-mask from position vectors."""
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    m = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m = m & (kp <= qp)
    if window > 0:
        m = m & (kp > qp - window)
    return m


def attend_naive(q, k, v, q_pos, k_pos, causal: bool, window: int, extra_mask=None):
    """q (B,Sq,H,dh), k/v (B,Sk,Hk,dh) -> (B,Sq,H,dh); full-axis softmax."""
    b, sq, h, dh = q.shape
    hk = k.shape[2]
    qg = q.reshape(b, sq, hk, h // hk, dh)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float() * (dh ** -0.5)
    m = position_mask(q_pos, k_pos, causal, window)[:, None, None]
    if extra_mask is not None:
        m = m & extra_mask[:, None, None, None, :]
    scores = torch.where(m, scores, torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", w.to(v.dtype), v)
    return out.reshape(b, sq, h, dh)


def attend_blockwise(q, k, v, q_pos, k_pos, causal: bool, window: int,
                     block_q: int, block_k: int):
    """Fixed-block online-softmax attention (``_attend_xla_flash``).

    Block sizes are never clamped: keys pad up to a whole number of
    ``block_k`` blocks at position 2**30 and padded queries sit at -1, and
    the key blocks are visited in ascending order with the running
    max/sum/acc recurrence.  All query blocks run at once here; each query
    row's arithmetic is that of its own block.
    """
    b, sq, h, dh = q.shape
    sk, hk = k.shape[1], k.shape[2]
    g = h // hk
    pq = (-sq) % block_q
    pk = (-sk) % block_k
    if pq:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pq))
        q_pos = torch.nn.functional.pad(q_pos, (0, pq), value=-1)
    if pk:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pk))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pk))
        k_pos = torch.nn.functional.pad(k_pos, (0, pk), value=2 ** 30)
    sqp = q.shape[1]
    nk = k.shape[1] // block_k
    qg = q.reshape(b, sqp, hk, g, dh)
    scale = dh ** -0.5
    m_run = torch.full((b, hk, g, sqp), NEG_INF, dtype=torch.float32, device=q.device)
    l_run = torch.zeros((b, hk, g, sqp), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hk, g, sqp, dh), dtype=torch.float32, device=q.device)
    for j in range(nk):
        sl = slice(j * block_k, (j + 1) * block_k)
        ki, vi, kp = k[:, sl], v[:, sl], k_pos[:, sl]
        s = torch.einsum("bskgd,btkd->bkgst", qg, ki).float() * scale
        allowed = position_mask(q_pos, kp, causal, window)[:, None, None]
        s = torch.where(allowed, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m_run - m_new)
        l_run = l_run * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgst,btkd->bkgsd", p, vi.float())
        m_run = m_new
    out = acc / torch.clamp(l_run[..., None], min=1e-30)
    out = torch.einsum("bkgsd->bskgd", out).reshape(b, sqp, h, dh)
    return out[:, :sq].to(q.dtype)


def attend_grads(q, k, v, q_pos, k_pos, d_out, causal: bool, window: int, sk_pad: int):
    """(dq, dk, dv) of the prefill attention at the output gradient ``d_out``
    (B,Sq,H,dh), each in its input's dtype.

    The keys are padded to ``sk_pad`` as the forward pads them (zero K/V at
    position 2**30; ``ops.padded_keys``).  All arithmetic is fp32: the
    scaled scores are recomputed and masked, P is their softmax, and

        dV = P^T dO,  dP = dO V^T,  dS = P * (dP - rowsum(dP * P)),
        dQ = scale dS K,  dK = scale dS^T Q,

    dK and dV summed over each GQA group.  dS is zero where the mask
    forbids a key, so a query row with no allowed key gives nothing to dq
    and dk; its P is uniform (the forward averages V over the padded keys),
    and dV takes that share, as autodiff of the forward does.
    """
    b, sq, h, dh = q.shape
    sk, hk = k.shape[1], k.shape[2]
    qf, kf, vf, dof = (x.float() for x in (q, k, v, d_out))
    if sk_pad > sk:
        pad = (0, 0, 0, 0, 0, sk_pad - sk)
        kf = torch.nn.functional.pad(kf, pad)
        vf = torch.nn.functional.pad(vf, pad)
        k_pos = torch.nn.functional.pad(k_pos, (0, sk_pad - sk), value=2 ** 30)
    qg = qf.reshape(b, sq, hk, h // hk, dh)
    dog = dof.reshape(b, sq, hk, h // hk, dh)
    scale = dh ** -0.5
    allowed = position_mask(q_pos, k_pos, causal, window)[:, None, None]
    s = torch.einsum("bskgd,btkd->bkgst", qg, kf) * scale
    p = torch.softmax(torch.where(allowed, s, torch.full_like(s, NEG_INF)), dim=-1)
    dv = torch.einsum("bkgst,bskgd->btkd", p, dog)
    dp = torch.einsum("bskgd,btkd->bkgst", dog, vf)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    ds = torch.where(allowed, ds, torch.zeros_like(ds)) * scale
    dq = torch.einsum("bkgst,btkd->bskgd", ds, kf).reshape(b, sq, h, dh)
    dk = torch.einsum("bkgst,bskgd->btkd", ds, qg)
    return dq.to(q.dtype), dk[:, :sk].to(k.dtype), dv[:, :sk].to(v.dtype)
