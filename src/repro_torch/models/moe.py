"""GShard top-k Mixture-of-Experts with capacity dispatch (counterpart of
``src/repro/models/moe.py``), with Arctic's parallel dense residual.

The reference dispatches through (G, S, E, C) one-hot einsums, the form
GSPMD shards.  The port computes the same function by index: each (token,
choice) pair gets its rank in its expert (the reference's cumsum order over
the group's pairs flattened ``(S, k)`` row-major), the kept pairs' rows are
copied into an ``(E, G*C, d)`` buffer, the experts run as batched matmuls
over every expert, and each kept pair's output row is gathered back and
weighted.  A pair ranked at or past the capacity C is dropped, so a token's
output depends on the other tokens of its dispatch group: that is the
reference's semantics, kept here.

Parameters: ``router`` (d, E) fp32 whatever the model dtype; ``w_gate_up``
(E, d, 2f) the experts' gate | up (the MLP's fused idiom), ``w_down`` (E, f,
d); ``dense`` a swiglu MLP when ``cfg.moe_dense_residual``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import torch_dtype

from . import sharding_utils as shu
from .config import ModelConfig
from .layers import apply_mlp, dense_init, init_mlp, truncated_normal


def init_moe(cfg: ModelConfig, generator, device):
    """Random MoE weights on ``device``.  Each expert is drawn on its own, so
    the fp32 temporary of the draw is one expert's, not the layer's."""
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    dt = torch_dtype(cfg.dtype)
    p = {"router": dense_init((d, e), torch.float32, generator, device),
         "w_gate_up": torch.empty((e, d, 2 * f), dtype=dt, device=device),
         "w_down": torch.empty((e, f, d), dtype=dt, device=device)}
    for i in range(e):
        p["w_gate_up"][i] = truncated_normal((d, 2 * f), d ** -0.5, dt, generator, device)
        p["w_down"][i] = truncated_normal((f, d), f ** -0.5, dt, generator, device)
    if cfg.moe_dense_residual:
        p["dense"] = init_mlp(d, cfg.d_ff, "swiglu", dt, generator, device)
    return p


def capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    """Slots per expert and group: ``cf * k * S_g / E`` truncated, rounded up
    to a multiple of 8, at least 8 (the reference's ``_capacity``)."""
    # hostsync: ok static config arithmetic
    c = int(cfg.capacity_factor * cfg.experts_per_token * tokens_per_group / cfg.num_experts)
    return max(8, ((c + 7) // 8) * 8)


def router_topk(params, x, cfg: ModelConfig):
    """x (G,S,d) -> (probs (G,S,k) fp32, idx (G,S,k), aux scalar).

    fp32 logits; the top k by a stable descending sort, so equal logits go
    to the lowest expert as ``lax.top_k`` sends them (a zero pad row routes
    to experts 0..k-1).  ``aux`` is the Switch load-balance loss E * sum of
    (mean router probability) * (share of top-1 assignments), pad rows
    included as in the reference."""
    logits = x.float() @ params["router"]
    k, e = cfg.experts_per_token, cfg.num_experts
    idx = torch.sort(logits.detach(), dim=-1, descending=True, stable=True).indices[..., :k]
    probs = torch.softmax(logits.gather(-1, idx), dim=-1)
    me = torch.softmax(logits, dim=-1).mean(dim=(0, 1))
    top1 = idx[..., 0].reshape(-1)
    counts = torch.zeros(e, dtype=torch.float32, device=x.device).scatter_add_(
        0, top1, torch.ones(top1.shape, dtype=torch.float32, device=x.device))
    aux = e * torch.sum(me * (counts / top1.numel()))
    return probs, idx, aux


def expert_ranks(idx, num_experts: int):
    """idx (G,S,k) -> the rank of each (token, choice) pair among the pairs
    of its group routed to the same expert, in the order of the pairs
    flattened ``(S, k)`` row-major (token s's second choice before token
    s+1's first), by a stable sort on the expert id."""
    g = idx.shape[0]
    flat = idx.reshape(g, -1)
    order = torch.sort(flat, dim=1, stable=True).indices
    counts = torch.zeros((g, num_experts), dtype=torch.int64, device=idx.device)
    counts.scatter_add_(1, flat, torch.ones_like(flat))
    starts = torch.cumsum(counts, dim=1) - counts
    ranked = (torch.arange(flat.shape[1], device=idx.device)
              - starts.gather(1, flat.gather(1, order)))
    return torch.empty_like(flat).scatter_(1, order, ranked).view_as(idx)


def route(params, x, cfg: ModelConfig):
    """Group and route x (B,S,d): the B*S tokens, row-major, cut into groups
    of ``min(moe_group_size, B*S)``, the last zero-padded.  Returns (xf
    (G*S_g, d) the grouped tokens; probs, idx and rank (G,S_g,k); the
    capacity C; aux).  A pair is kept when its rank in its expert is below
    C, and dropped otherwise."""
    b, s, d = x.shape
    n = b * s
    gsz = min(cfg.moe_group_size, n)
    pad = (-n) % gsz
    xf = x.reshape(n, d)
    if pad:
        xf = torch.cat([xf, xf.new_zeros(pad, d)])
    # the reference re-seeds the batch sharding on the group dim
    xg = shu.constrain(xf.view(-1, gsz, d), shu.BATCH, None, None)
    probs, idx, aux = router_topk(params, xg, cfg)
    return xf, probs, idx, expert_ranks(idx, cfg.num_experts), capacity(cfg, gsz), aux


def apply_moe(params, x, cfg: ModelConfig):
    """x (B,S,d) -> (out (B,S,d), aux * router_aux_coef).

    Each group dispatches its kept pairs into an (E, G*C, d) buffer, the
    experts run over it as batched matmuls, and each kept pair's output is
    gathered back.  The combine weights are rounded to the model dtype
    before they weight the expert outputs, as the reference's combine
    tensor is; the dense residual, if any, is added after."""
    b, s, d = x.shape
    xf, probs, idx, rank, cap, aux = route(params, x, cfg)
    groups, gsz, k = idx.shape
    e = cfg.num_experts
    keep = rank < cap
    # the row of each kept pair in the (E, G*C) buffer; dropped pairs go to
    # one spare row past the end, which is never read
    group = torch.arange(groups, device=x.device)[:, None, None]
    dst = torch.where(keep, idx * (groups * cap) + group * cap + rank,
                      e * groups * cap).reshape(-1)
    rows = xf.repeat_interleave(k, dim=0)                     # pair (g, s, j) -> token (g, s)
    buf = xf.new_zeros(e * groups * cap + 1, d).index_copy(0, dst, rows)
    ex_in = buf[:-1].view(e, groups * cap, d)
    gate, up = torch.bmm(ex_in, params["w_gate_up"]).chunk(2, dim=-1)
    ex_out = torch.bmm(F.silu(gate) * up, params["w_down"]).view(e * groups * cap, d)
    weights = (probs * keep).to(x.dtype)                      # dropped pairs weigh 0
    got = ex_out[torch.where(keep.reshape(-1), dst, 0)].view(groups * gsz, k, d)
    out = torch.sum(got.float() * weights.reshape(-1, k, 1).float(), dim=1).to(x.dtype)
    if cfg.moe_dense_residual:
        out = out + apply_mlp(params["dense"], xf, "swiglu")
    return out[:b * s].view(b, s, d), aux * cfg.router_aux_coef
