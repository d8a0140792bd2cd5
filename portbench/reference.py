"""The plain reference: the embedder, the two language models and the
lookup, in plain PyTorch, float32 and nothing of the program.

Weights are the benchmark's own (``weights.py``): the same tensors the
program serves with, read in the layout the program takes them in and
upcast here matrix by matrix.  A model runs teacher-forced over the
sequence the program decoded, so one forward gives the logit of every
served token; a MoE layer forms the dispatch groups the serving path forms
(the padded prefill batch, then each decode step's rows) and drops a pair
ranked at or past its group's capacity, the GShard semantics of the
configuration.

``quant="fp8"`` is the control of the language models: every weight matrix
rounded to float8 e4m3 with a scale per output column, activations kept in
float32.  ``tf32=True`` is the control of the embedder, whose configuration
states float32: its products in TF32.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

NEG = -1e30
FP8_MAX = 448.0


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """Products in float32 (TF32 off) or, for the control, in TF32."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _w(t, quant=None):
    """A weight in float32, or its fp8 rounding (scale per output column:
    the last axis of a (.., in, out) matrix)."""
    w = t.float()
    if quant != "fp8" or w.dim() < 2:
        return w
    s = w.abs().amax(dim=-2, keepdim=True).clamp(min=1e-12) / FP8_MAX
    return (w / s).to(torch.float8_e4m3fn).float() * s


def norm(p, x, kind: str, eps: float = 1e-6):
    if kind == "layernorm":
        mu = x.mean(-1, keepdim=True)
        xc = x - mu
        return xc * torch.rsqrt(xc.square().mean(-1, keepdim=True) + eps) * p["scale"].float() \
            + p["bias"].float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * p["scale"].float()


def rope(x, pos, theta: float):
    """x (B,S,H,dh), pos (S,) -> rotated, the halves split (not interleaved)."""
    dh = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32, device=x.device) / dh))
    ang = pos.float()[:, None] * freqs
    sin, cos = torch.sin(ang)[:, None, :], torch.cos(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(p, h, cfg, *, causal: bool, window: int = 0, key_valid=None, quant=None):
    """h (B,S,d) -> (B,S,d); GQA by head grouping, rotary at positions 0..S-1."""
    b, s, _ = h.shape
    nh, hk, dh = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    y = h @ _w(p["w_qkv"], quant)
    if "b_qkv" in p:
        y = y + p["b_qkv"].float()
    q, k, v = y.split([nh * dh, hk * dh, hk * dh], dim=-1)
    pos = torch.arange(s, device=h.device)
    q = rope(q.reshape(b, s, nh, dh), pos, cfg["rope_theta"])
    k = rope(k.reshape(b, s, hk, dh), pos, cfg["rope_theta"])
    v = v.reshape(b, s, hk, dh)
    g = nh // hk
    q = q.reshape(b, s, hk, g, dh)
    scores = torch.einsum("bskgd,btkd->bkgst", q, k) * dh ** -0.5
    allow = torch.ones(s, s, dtype=torch.bool, device=h.device)
    if causal:
        allow = allow & (pos[None, :] <= pos[:, None])
    if window > 0:
        allow = allow & (pos[None, :] > pos[:, None] - window)
    allow = allow[None, None, None]
    if key_valid is not None:
        allow = allow & key_valid[:, None, None, None, :]
    w = torch.softmax(scores.masked_fill(~allow, NEG), dim=-1)
    ctx = torch.einsum("bkgst,btkd->bskgd", w, v).reshape(b, s, nh * dh)
    return ctx @ _w(p["w_o"], quant)


def mlp(p, h, kind: str, quant=None):
    if kind == "swiglu":
        g, u = (h @ _w(p["w_gate_up"], quant)).chunk(2, dim=-1)
        a = F.silu(g) * u
    elif kind == "squared_relu":
        a = torch.square(F.relu(h @ _w(p["w_up"], quant)))
    else:
        a = F.gelu(h @ _w(p["w_up"], quant), approximate="tanh")
    return a @ _w(p["w_down"], quant)


# ------------------------------------------------------------- embedder

def encode(params, tokens, mask, cfg, tf32: bool = False):
    """MiniLM over tokens (B,S) with ``mask`` (B,S) {0,1}: bidirectional
    attention over the valid tokens, mean pooling, unit length.  Also the
    forward of the benchmark's own training of the embedder."""
    with matmul_precision(tf32):
        valid = mask.bool()
        x = params["embed"].float()[tokens]
        for p in params["layers"]:
            x = x + attention(p["attn"], norm(p["norm1"], x, "layernorm"), cfg, causal=False,
                              key_valid=valid)
            x = x + mlp(p["mlp"], norm(p["norm2"], x, "layernorm"), "gelu")
        x = norm(params["final_norm"], x, "layernorm")
        m = mask.float()[..., None]
        pooled = (x * m).sum(1) / m.sum(1).clamp(min=1.0)
        return pooled / pooled.norm(dim=-1, keepdim=True).clamp(min=1e-8)


def train_embedder(params, cfg, batches, lr: float = 1e-3, temp: float = 0.07,
                   neg_margin: float = 0.4):
    """Contrastive training in place: InfoNCE both ways over (anchor,
    paraphrase) plus a margin push on each anchor's hard negative; AdamW,
    the global norm clipped at 1.  Returns the losses (tensors)."""
    leaves = _leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    opt = torch.optim.AdamW(leaves, lr=lr, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.0)
    losses = []
    for ta, ma, tb, mb, tn, mn in batches:
        with torch.enable_grad():
            za, zb, zn = encode(params, ta, ma, cfg), encode(params, tb, mb, cfg), \
                encode(params, tn, mn, cfg)
            logits = za @ zb.T / temp
            lab = torch.arange(za.shape[0], device=za.device)
            loss = 0.5 * (F.cross_entropy(logits, lab) + F.cross_entropy(logits.T, lab)) \
                + F.relu((za * zn).sum(-1) - (1.0 - neg_margin)).mean()
            opt.zero_grad(set_to_none=True)
            loss.backward()
        torch.nn.utils.clip_grad_norm_(leaves, 1.0)
        opt.step()
        losses.append(loss.detach())
    for t in leaves:
        t.requires_grad_(False)
        t.grad = None
    return losses


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


# ------------------------------------------------------------- language models

def capacity(cfg, tokens: int) -> int:
    """Slots per expert in a group of ``tokens``: cf * k * tokens / E,
    truncated, rounded up to a multiple of 8, at least 8."""
    c = int(cfg["capacity_factor"] * cfg["experts_per_token"] * tokens / cfg["num_experts"])
    return max(8, -(-c // 8) * 8)


def moe(p, h, cfg, groups, quant=None):
    """h (N,d) tokens in dispatch order; ``groups`` (N,) the group of each,
    the groups contiguous and in order.  Top-k of the fp32 router, softmax
    over the k; the pairs of a group ranked per expert in (token, choice)
    order, those ranked at or past the capacity dropped."""
    n, d = h.shape
    e, k = cfg["num_experts"], cfg["experts_per_token"]
    logits = h @ p["router"].float()
    idx = torch.sort(logits, dim=-1, descending=True, stable=True).indices[:, :k]
    probs = torch.softmax(logits.gather(1, idx), dim=-1)
    pg = groups[:, None].expand(n, k).reshape(-1)
    pe = idx.reshape(-1)
    key = pg * e + pe
    order = torch.sort(key, stable=True).indices          # pairs already in (token, choice) order
    sk = key[order]
    first = torch.ones_like(sk, dtype=torch.bool)
    first[1:] = sk[1:] != sk[:-1]
    seg_start = torch.cummax(torch.where(first, torch.arange(sk.numel(), device=h.device), 0),
                             0).values
    rank = torch.empty_like(pe)
    rank[order] = torch.arange(sk.numel(), device=h.device) - seg_start
    sizes = torch.bincount(groups)
    cap = torch.tensor([capacity(cfg, int(c)) for c in sizes.tolist()], device=h.device)
    keep = (rank < cap[pg]).view(n, k)
    w = probs * keep
    out = torch.zeros(n, d, dtype=torch.float32, device=h.device)
    tok = torch.arange(n, device=h.device)[:, None].expand(n, k)
    for ex in range(e):
        sel = (idx == ex) & keep
        if not bool(sel.any()):
            continue
        rows = tok[sel]
        g, u = (h[rows] @ _w(p["w_gate_up"][ex], quant)).chunk(2, dim=-1)
        y = (F.silu(g) * u) @ _w(p["w_down"][ex], quant)
        out.index_add_(0, rows, y * w[sel][:, None])
    return out


def decode_groups(batch: int, prompt: int, total: int, group_size: int, device):
    """The MoE group of every position of (batch, total) sequences whose
    first ``prompt`` positions were one prefill and the rest one decode step
    each, in the order the serving path dispatches them; returns (order,
    groups): ``order`` flat indices into the (batch*total) tokens in
    dispatch order, ``groups`` the group of each."""
    b = torch.arange(batch, device=device)
    pre = (b[:, None] * total + torch.arange(prompt, device=device)[None, :]).reshape(-1)
    gsz = min(group_size, pre.numel())
    gpre = torch.arange(pre.numel(), device=device) // gsz
    steps = torch.arange(prompt, total, device=device)
    dec = (b[None, :] * total + steps[:, None]).reshape(-1)
    gdec = int(gpre[-1]) + 1 + torch.arange(steps.numel(), device=device).repeat_interleave(batch)
    return torch.cat([pre, dec]), torch.cat([gpre, gdec])


def lm_logits(params, cfg, seqs, prompt_len: int, at, quant=None):
    """Teacher-forced logits of a language model: ``seqs`` (B,L) the padded
    prompts (``prompt_len`` positions, a shared prefix included) then the
    fed tokens; ``at`` (B,T) positions whose next-token logits to return.
    Returns (B,T,vocab) over the configuration's vocabulary."""
    b, total = seqs.shape
    x = params["embed"][seqs].float()
    order = groups = None
    if cfg.get("num_experts"):
        order, groups = decode_groups(b, prompt_len, total, cfg["moe_group_size"], seqs.device)
    for p in params["layers"]:
        x = x + attention(p["attn"], norm(p["norm1"], x, cfg["norm_type"]), cfg, causal=True,
                          window=cfg["sliding_window"], quant=quant)
        h = norm(p["norm2"], x, cfg["norm_type"])
        if "moe" in p:
            flat = h.reshape(b * total, -1)
            y = torch.empty_like(flat)
            y[order] = moe(p["moe"], flat[order], cfg, groups, quant)
            x = x + y.view_as(x)
        else:
            x = x + mlp(p["mlp"], h, cfg["mlp_type"], quant)
    h = norm(params["final_norm"], x.gather(1, at[..., None].expand(-1, -1, x.shape[-1])),
             cfg["norm_type"])
    head = params["lm_head"][:, :cfg["vocab_size"]]
    return h @ _w(head, quant)


def served_gaps(logits, served):
    """The gap by which each served token's logit lies below the best:
    logits (B,T,V), served (B,T) ids -> (B,T) >= 0."""
    return logits.amax(-1) - logits.gather(-1, served[..., None].long())[..., 0]


def lookup(bank, valid, q, k: int):
    """Flat cosine top-k of unit queries q (B,D) over the valid bank rows."""
    s = (q @ bank.T).masked_fill(~valid[None, :], -math.inf)
    return torch.topk(s, k, dim=-1)
