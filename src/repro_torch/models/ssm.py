"""Mamba-2 SSD mixer, chunked scan form (counterpart of
``src/repro/models/ssm.py``, arXiv:2405.21060).

Within a chunk of ``L = min(ssm_chunk, S)`` tokens the SSD is the masked
matrix product (its "dual" form); the states at the chunk boundaries are
carried in fp32 by a loop over the ``S / L`` chunks (the reference's
``lax.scan``).  Decode is one step of the recurrence over the (H, P, N)
state and a rolling depthwise-conv state.

These are products and elementwise passes that the JAX package computes in
XLA, outside any Pallas kernel, so here they are plain PyTorch on every
device: no kernel is written for them.

Parameters (the reference's names and layouts): ``w_in`` (d, 2 di + 2 G N +
H), ``conv_w`` (C, W) and ``conv_b`` (C,) with C = di + 2 G N, ``w_out``
(di, d) in the model dtype; ``a_log``, ``d_skip``, ``dt_bias`` (H,) and the
``gate_norm`` scale in fp32.  State: ``ssm`` (B, H, P, N) fp32 and ``conv``
(B, W-1, C), the last W-1 inputs of the conv before it, in the model dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import torch_dtype

from .config import ModelConfig
from .layers import apply_norm, dense_init, init_norm


def conv_dim(cfg: ModelConfig) -> int:
    return cfg.ssm_d_inner + 2 * cfg.ssm_groups * cfg.ssm_state


def init_mamba2(cfg: ModelConfig, generator, device):
    """Random weights drawn as the reference draws them."""
    d = cfg.d_model
    di, ns, nh, g = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_groups
    dt = torch_dtype(cfg.dtype)
    conv_w = torch.randn((conv_dim(cfg), cfg.ssm_conv_width), generator=generator,
                         device=device)
    return {
        "w_in": dense_init((d, 2 * di + 2 * g * ns + nh), dt, generator, device),
        "conv_w": (0.1 * conv_w).to(dt),
        "conv_b": torch.zeros(conv_dim(cfg), dtype=dt, device=device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, nh, device=device)),
        "d_skip": torch.ones(nh, dtype=torch.float32, device=device),
        "dt_bias": torch.zeros(nh, dtype=torch.float32, device=device),
        "gate_norm": init_norm(di, "rmsnorm", device),
        "w_out": dense_init((di, d), dt, generator, device, stddev=di ** -0.5),
    }


def split_proj(params, x, cfg: ModelConfig):
    """x (B,S,d) -> z (B,S,di), xbc (B,S,C), dt (B,S,H), in the model dtype."""
    di = cfg.ssm_d_inner
    return (x @ params["w_in"]).split([di, conv_dim(cfg), cfg.ssm_heads], dim=-1)


def causal_conv(params, xbc, conv_state=None):
    """Depthwise causal conv of width W over xbc (B,S,C), then silu, in fp32.
    Returns (y, new_state), both in xbc's dtype: the state is the last W-1
    inputs, zeros (or ``conv_state``) before the first."""
    w = params["conv_w"].float()
    width = w.shape[1]
    xf = xbc.float()
    pad = (xf.new_zeros((xf.shape[0], width - 1, xf.shape[2])) if conv_state is None
           else conv_state.float())
    xp = torch.cat([pad, xf], dim=1)
    s = xf.shape[1]
    y = sum(xp[:, i:i + s, :] * w[:, i] for i in range(width))
    y = F.silu(y + params["conv_b"].float())
    return y.to(xbc.dtype), xp[:, -(width - 1):, :].to(xbc.dtype)


def ssd_chunked(x, a_log, b, c, dt, cfg: ModelConfig, h0=None):
    """x (B,S,H,P); a_log (B,S,H) the log decay; b, c (B,S,G,N); dt (B,S,H).
    Returns (y (B,S,H,P) in x's dtype, the final state (B,H,P,N) fp32).

    A sequence that is not a whole number of chunks is padded at the FRONT
    with zeros, as the reference pads it, which is exact only from a zero
    state: padded tokens have x = 0 and nothing before them decays."""
    bsz, s, h, p = x.shape
    n = b.shape[3]
    chunk = min(cfg.ssm_chunk, s)
    pad = (-s) % chunk
    if pad:
        if h0 is not None:
            raise ValueError("front padding requires a zero initial state")
        front = lambda t: F.pad(t, (0, 0) * (t.dim() - 2) + (pad, 0))
        y, h_last = ssd_chunked(front(x), front(a_log), front(b), front(c), front(dt), cfg)
        return y[:, pad:], h_last
    nc = s // chunk
    rep = h // b.shape[2]

    def chunks(t):   # (B,S,...) -> (B,nc,L,...)
        return t.reshape(bsz, nc, chunk, *t.shape[2:])

    xc, dtc = chunks(x.float()), chunks(dt)
    bh = chunks(b.float()).repeat_interleave(rep, dim=3)          # (B,nc,L,H,N)
    ch = chunks(c.float()).repeat_interleave(rep, dim=3)
    la = torch.cumsum(chunks(a_log), dim=2)                        # (B,nc,L,H)
    # intra-chunk: the masked product
    gmat = torch.einsum("bclhn,bcshn->bchls", ch, bh)
    seg = (la[..., :, None, :] - la[..., None, :, :]).movedim(-1, 2)   # (B,nc,H,L,L)
    # mask BEFORE exp: a future position's seg is large and positive, and
    # exp of it would make the gradient 0 * inf = NaN through the where
    causal = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    seg = torch.where(causal, seg, torch.full((), -1e9, device=x.device))
    xdt = xc * dtc[..., None]                                      # (B,nc,L,H,P)
    y_intra = torch.einsum("bchls,bcshp->bclhp", gmat * torch.exp(seg), xdt)
    # each chunk's own state, and the decay across it
    decay_to_end = torch.exp(la[:, :, -1:, :] - la)                # (B,nc,L,H)
    s_chunk = torch.einsum("bcshn,bcshp,bcsh->bchpn", bh, xdt, decay_to_end)
    chunk_decay = torch.exp(la[:, :, -1, :])                       # (B,nc,H)
    state = (x.new_zeros((bsz, h, p, n), dtype=torch.float32) if h0 is None
             else h0.float())
    entering = []
    for i in range(nc):
        entering.append(state)
        state = state * chunk_decay[:, i, :, None, None] + s_chunk[:, i]
    hprev = torch.stack(entering, dim=1)                           # (B,nc,H,P,N)
    y_inter = torch.einsum("bclhn,bchpn,bclh->bclhp", ch, hprev, torch.exp(la))
    y = (y_intra + y_inter).reshape(bsz, s, h, p)
    return y.to(x.dtype), state


def _gated_out(params, y, z, x_dtype):
    y = apply_norm(params["gate_norm"], y.to(x_dtype) * F.silu(z), "rmsnorm")
    return y @ params["w_out"]


def mamba2_forward(params, x, cfg: ModelConfig):
    """Full-sequence SSD.  x (B,S,d) -> (y (B,S,d), state {"ssm", "conv"})."""
    di, ns, nh, g = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_groups
    bsz, s = x.shape[:2]
    z, xbc, dt_raw = split_proj(params, x, cfg)
    xbc, conv_state = causal_conv(params, xbc)
    xin, b, c = xbc.split([di, g * ns, g * ns], dim=-1)
    xin = xin.reshape(bsz, s, nh, cfg.ssm_head_dim)
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    a_log = -torch.exp(params["a_log"]) * dt                       # (B,S,H) log decay
    y, h_last = ssd_chunked(xin, a_log, b.reshape(bsz, s, g, ns), c.reshape(bsz, s, g, ns),
                            dt, cfg)
    y = y + xin.float() * params["d_skip"][:, None]
    out = _gated_out(params, y.reshape(bsz, s, di), z, x.dtype)
    return out, {"ssm": h_last, "conv": conv_state}


def init_mamba2_state(batch: int, cfg: ModelConfig, device, lead=()):
    """Zero state of ``batch`` rows (with leading dims ``lead``, a stack of
    layers)."""
    dt = torch_dtype(cfg.dtype)
    return {"ssm": torch.zeros(lead + (batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                               dtype=torch.float32, device=device),
            "conv": torch.zeros(lead + (batch, cfg.ssm_conv_width - 1, conv_dim(cfg)),
                                dtype=dt, device=device)}


def mamba2_decode(params, x, state, cfg: ModelConfig):
    """One token x (B,1,d) -> (y (B,1,d), new state).  ``y`` is cast to the
    model dtype before the gated norm, as the reference casts it."""
    di, ns, nh, g = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_groups
    bsz = x.shape[0]
    z, xbc, dt_raw = split_proj(params, x, cfg)
    xbc, conv_state = causal_conv(params, xbc, conv_state=state["conv"])
    xin, b, c = xbc.split([di, g * ns, g * ns], dim=-1)
    xin = xin.reshape(bsz, nh, cfg.ssm_head_dim).float()
    rep = nh // g
    bh = b.reshape(bsz, g, ns).float().repeat_interleave(rep, dim=1)   # (B,H,N)
    ch = c.reshape(bsz, g, ns).float().repeat_interleave(rep, dim=1)
    dt = F.softplus(dt_raw[:, 0].float() + params["dt_bias"])          # (B,H)
    a = torch.exp(-torch.exp(params["a_log"]) * dt)
    h = state["ssm"] * a[:, :, None, None] + torch.einsum("bhp,bhn,bh->bhpn", xin, bh, dt)
    y = torch.einsum("bhpn,bhn->bhp", h, ch) + xin * params["d_skip"][:, None]
    out = _gated_out(params, y.reshape(bsz, 1, di), z, x.dtype)
    return out, {"ssm": h, "conv": conv_state}
