"""RG-LRU recurrent block (counterpart of ``src/repro/models/rglru.py``,
RecurrentGemma, arXiv:2402.19427).

Two branches over the normed input, merged elementwise and projected back:
``gelu(x W_y)`` and ``x W_x`` -> causal depthwise conv (no activation) ->
the RG-LRU recurrence

  h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t u_t),  a_t = exp(c r_t log sigmoid(lam)),

with its gates r and i computed in fp32 from fp32 weights.  The reference
runs the recurrence as a ``jax.lax.associative_scan``; here it is a
log-depth doubling scan over the sequence in fp32 (ceil(log2 S) elementwise
passes), the same function summed in another tree order.  Decode is one
step over the carried (B, W) state.  No Pallas kernel computes any of it in
the JAX package, so it is plain PyTorch on every device.

Parameters (the reference's names and layouts): ``w_y``, ``w_x`` (d, W),
``conv_w`` (W, cw), ``conv_b`` (W,), ``w_o`` (W, d) in the model dtype;
``w_a``, ``w_i`` (W, W), ``b_a``, ``b_i``, ``lam`` (W,) in fp32.  State:
``h`` (B, W) fp32 and ``conv`` (B, cw-1, W) in the model dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import torch_dtype

from .config import ModelConfig
from .layers import dense_init


def init_rglru(cfg: ModelConfig, generator, device):
    """Random weights drawn as the reference draws them: ``lam`` so that a
    is uniform in (0.9, 0.999) at r = 1."""
    d, w = cfg.d_model, cfg.resolved_rnn_width
    dt = torch_dtype(cfg.dtype)
    u = 0.9 + 0.099 * torch.rand(w, generator=generator, device=device)
    conv_w = torch.randn((w, cfg.rglru_conv_width), generator=generator, device=device)
    return {
        "w_y": dense_init((d, w), dt, generator, device),
        "w_x": dense_init((d, w), dt, generator, device),
        "conv_w": (0.1 * conv_w).to(dt),
        "conv_b": torch.zeros(w, dtype=dt, device=device),
        "w_a": dense_init((w, w), torch.float32, generator, device, stddev=w ** -0.5),
        "b_a": torch.zeros(w, dtype=torch.float32, device=device),
        "w_i": dense_init((w, w), torch.float32, generator, device, stddev=w ** -0.5),
        "b_i": torch.zeros(w, dtype=torch.float32, device=device),
        "lam": torch.log(u / (1 - u)),
        "w_o": dense_init((w, d), dt, generator, device, stddev=w ** -0.5),
    }


def gates(params, u, cfg: ModelConfig):
    """(a, the gated input) of u (B,S,W), fp32 throughout."""
    uf = u.float()
    r = torch.sigmoid(uf @ params["w_a"] + params["b_a"])
    i = torch.sigmoid(uf @ params["w_i"] + params["b_i"])
    log_a = cfg.rglru_c * r * F.logsigmoid(params["lam"])
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-8)) * (i * uf)
    return torch.exp(log_a), gated


def conv(params, x, conv_state=None):
    """Depthwise causal conv of x (B,S,W) in fp32, no activation.  Returns
    (y, the last cw-1 inputs), both in x's dtype."""
    w = params["conv_w"].float()
    width = w.shape[1]
    xf = x.float()
    pad = (xf.new_zeros((xf.shape[0], width - 1, xf.shape[2])) if conv_state is None
           else conv_state.float())
    xp = torch.cat([pad, xf], dim=1)
    s = xf.shape[1]
    y = sum(xp[:, i:i + s, :] * w[:, i] for i in range(width))
    return (y + params["conv_b"].float()).to(x.dtype), xp[:, -(width - 1):, :].to(x.dtype)


def linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0 over axis 1 of (B,S,W): the
    prefix combine (a1, b1), (a2, b2) -> (a1 a2, a2 b1 + b2) by recursive
    doubling, ceil(log2 S) passes, each over the whole sequence."""
    s = a.shape[1]
    step = 1
    while step < s:
        a_prev, b_prev = a[:, :-step], b[:, :-step]
        b = torch.cat([b[:, :step], a[:, step:] * b_prev + b[:, step:]], dim=1)
        a = torch.cat([a[:, :step], a[:, step:] * a_prev], dim=1)
        step *= 2
    return b


def rglru_forward(params, x, cfg: ModelConfig):
    """x (B,S,d) -> (out (B,S,d), state {"h", "conv"})."""
    y_branch = F.gelu(x @ params["w_y"], approximate="tanh")    # jax.nn.gelu's default
    u, conv_state = conv(params, x @ params["w_x"])
    a, b = gates(params, u, cfg)
    hh = linear_scan(a, b)
    out = (y_branch * hh.to(x.dtype)) @ params["w_o"]
    return out, {"h": hh[:, -1], "conv": conv_state}


def init_rglru_state(batch: int, cfg: ModelConfig, device, lead=()):
    """Zero state of ``batch`` rows (with leading dims ``lead``, a stack of
    layers)."""
    w = cfg.resolved_rnn_width
    return {"h": torch.zeros(lead + (batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros(lead + (batch, cfg.rglru_conv_width - 1, w),
                                dtype=torch_dtype(cfg.dtype), device=device)}


def rglru_decode(params, x, state, cfg: ModelConfig):
    """One token x (B,1,d) -> (out (B,1,d), new state)."""
    y_branch = F.gelu(x @ params["w_y"], approximate="tanh")
    u, conv_state = conv(params, x @ params["w_x"], conv_state=state["conv"])
    a, b = gates(params, u, cfg)
    h = a[:, 0] * state["h"] + b[:, 0]
    out = (y_branch * h[:, None, :].to(x.dtype)) @ params["w_o"]
    return out, {"h": h, "conv": conv_state}
