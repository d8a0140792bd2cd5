"""Primitive layers: norms, MLP variants, rotary embeddings, initialisers.

Counterpart of ``src/repro/models/layers.py``.  Layers are plain functions
over explicit parameter dicts.  Norm parameters stay fp32 and are cast at
use; weights follow the config dtype.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def truncated_normal(shape, stddev: float, dtype, generator: torch.Generator, device):
    """N(0, stddev) truncated at +-2 stddev, drawn in fp32 on ``device``."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, std=stddev, a=-2.0 * stddev, b=2.0 * stddev,
                                generator=generator)
    return t.to(dtype)


def dense_init(shape, dtype, generator, device, stddev=None):
    """Fan-in scaled weight of ``shape`` (fan-in = shape[-2])."""
    stddev = stddev if stddev is not None else shape[-2] ** -0.5
    return truncated_normal(shape, stddev, dtype, generator, device)


# ----------------------------------------------------------------- norms

def init_norm(shape, norm_type: str, device):
    p = {"scale": torch.ones(shape, dtype=torch.float32, device=device)}
    if norm_type == "layernorm":
        p["bias"] = torch.zeros(shape, dtype=torch.float32, device=device)
    return p


def apply_norm(params, x, norm_type: str, eps: float = 1e-6):
    """fp32 statistics, elementwise math in the input dtype (as the JAX
    package computes it)."""
    scale = params["scale"].to(x.dtype)
    if norm_type == "layernorm":
        mu = torch.mean(x, dim=-1, keepdim=True, dtype=torch.float32)
        xc = x - mu.to(x.dtype)
        var = torch.mean(xc.square(), dim=-1, keepdim=True, dtype=torch.float32)
        inv = torch.rsqrt(var + eps)
        return xc * (inv.to(x.dtype) * scale) + params["bias"].to(x.dtype)
    ms = torch.mean(x.square(), dim=-1, keepdim=True, dtype=torch.float32)
    inv = torch.rsqrt(ms + eps)
    return x * (inv.to(x.dtype) * scale)


# ----------------------------------------------------------------- MLPs

def apply_mlp(params, x, mlp_type: str):
    """``params`` holds ``w_gate_up`` (d, 2f) for swiglu (gate | up) or
    ``w_up`` (d, f) for gelu, and ``w_down`` (f, d)."""
    if mlp_type == "swiglu":
        g, u = (x @ params["w_gate_up"]).chunk(2, dim=-1)
        h = F.silu(g) * u
    elif mlp_type == "gelu":
        h = F.gelu(x @ params["w_up"], approximate="tanh")  # jax.nn.gelu's default
    else:
        raise NotImplementedError(f"mlp_type {mlp_type!r} is not ported")
    return h @ params["w_down"]


# ----------------------------------------------------------------- rotary

def rope_frequencies(head_dim: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))


@functools.lru_cache(maxsize=None)
def _device_frequencies(head_dim: int, theta: float, device: torch.device):
    """The rotary frequencies on ``device``, copied there once: a host->device
    copy on every call would synchronize the stream on every layer."""
    return torch.from_numpy(rope_frequencies(head_dim, theta)).to(device)


def apply_rope(x, positions, theta: float):
    """x (..., S, H, Dh); positions (..., S) int -> x rotated, half-split."""
    freqs = _device_frequencies(x.shape[-1], theta, x.device)
    ang = positions[..., :, None].float() * freqs
    sin = torch.sin(ang)[..., :, None, :]
    cos = torch.cos(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
