"""GQA attention, the dense path of ``src/repro/models/attention.py``.

* ``self_attention`` — full-sequence prefill, optionally over a stored
  shared prefix; returns the rotary-applied K/V for the cache.
* ``decode_attention`` — one new token against a dense KV cache.

Prefill attention goes through ``kernels.flash_attention.ops`` and decode
through ``kernels.decode_attention.ops``: the hand-written kernels on a
CUDA tensor, their plain versions on a CPU tensor.  The windowed ring
buffer, the paged cache and the q-block (speculative) decode are not
ported and raise.

Layouts follow the JAX package at the public functions: activations
(B,S,d), heads (B,S,H,dh), caches (B,T,Hk,dh).  The projection weights
are 2-D: ``w_qkv`` (d, (H+2Hk)*dh) holds w_q | w_k | w_v and ``w_o`` is
(H*dh, d) (``checkpoint.convert`` builds them from the JAX layout).
"""
from __future__ import annotations

import torch

from repro_torch.device import torch_dtype
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import attend_naive

from .config import ModelConfig
from .layers import apply_rope, dense_init


def init_attention(cfg: ModelConfig, generator, device):
    """One layer's attention weights, drawn as the JAX package draws w_q,
    w_k, w_v (d, heads*dh) and w_o (H*dh, d)."""
    d, h, hk, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    if cfg.qkv_bias:
        raise NotImplementedError("qkv_bias is not ported")
    dt = torch_dtype(cfg.dtype)
    w_q = dense_init((d, h * dh), dt, generator, device)
    w_k = dense_init((d, hk * dh), dt, generator, device)
    w_v = dense_init((d, hk * dh), dt, generator, device)
    return {"w_qkv": torch.cat([w_q, w_k, w_v], dim=-1),
            "w_o": dense_init((h * dh, d), dt, generator, device)}


def project_qkv(w_qkv, x, cfg: ModelConfig):
    """x (B,S,d) -> q (B,S,H,dh), k, v (B,S,Hk,dh)."""
    b, s, _ = x.shape
    h, hk, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q, k, v = (x @ w_qkv).split([h * dh, hk * dh, hk * dh], dim=-1)
    return (q.reshape(b, s, h, dh), k.reshape(b, s, hk, dh),
            v.reshape(b, s, hk, dh).contiguous())


def attend(q, k, v, q_pos, k_pos, *, causal: bool, window: int, impl: str,
           block_q: int = 512, block_k: int = 512):
    """Prefill attention with the JAX package's ``impl`` semantics.

    "auto" resolves as the reference does (naive up to 2048 tokens, the
    fixed-block flash form beyond).  The Pallas impl of the reference
    drops the positions, so the port does not offer it.
    """
    if impl == "auto":
        impl = "xla_flash" if max(q.shape[1], k.shape[1]) > 2048 else "naive"
    if impl not in ("naive", "xla_flash"):
        raise NotImplementedError(f"attention_impl {impl!r}: use naive or xla_flash")
    return flash_ops.flash_attention(q, k, v, q_pos, k_pos, causal=causal,
                                     window=window, block_q=block_q,
                                     block_k=block_k, impl=impl)


def self_attention(p, x, positions, cfg: ModelConfig, *, window: int = 0,
                   prefix=None):
    """Causal self attention.  Returns (out, (k, v, k_pos)).

    ``prefix`` is one layer's stored prefix KV (``{"k", "v", "slot_pos"}``,
    rope already applied); the queries, whose positions start after it,
    attend over ``[prefix | self]`` and the returned K/V cover both, ready
    to lay out slots ``[0, P+S)`` as an inline prefill would.
    """
    q, k, v = project_qkv(p["w_qkv"], x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    k_pos = positions
    if prefix is not None:
        k = torch.cat([prefix["k"].to(k.dtype), k], dim=1)
        v = torch.cat([prefix["v"].to(v.dtype), v], dim=1)
        k_pos = torch.cat([prefix["slot_pos"], positions], dim=1)
    ctx = attend(q, k, v, positions, k_pos, causal=True, window=window,
                 impl=cfg.attention_impl, block_q=cfg.flash_block_q,
                 block_k=cfg.flash_block_k)
    b, s = x.shape[:2]
    return ctx.reshape(b, s, -1) @ p["w_o"], (k, v, k_pos)


def init_kv_cache(layers: int, batch: int, capacity: int, cfg: ModelConfig, device,
                  dtype=None):
    """Stacked dense caches: k/v (L,B,T,Hk,dh), slot_pos (L,B,T) (-1 = empty)."""
    dt = torch_dtype(dtype or cfg.dtype)
    hk, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    return {
        "k": torch.zeros((layers, batch, capacity, hk, dh), dtype=dt, device=device),
        "v": torch.zeros((layers, batch, capacity, hk, dh), dtype=dt, device=device),
        "slot_pos": torch.full((layers, batch, capacity), -1, dtype=torch.int32,
                               device=device),
    }


def fill_kv_cache(cache, layer: int, k, v, positions):
    """Write a prefill's k/v (B,S,Hk,dh) into slots [0, S) of one layer, in
    place (the JAX package's dynamic_update_slice on a fresh buffer)."""
    s = k.shape[1]
    cache["k"][layer, :, :s] = k
    cache["v"][layer, :, :s] = v
    cache["slot_pos"][layer, :, :s] = positions


def decode_attention(p, x, cache, layer: int, pos: int, cache_len, cfg: ModelConfig,
                     *, window: int = 0):
    """One token x (B,1,d) at absolute position ``pos`` against one layer's
    dense cache, updated in place (the JAX package donates the buffer).

    The reference writes the token into slot ``pos`` and attends with
    ``slot_pos >= 0 & slot_pos <= pos``.  A dense global cache filled by
    prefill holds position t in slot t, so that mask is ``t < pos + 1`` and
    the kernel takes ``cache_len = pos + 1`` (B,) int32, built once per step
    by the caller.
    """
    if window > 0:
        raise NotImplementedError("windowed (ring-buffer) decode is not ported")
    if "kp" in cache:
        raise NotImplementedError("paged KV decode is not ported")
    b = x.shape[0]
    capacity = cache["k"].shape[2]
    q, k, v = project_qkv(p["w_qkv"], x, cfg)
    cur = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, cur, cfg.rope_theta)
    k = apply_rope(k, cur, cfg.rope_theta)
    slot = min(pos, capacity - 1)
    cache["k"][layer, :, slot] = k[:, 0]
    cache["v"][layer, :, slot] = v[:, 0]
    cache["slot_pos"][layer, :, slot] = pos
    ctx = decode_ops.decode_attention(q[:, 0].contiguous(), cache["k"][layer],
                                      cache["v"][layer], cache_len)
    return ctx.reshape(b, 1, -1) @ p["w_o"]


def encoder_attention(p, x, positions, valid, cfg: ModelConfig):
    """Bidirectional masked attention for the embedder, plain PyTorch (the
    JAX package computes it in XLA, not in a kernel)."""
    q, k, v = project_qkv(p["w_qkv"], x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    ctx = attend_naive(q, k, v, positions, positions, False, 0, extra_mask=valid)
    b, s = x.shape[:2]
    return ctx.reshape(b, s, -1) @ p["w_o"]
