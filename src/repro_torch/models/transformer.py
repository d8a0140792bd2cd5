"""Decoder-only LM of global-attention blocks (the ATTN stack of
``src/repro/models/transformer.py``).

Parameters are a dict: ``embed`` (V,d), ``final_norm``, ``lm_head`` (d,V)
unless tied, and ``layers``, one dict per block.  Caches keep the JAX
package's ``{"scan", "rem", "pos"}`` structure: ``scan[0]`` stacks every
layer's KV, ``rem`` is empty for an ATTN-only stack.  Two forms:

* dense (prefill's): ``k``/``v`` (L,B,T,Hk,dh), ``slot_pos`` (L,B,T), and
  ``pos`` (the tokens already in the cache) a host integer, so the dense
  decode step needs no device round trip to place the next token;
* per-row: ``pos`` a (B,) int32 device tensor, for paged caches
  (``serving.paged_kv``) and for block (speculative) decode, whose rows
  advance by different amounts (``paged_kv.row_pos_caches`` converts).

  forward(params, tokens, cfg)                     -> (logits (B,S,V), aux)  (training)
  loss_fn(params, tokens, targets, mask, cfg)      -> (loss, metrics)
  prefill(params, tokens, cfg, capacity[, prefix]) -> (last logits (B,V), caches)
  decode_step(params, token, caches, cfg)          -> (logits (B,V), caches)
  decode_block(params, tokens, caches, cfg)        -> (logits (B,k,V), caches)

Decode updates the cache tensors in place (the JAX package donates them)
and returns a new top-level dict with ``pos`` advanced.  Other block kinds,
sliding windows and frontends raise.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import torch_dtype

from . import attention as attn_lib
from .config import ATTN, ModelConfig
from .layers import apply_mlp, apply_norm, dense_init, init_norm, truncated_normal


def check_supported(cfg: ModelConfig) -> None:
    if (set(cfg.block_pattern) != {ATTN} or cfg.sliding_window > 0 or cfg.enc_layers
            or cfg.frontend != "none" or cfg.num_prefix_tokens):
        raise NotImplementedError(
            f"{cfg.name}: only decoder-only global-attention (ATTN) stacks are ported")


# ----------------------------------------------------------------- init

def init_block(cfg: ModelConfig, generator, device):
    d, ff = cfg.d_model, cfg.d_ff
    dt = torch_dtype(cfg.dtype)
    if cfg.mlp_type == "swiglu":
        mlp = {"w_gate_up": torch.cat([dense_init((d, ff), dt, generator, device),
                                       dense_init((d, ff), dt, generator, device)], dim=-1)}
    else:
        mlp = {"w_up": dense_init((d, ff), dt, generator, device)}
    mlp["w_down"] = dense_init((ff, d), dt, generator, device, stddev=ff ** -0.5)
    return {"norm1": init_norm(d, cfg.norm_type, device),
            "attn": attn_lib.init_attention(cfg, generator, device),
            "norm2": init_norm(d, cfg.norm_type, device),
            "mlp": mlp}


def init_lm(cfg: ModelConfig, generator: torch.Generator, device):
    """Random weights drawn on ``device`` from ``generator``."""
    check_supported(cfg)
    dt = torch_dtype(cfg.dtype)
    params = {"embed": truncated_normal((cfg.padded_vocab, cfg.d_model), 0.02, dt,
                                        generator, device),
              "final_norm": init_norm(cfg.d_model, cfg.norm_type, device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = truncated_normal((cfg.d_model, cfg.padded_vocab),
                                             cfg.d_model ** -0.5, dt, generator, device)
    params["layers"] = [init_block(cfg, generator, device) for _ in range(cfg.num_layers)]
    return params


def init_caches(batch: int, capacity: int, cfg: ModelConfig, device):
    check_supported(cfg)
    return {"scan": (attn_lib.init_kv_cache(cfg.num_layers, batch, capacity, cfg, device),),
            "rem": (), "pos": 0}


# ----------------------------------------------------------------- stack

def _mlp_residual(p, x, cfg: ModelConfig):
    return x + apply_mlp(p["mlp"], apply_norm(p["norm2"], x, cfg.norm_type), cfg.mlp_type)


def _logits(params, x, cfg: ModelConfig):
    x = apply_norm(params["final_norm"], x, cfg.norm_type)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = (x @ w).float()
    if cfg.logits_softcap > 0:
        c = cfg.logits_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def _block_train(p, x, positions, cfg: ModelConfig):
    """One block over the full sequence, making no KV cache."""
    a, _ = attn_lib.self_attention(p["attn"], apply_norm(p["norm1"], x, cfg.norm_type),
                                   positions, cfg)
    return _mlp_residual(p, x + a, cfg)


def _run_stack_train(params, x, positions, cfg: ModelConfig):
    """The blocks in order; with ``cfg.remat`` each is recomputed in the
    backward and saves nothing but its input (the reference's
    ``nothing_saveable`` remat of each scanned period, one block here).
    Returns (x, aux): an ATTN stack has no auxiliary loss."""
    for p in params["layers"]:
        if cfg.remat:
            x = checkpoint(_block_train, p, x, positions, cfg, use_reentrant=False)
        else:
            x = _block_train(p, x, positions, cfg)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def forward(params, tokens, cfg: ModelConfig):
    """Training forward: tokens (B,S) -> (fp32 logits (B,S,V_padded), aux)."""
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b, s)
    x, aux = _run_stack_train(params, params["embed"][tokens], positions.contiguous(), cfg)
    return _logits(params, x, cfg), aux


def cross_entropy(logits, targets, mask, vocab_size: int):
    """Mean next-token CE over the ``mask``ed positions, over the first
    ``vocab_size`` entries of the padded vocabulary: the tail is masked out
    of the log-sum-exp with -1e30, its max taken without gradient, and the
    target logit read by comparison with the vocabulary index (the
    reference's form, which never gathers along the vocabulary)."""
    iota = torch.arange(logits.shape[-1], device=logits.device)
    masked = torch.where(iota < vocab_size, logits,
                         torch.full((), -1e30, dtype=logits.dtype, device=logits.device))
    m = masked.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(masked - m), dim=-1)) + m[..., 0]
    tgt = torch.sum(torch.where(iota == targets[..., None], logits,
                                torch.zeros((), dtype=logits.dtype, device=logits.device)),
                    dim=-1)
    return torch.sum((lse - tgt) * mask) / torch.clamp(torch.sum(mask), min=1.0)


def loss_fn(params, tokens, targets, mask, cfg: ModelConfig):
    """Next-token CE in fp32 over the exact (unpadded) vocabulary.
    Returns (loss, {"ce", "aux", "tokens"})."""
    logits, aux = forward(params, tokens, cfg)
    ce = cross_entropy(logits, targets, mask, cfg.vocab_size)
    return ce + aux, {"ce": ce, "aux": aux, "tokens": torch.sum(mask).to(torch.int32)}


def prefill(params, tokens, cfg: ModelConfig, capacity: int, prefix=None):
    """tokens (B,S) -> (last-token logits (B,V) fp32, caches).

    With ``prefix`` (the caches of a prefix-only prefill), ``tokens`` are
    the suffix: positions continue from ``prefix["pos"]``, every layer
    attends over ``[prefix KV | suffix]``, and the caches cover ``[0, P+S)``
    as a prefill of the concatenation would.
    """
    b, s = tokens.shape
    device = tokens.device
    start = 0 if prefix is None else prefix["pos"]
    positions = (torch.arange(s, dtype=torch.int32, device=device) + start).expand(b, s)
    positions = positions.contiguous()
    caches = init_caches(b, capacity, cfg, device)
    kv = caches["scan"][0]
    pre = None if prefix is None else prefix["scan"][0]
    x = params["embed"][tokens]
    for i, p in enumerate(params["layers"]):
        layer_prefix = None if pre is None else {
            "k": pre["k"][i], "v": pre["v"][i], "slot_pos": pre["slot_pos"][i]}
        a, (k, v, k_pos) = attn_lib.self_attention(
            p["attn"], apply_norm(p["norm1"], x, cfg.norm_type), positions, cfg,
            prefix=layer_prefix)
        if k.shape[1] > capacity:
            raise ValueError(f"prefill of {k.shape[1]} tokens exceeds capacity {capacity}")
        attn_lib.fill_kv_cache(kv, i, k, v, k_pos)
        x = _mlp_residual(p, x + a, cfg)
    caches["pos"] = start + s
    return _logits(params, x[:, -1:], cfg)[:, 0], caches


def decode_step(params, token, caches, cfg: ModelConfig):
    """token (B,) int -> (logits (B,V) fp32, caches with ``pos`` + 1).

    Dense caches carry a host-int ``pos``; paged caches a per-row one."""
    b = token.shape[0]
    pos = caches["pos"]
    kv = caches["scan"][0]
    if "kp" in kv:
        plan = attn_lib.write_plan(kv, pos, 1, block=False)
        cache_len = None
    else:
        if torch.is_tensor(pos):
            raise ValueError("dense decode_step takes a host-int pos; per-row caches "
                             "decode through decode_block")
        plan = None
        cache_len = torch.full((b,), pos + 1, dtype=torch.int32, device=token.device)
    x = params["embed"][token[:, None]]
    for i, p in enumerate(params["layers"]):
        a = attn_lib.decode_attention(p["attn"], apply_norm(p["norm1"], x, cfg.norm_type),
                                      kv, i, pos, cache_len, cfg, plan=plan)
        x = _mlp_residual(p, x + a, cfg)
    return _logits(params, x, cfg)[:, 0], {"scan": caches["scan"], "rem": (), "pos": pos + 1}


def decode_block(params, tokens, caches, cfg: ModelConfig):
    """tokens (B,k) verify block -> (logits (B,k,V) fp32, caches with ``pos``
    + k).  ``logits[:, i]`` is the next-token distribution after
    ``tokens[:, :i+1]`` on top of the cache.  Needs per-row positions
    (``paged_kv.row_pos_caches``); the caller rewinds rejected tokens."""
    pos = caches["pos"]
    if not torch.is_tensor(pos):
        raise ValueError("decode_block needs per-row (B,) positions: convert the "
                         "caches with serving.paged_kv.row_pos_caches")
    kv = caches["scan"][0]
    plan = attn_lib.write_plan(kv, pos, tokens.shape[1], block=True)
    x = params["embed"][tokens]
    for i, p in enumerate(params["layers"]):
        a = attn_lib.decode_attention_block(
            p["attn"], apply_norm(p["norm1"], x, cfg.norm_type), kv, i, pos, plan, cfg)
        x = _mlp_residual(p, x + a, cfg)
    return _logits(params, x, cfg), {"scan": caches["scan"], "rem": (),
                                     "pos": pos + tokens.shape[1]}
