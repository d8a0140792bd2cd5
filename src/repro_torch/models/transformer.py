"""Decoder-only LM of attention blocks (the ATTN and MOE stacks of
``src/repro/models/transformer.py``), global or sliding-window.

Parameters are a dict: ``embed`` (V,d), ``final_norm``, ``lm_head`` (d,V)
unless tied, and ``layers``, one dict per block: ``norm1``, ``attn``,
``norm2`` and the FFN, ``mlp`` in an ATTN block or ``moe`` in a MOE block
(``models.moe``).  A stack is of one kind, ATTN or MOE: no reference config
mixes the two, and a mixed pattern would need the reference's per-position
cache stacks (``scan[j]``).  Caches keep the JAX package's ``{"scan", "rem",
"pos"}`` structure: ``scan[0]`` stacks every layer's KV, ``rem`` is empty.
Two forms:

* dense (prefill's): ``k``/``v`` (L,B,T,Hk,dh), ``slot_pos`` (L,B,T), and
  ``pos`` (the tokens already in the cache) a host integer, so the dense
  decode step needs no device round trip to place the next token.  A
  sliding-window stack's cache is a ring of ``min(capacity, window)``
  slots (the reference's ``_cache_capacity``): slot ``pos % cap`` takes
  position ``pos``, and a prompt longer than the ring is laid out in the
  reference's ring order;
* per-row: ``pos`` a (B,) int32 device tensor, for paged caches
  (``serving.paged_kv``) and for block (speculative) decode, whose rows
  advance by different amounts (``paged_kv.row_pos_caches`` converts).

  forward(params, tokens, cfg)                     -> (logits (B,S,V), aux)  (training)
  loss_fn(params, tokens, targets, mask, cfg)      -> (loss, metrics)
  prefill(params, tokens, cfg, capacity[, prefix]) -> (last logits (B,V), caches)
  decode_step(params, token, caches, cfg)          -> (logits (B,V), caches)
  decode_block(params, tokens, caches, cfg)        -> (logits (B,k,V), caches)

A MOE block's output depends on the other tokens of its dispatch group
(capacity drops), so a prefill, a decode step and a verify block each route
the tokens they are given, as the reference's do; ``aux`` (the summed
load-balance losses) is kept by the training forward only.  Decode updates
the cache tensors in place (the JAX package donates them) and returns a new
top-level dict with ``pos`` advanced.  Other block kinds and frontends
raise, and so do the paged, block and prefix paths of a windowed stack, as
the reference's do.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import torch_dtype

from . import attention as attn_lib
from . import moe as moe_lib
from .config import ATTN, MOE, ModelConfig
from .layers import apply_mlp, apply_norm, init_mlp, init_norm, truncated_normal


def check_supported(cfg: ModelConfig) -> None:
    if (set(cfg.block_pattern) not in ({ATTN}, {MOE}) or cfg.enc_layers
            or cfg.frontend != "none" or cfg.num_prefix_tokens):
        raise NotImplementedError(
            f"{cfg.name}: only decoder-only stacks of attention (ATTN) or MoE (MOE) "
            f"blocks are ported")


def cache_capacity(cfg: ModelConfig, capacity: int) -> int:
    """KV slots a layer keeps: a sliding window keeps at most its width
    (the reference's ``_cache_capacity``)."""
    return min(capacity, cfg.sliding_window) if cfg.sliding_window > 0 else capacity


# ----------------------------------------------------------------- init

def init_block(cfg: ModelConfig, generator, device):
    """One block of the stack's kind: attention, then an MLP (ATTN) or the
    MoE (MOE)."""
    d = cfg.d_model
    p = {"norm1": init_norm(d, cfg.norm_type, device),
         "attn": attn_lib.init_attention(cfg, generator, device),
         "norm2": init_norm(d, cfg.norm_type, device)}
    if cfg.block_pattern[0] == MOE:
        p["moe"] = moe_lib.init_moe(cfg, generator, device)
    else:
        p["mlp"] = init_mlp(d, cfg.d_ff, cfg.mlp_type, torch_dtype(cfg.dtype), generator,
                            device)
    return p


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
    return {"scan": (attn_lib.init_kv_cache(cfg.num_layers, batch,
                                            cache_capacity(cfg, capacity), cfg, device),),
            "rem": (), "pos": 0}


# ----------------------------------------------------------------- stack

def _ffn_residual(p, x, cfg: ModelConfig):
    """x + the block's FFN of norm2(x).  Returns (x, aux): the MoE's scaled
    load-balance loss, None for an MLP."""
    h = apply_norm(p["norm2"], x, cfg.norm_type)
    if "moe" in p:
        m, aux = moe_lib.apply_moe(p["moe"], h, cfg)
        return x + m, aux
    return x + apply_mlp(p["mlp"], h, cfg.mlp_type), None


def _logits(params, x, cfg: ModelConfig):
    x = apply_norm(params["final_norm"], x, cfg.norm_type)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = (x @ w).float()
    if cfg.logits_softcap > 0:
        c = cfg.logits_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def _block_train(p, x, positions, cfg: ModelConfig):
    """One block over the full sequence, making no KV cache: (x, aux)."""
    a, _ = attn_lib.self_attention(p["attn"], apply_norm(p["norm1"], x, cfg.norm_type),
                                   positions, cfg, window=cfg.sliding_window)
    return _ffn_residual(p, x + a, cfg)


def _run_stack_train(params, x, positions, cfg: ModelConfig):
    """The blocks in order; with ``cfg.remat`` each is recomputed in the
    backward and saves nothing but its input (the reference's
    ``nothing_saveable`` remat of each scanned period, one block here).
    Returns (x, aux): the MoE blocks' losses summed in layer order (0 for
    an ATTN stack)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p in params["layers"]:
        if cfg.remat:
            x, a = checkpoint(_block_train, p, x, positions, cfg, use_reentrant=False)
        else:
            x, a = _block_train(p, x, positions, cfg)
        if a is not None:
            aux = aux + a
    return x, aux


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
    as a prefill of the concatenation would (global attention only).

    A windowed stack attends within its window; when the prompt is longer
    than its ring it keeps the last ``cap`` tokens, token j in slot ``j %
    cap`` (the reference's ``slot_of``), so decode continues the ring.
    """
    window = cfg.sliding_window
    if prefix is not None and window > 0:
        raise NotImplementedError("prefix-cached prefill is global-attention only; windowed "
                                  "stacks must fall back to full prefill")
    b, s = tokens.shape
    device = tokens.device
    start = 0 if prefix is None else prefix["pos"]
    positions = (torch.arange(s, dtype=torch.int32, device=device) + start).expand(b, s)
    positions = positions.contiguous()
    caches = init_caches(b, capacity, cfg, device)
    kv = caches["scan"][0]
    cap = kv["k"].shape[2]
    ring = None
    if window > 0 and s > cap:     # the token index each slot keeps
        first = s - cap
        ring = first + (torch.arange(cap, device=device) - first) % cap
    pre = None if prefix is None else prefix["scan"][0]
    x = params["embed"][tokens]
    for i, p in enumerate(params["layers"]):
        layer_prefix = None if pre is None else {
            "k": pre["k"][i], "v": pre["v"][i], "slot_pos": pre["slot_pos"][i]}
        a, (k, v, k_pos) = attn_lib.self_attention(
            p["attn"], apply_norm(p["norm1"], x, cfg.norm_type), positions, cfg,
            window=window, prefix=layer_prefix)
        if k.shape[1] <= cap:
            attn_lib.fill_kv_cache(kv, i, k, v, k_pos)
        elif window > 0:
            attn_lib.fill_kv_cache(kv, i, k[:, ring], v[:, ring], k_pos[:, ring])
        else:
            raise ValueError(f"prefill of {k.shape[1]} tokens exceeds capacity {capacity}")
        x, _ = _ffn_residual(p, x + a, cfg)
    caches["pos"] = start + s
    return _logits(params, x[:, -1:], cfg)[:, 0], caches


def decode_step(params, token, caches, cfg: ModelConfig):
    """token (B,) int -> (logits (B,V) fp32, caches with ``pos`` + 1).

    Dense caches carry a host-int ``pos``; paged caches a per-row one.  A
    windowed stack's ring keeps ``t < min(pos + 1, cap)`` (the argument is
    in ``attention.decode_attention``)."""
    b = token.shape[0]
    pos = caches["pos"]
    kv = caches["scan"][0]
    window = cfg.sliding_window
    if "kp" in kv:
        if window > 0:
            raise NotImplementedError("paged KV decode is global-attention only; windowed "
                                      "stacks must use the dense ring-buffered cache")
        plan = attn_lib.write_plan(kv, pos, 1, block=False)
        cache_len = None
    else:
        if torch.is_tensor(pos):
            raise ValueError("dense decode_step takes a host-int pos; per-row caches "
                             "decode through decode_block")
        plan = None
        filled = min(pos + 1, kv["k"].shape[2]) if window > 0 else pos + 1
        cache_len = torch.full((b,), filled, dtype=torch.int32, device=token.device)
    x = params["embed"][token[:, None]]
    for i, p in enumerate(params["layers"]):
        a = attn_lib.decode_attention(p["attn"], apply_norm(p["norm1"], x, cfg.norm_type),
                                      kv, i, pos, cache_len, cfg, window=window, plan=plan)
        x, _ = _ffn_residual(p, x + a, cfg)
    return _logits(params, x, cfg)[:, 0], {"scan": caches["scan"], "rem": (), "pos": pos + 1}


def decode_block(params, tokens, caches, cfg: ModelConfig):
    """tokens (B,k) verify block -> (logits (B,k,V) fp32, caches with ``pos``
    + k).  ``logits[:, i]`` is the next-token distribution after
    ``tokens[:, :i+1]`` on top of the cache.  Needs per-row positions
    (``paged_kv.row_pos_caches``); the caller rewinds rejected tokens."""
    if cfg.sliding_window > 0:
        raise ValueError("block decode requires global-attention KV layers: a windowed "
                         "ring buffer overwrites slots a rewind would need back")
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
        x, _ = _ffn_residual(p, x + a, cfg)
    return _logits(params, x, cfg), {"scan": caches["scan"], "rem": (),
                                     "pos": pos + tokens.shape[1]}
