"""Decoder-only LM (counterpart of ``src/repro/models/transformer.py``):
attention blocks, global or sliding-window (ATTN, LOCAL_ATTN), MoE blocks
(MOE) and the recurrent blocks, Mamba-2 (MAMBA2) and RG-LRU (RGLRU), in
any pattern.

Parameters are a dict: ``embed`` (V,d), ``final_norm``, ``lm_head`` (d,V)
unless tied, and ``layers``, one dict per block in the reference's layer
order (``cfg.pattern_periods`` periods of ``cfg.block_pattern``, then
``cfg.pattern_remainder``).  An attention block holds ``norm1``, ``attn``,
``norm2`` and its FFN, ``mlp`` or ``moe`` (``models.moe``); a MAMBA2 block
``norm1`` and ``mixer`` (``models.ssm``), with no FFN; an RGLRU block
``norm1``, ``rec`` (``models.rglru``), ``norm2`` and ``mlp``.

Caches keep the reference's ``{"scan", "rem", "pos"}`` structure:
``scan[j]`` stacks, over the periods, the caches of the layers at pattern
position j, and ``rem[i]`` is remainder layer i's (unstacked).  An ATTN or
MOE stack is one pattern position, so ``scan[0]`` stacks every layer's KV
and ``rem`` is empty.  A recurrent layer's cache is its state: ``{"ssm",
"conv"}`` (MAMBA2) or ``{"h", "conv"}`` (RGLRU).  An attention layer's is
its KV, in one of two forms:

* dense (prefill's): ``k``/``v`` (L,B,T,Hk,dh), ``slot_pos`` (L,B,T), and
  ``pos`` (the tokens already in the cache) a host integer, so the dense
  decode step needs no device round trip to place the next token.  A
  sliding-window layer's cache is a ring of ``min(capacity, window)``
  slots (the reference's ``_cache_capacity``): slot ``pos % cap`` takes
  position ``pos``, and a prompt longer than the ring is laid out in the
  reference's ring order;
* per-row: ``pos`` a (B,) int32 device tensor, for paged caches
  (``serving.paged_kv``) and for block (speculative) decode, whose rows
  advance by different amounts (``paged_kv.row_pos_caches`` converts).
  Only ATTN and MOE stacks without a window take this form.

  forward(params, tokens, cfg[, prefix_embeds])    -> (logits (B,S,V), aux)  (training)
  loss_fn(params, tokens, targets, mask, cfg[, prefix_embeds]) -> (loss, metrics)
  prefill(params, tokens, cfg, capacity[, prefix | prefix_embeds])
                                                   -> (last logits (B,V), caches)
  decode_step(params, token, caches, cfg)          -> (logits (B,V), caches)
  decode_block(params, tokens, caches, cfg)        -> (logits (B,k,V), caches)

A MOE block's output depends on the other tokens of its dispatch group
(capacity drops), so a prefill, a decode step and a verify block each route
the tokens they are given, as the reference's do; ``aux`` (the summed
load-balance losses) is kept by the training forward only.  Decode updates
the KV and the recurrent states in place (the JAX package donates them)
and returns a new top-level dict with ``pos`` advanced.  The decode step of
an ATTN or MOE stack keeps its own loop, with no per-layer dispatch on the
block kind.  The paged, block and prefix paths of a windowed or recurrent
stack raise, as the reference's do; encoder-decoder configs are built by
``models.encdec``.

A frontend config (``cfg.frontend != "none"``, internvl2's vision stub)
has ``frontend_proj`` (frontend_dim, d): ``forward``, ``loss_fn`` and
``prefill`` take ``prefix_embeds`` (B,P,frontend_dim), projected and put in
front of the token embeddings at positions [0, P) (the tokens at [P, P+S));
the loss drops the first P logits.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import torch_dtype

from . import attention as attn_lib
from . import moe as moe_lib
from . import rglru as rglru_lib
from . import sharding_utils as shu
from . import ssm as ssm_lib
from .config import ATTN, LOCAL_ATTN, MAMBA2, MOE, RGLRU, ModelConfig
from .layers import apply_mlp, apply_norm, init_mlp, init_norm, truncated_normal

KV_KINDS = (ATTN, LOCAL_ATTN, MOE)      # blocks whose cache is KV
RECURRENT = (MAMBA2, RGLRU)             # blocks whose cache is a state


def check_supported(cfg: ModelConfig) -> None:
    kinds = set(cfg.block_pattern) | set(cfg.pattern_remainder)
    if not kinds <= set(KV_KINDS + RECURRENT):
        raise NotImplementedError(
            f"{cfg.name}: only stacks of ATTN, LOCAL_ATTN, MOE, MAMBA2 and RGLRU blocks "
            f"are ported")
    if cfg.enc_layers:
        raise ValueError(f"{cfg.name}: an encoder-decoder config is built by models.encdec")


def cache_capacity(cfg: ModelConfig, capacity: int) -> int:
    """KV slots a layer keeps: a sliding window keeps at most its width
    (the reference's ``_cache_capacity``)."""
    return min(capacity, cfg.sliding_window) if cfg.sliding_window > 0 else capacity


@functools.lru_cache(maxsize=None)
def layer_slots(cfg: ModelConfig):
    """(kind, group, j, index) of each layer, in layer order: the periods of
    the pattern, then the remainder.  A pattern layer's cache is period
    ``index`` of ``caches["scan"][j]``; remainder layer j's is
    ``caches["rem"][j]`` (index None)."""
    out = [(kind, "scan", j, period) for period in range(cfg.pattern_periods)
           for j, kind in enumerate(cfg.block_pattern)]
    return tuple(out + [(kind, "rem", j, None) for j, kind in enumerate(cfg.pattern_remainder)])


def attention_layers(cfg: ModelConfig) -> int:
    """The layers whose cache is KV: each launches the prefill kernel once a
    prefill and the decode kernel once a step (0 in an attention-free
    stack)."""
    return sum(kind in KV_KINDS for kind, *_ in layer_slots(cfg))


def kv_only(cfg: ModelConfig) -> bool:
    """An ATTN or MOE stack: one pattern position, every layer's KV in
    ``scan[0]`` at the layer's index."""
    return len(cfg.block_pattern) == 1 and cfg.block_pattern[0] in (ATTN, MOE)


def layer_cache(caches, slot):
    """One layer's cache: for an attention layer (KV stacked over layers,
    the layer's index in it), a remainder layer's unstacked KV given a
    leading axis of 1 (views); for a recurrent layer its state, as views
    into the stack.  Writes into either land in ``caches``."""
    kind, group, j, index = slot
    c = caches[group][j]
    if kind in KV_KINDS:
        return (c, index) if index is not None else ({k: t[None] for k, t in c.items()}, 0)
    return c if index is None else {k: t[index] for k, t in c.items()}


# ----------------------------------------------------------------- init

def init_block(kind: str, cfg: ModelConfig, generator, device):
    """One block of ``kind``: attention then an MLP (ATTN, LOCAL_ATTN) or
    the MoE (MOE); the Mamba-2 mixer alone (MAMBA2); the RG-LRU then an MLP
    (RGLRU)."""
    d, dt = cfg.d_model, torch_dtype(cfg.dtype)
    p = {"norm1": init_norm(d, cfg.norm_type, device)}
    if kind == MAMBA2:
        p["mixer"] = ssm_lib.init_mamba2(cfg, generator, device)
        return p
    if kind == RGLRU:
        p["rec"] = rglru_lib.init_rglru(cfg, generator, device)
    else:
        p["attn"] = attn_lib.init_attention(cfg, generator, device)
    p["norm2"] = init_norm(d, cfg.norm_type, device)
    if kind == MOE:
        p["moe"] = moe_lib.init_moe(cfg, generator, device)
    else:
        p["mlp"] = init_mlp(d, cfg.d_ff, cfg.mlp_type, dt, generator, device)
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
    if cfg.frontend != "none":
        params["frontend_proj"] = truncated_normal((cfg.frontend_dim, cfg.d_model),
                                                   cfg.frontend_dim ** -0.5, dt, generator,
                                                   device)
    params["layers"] = [init_block(kind, cfg, generator, device)
                        for kind, *_ in layer_slots(cfg)]
    return params


def _init_block_cache(kind: str, lead, batch: int, capacity: int, cfg: ModelConfig, device):
    """A zero cache of ``kind`` with leading dims ``lead`` (the periods of a
    pattern position, or none for a remainder layer)."""
    if kind == MAMBA2:
        return ssm_lib.init_mamba2_state(batch, cfg, device, lead)
    if kind == RGLRU:
        return rglru_lib.init_rglru_state(batch, cfg, device, lead)
    kv = attn_lib.init_kv_cache(lead[0] if lead else 1, batch, cache_capacity(cfg, capacity),
                                cfg, device)
    return kv if lead else {k: t[0] for k, t in kv.items()}


def init_caches(batch: int, capacity: int, cfg: ModelConfig, device):
    check_supported(cfg)
    periods = (cfg.pattern_periods,)
    return {"scan": tuple(_init_block_cache(kind, periods, batch, capacity, cfg, device)
                          for kind in cfg.block_pattern),
            "rem": tuple(_init_block_cache(kind, (), batch, capacity, cfg, device)
                         for kind in cfg.pattern_remainder),
            "pos": 0}


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
    logits = shu.constrain(x @ w, shu.BATCH, None, "model").float()
    if cfg.logits_softcap > 0:
        c = cfg.logits_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def _after_mixer(kind: str, p, x, cfg: ModelConfig):
    """x (the mixer's residual added) through the rest of the block: the FFN
    residual, except in a MAMBA2 block, which has none.  Returns (x, aux)."""
    return (x, None) if kind == MAMBA2 else _ffn_residual(p, x, cfg)


def _recurrent(kind: str, p, h, cfg: ModelConfig, state=None):
    """A recurrent block's mixer of h: over the whole sequence from a zero
    state (``state`` None), or one decode step from ``state``.  Returns
    (y, the new state)."""
    if kind == MAMBA2:
        if state is None:
            return ssm_lib.mamba2_forward(p["mixer"], h, cfg)
        return ssm_lib.mamba2_decode(p["mixer"], h, state, cfg)
    if state is None:
        return rglru_lib.rglru_forward(p["rec"], h, cfg)
    return rglru_lib.rglru_decode(p["rec"], h, state, cfg)


def _block_train(kind: str, p, x, positions, cfg: ModelConfig):
    """One block over the full sequence, making no cache: (x, aux)."""
    h = apply_norm(p["norm1"], x, cfg.norm_type)
    if kind in RECURRENT:
        y, _ = _recurrent(kind, p, h, cfg)
    else:
        y, _ = attn_lib.self_attention(p["attn"], h, positions, cfg, window=cfg.sliding_window)
    return _after_mixer(kind, p, x + y, cfg)


def _run_stack_train(params, x, positions, cfg: ModelConfig):
    """The blocks in order; with ``cfg.remat`` each is recomputed in the
    backward and saves nothing but its input (the reference's
    ``nothing_saveable`` remat of each scanned period, one block here).
    Returns (x, aux): the MoE blocks' losses summed in layer order (0 for
    a stack without MoE)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p, (kind, *_) in zip(params["layers"], layer_slots(cfg)):
        if cfg.remat:
            x, a = checkpoint(_block_train, kind, p, x, positions, cfg, use_reentrant=False)
        else:
            x, a = _block_train(kind, p, x, positions, cfg)
        if a is not None:
            aux = aux + a
    return x, aux


def _embed_inputs(params, tokens, cfg: ModelConfig, prefix_embeds=None, start: int = 0):
    """(x (B,P+S,d), positions (B,P+S) int32 from ``start``): the token
    embeddings, after ``prefix_embeds`` (B,P,frontend_dim) cast to the model
    dtype and projected by ``frontend_proj`` when given."""
    x = params["embed"][tokens]
    if prefix_embeds is not None:
        pe = prefix_embeds.to(x.dtype) @ params["frontend_proj"]
        x = torch.cat([pe, x], dim=1)
    # the reference seeds GSPMD with batch-sharded activations here
    x = shu.constrain(x, shu.BATCH, None, None)
    b, s = x.shape[:2]
    positions = torch.arange(start, start + s, dtype=torch.int32, device=x.device)
    return x, positions.expand(b, s).contiguous()


def forward(params, tokens, cfg: ModelConfig, prefix_embeds=None):
    """Training forward: tokens (B,S) [and prefix_embeds (B,P,e)] -> (fp32
    logits (B,P+S,V_padded), aux)."""
    x, positions = _embed_inputs(params, tokens, cfg, prefix_embeds)
    x, aux = _run_stack_train(params, x, positions, cfg)
    return _logits(params, x, cfg), aux


def cross_entropy(logits, targets, mask, vocab_size: int):
    """Mean next-token CE over the ``mask``ed positions, over the first
    ``vocab_size`` entries of the padded vocabulary: the tail is masked out
    of the log-sum-exp with -1e30, its max taken without gradient, and the
    target logit read by comparison with the vocabulary index (the
    reference's form, which never gathers along the vocabulary)."""
    iota = torch.arange(logits.shape[-1], dtype=torch.int32, device=logits.device)
    masked = torch.where(iota < vocab_size, logits,
                         torch.full((), -1e30, dtype=logits.dtype, device=logits.device))
    m = masked.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(masked - m), dim=-1)) + m[..., 0]
    tgt = torch.sum(torch.where(iota == targets[..., None], logits,
                                torch.zeros((), dtype=logits.dtype, device=logits.device)),
                    dim=-1)
    return torch.sum((lse - tgt) * mask) / torch.clamp(torch.sum(mask), min=1.0)


def loss_fn(params, tokens, targets, mask, cfg: ModelConfig, prefix_embeds=None):
    """Next-token CE in fp32 over the exact (unpadded) vocabulary, over the
    token positions (the prefix's logits dropped).  Returns (loss, {"ce",
    "aux", "tokens"})."""
    logits, aux = forward(params, tokens, cfg, prefix_embeds)
    if prefix_embeds is not None:
        logits = logits[:, prefix_embeds.shape[1]:]
    ce = cross_entropy(logits, targets, mask, cfg.vocab_size)
    return ce + aux, {"ce": ce, "aux": aux, "tokens": torch.sum(mask).to(torch.int32)}


def _block_prefill(kind: str, p, x, positions, cache, cfg: ModelConfig, ring, prefix):
    """One block over the prompt, filling its cache in place: the recurrent
    state a layer ends with, or its K/V (``ring``: the token index each
    slot of a windowed ring keeps, when the prompt is longer than the
    ring).  ``prefix`` is the layer's stored prefix KV, or None."""
    h = apply_norm(p["norm1"], x, cfg.norm_type)
    if kind in RECURRENT:
        y, state = _recurrent(kind, p, h, cfg)
        for leaf, t in state.items():
            cache[leaf].copy_(t)
        return _after_mixer(kind, p, x + y, cfg)[0]
    kv, index = cache
    a, (k, v, k_pos) = attn_lib.self_attention(p["attn"], h, positions, cfg,
                                               window=cfg.sliding_window, prefix=prefix)
    if k.shape[1] <= kv["k"].shape[2]:
        attn_lib.fill_kv_cache(kv, index, k, v, k_pos)
    elif ring is not None:
        attn_lib.fill_kv_cache(kv, index, k[:, ring], v[:, ring], k_pos[:, ring])
    else:
        raise ValueError(f"prefill of {k.shape[1]} tokens exceeds capacity {kv['k'].shape[2]}")
    return _ffn_residual(p, x + a, cfg)[0]


def prefill(params, tokens, cfg: ModelConfig, capacity: int, prefix=None,
            prefix_embeds=None):
    """tokens (B,S) -> (last-token logits (B,V) fp32, caches).

    With ``prefix_embeds`` (B,P,frontend_dim) the projected embeddings come
    first, at positions [0, P), and the caches cover P+S positions.

    With ``prefix`` (the caches of a prefix-only prefill), ``tokens`` are
    the suffix: positions continue from ``prefix["pos"]``, every layer
    attends over ``[prefix KV | suffix]``, and the caches cover ``[0, P+S)``
    as a prefill of the concatenation would (ATTN and MOE stacks with
    global attention only).

    A windowed layer attends within its window; when the prompt is longer
    than its ring it keeps the last ``cap`` tokens, token j in slot ``j %
    cap`` (the reference's ``slot_of``), so decode continues the ring.  A
    recurrent layer keeps the state it ends the prompt with.
    """
    window = cfg.sliding_window
    if prefix is not None and (window > 0 or not kv_only(cfg)):
        raise NotImplementedError("prefix-cached prefill is global-attention only; windowed "
                                  "and recurrent stacks must fall back to full prefill")
    if prefix is not None and prefix_embeds is not None:
        raise NotImplementedError("prefix-cached prefill with frontend prefix_embeds")
    start = 0 if prefix is None else prefix["pos"]
    x, positions = _embed_inputs(params, tokens, cfg, prefix_embeds, start)
    b, s = x.shape[:2]
    device = tokens.device
    caches = init_caches(b, capacity, cfg, device)
    cap = cache_capacity(cfg, capacity)
    ring = None
    if window > 0 and s > cap:     # the token index each slot keeps
        first = s - cap
        ring = first + (torch.arange(cap, device=device) - first) % cap
    for p, slot in zip(params["layers"], layer_slots(cfg)):
        layer_prefix = None
        if prefix is not None:
            pre, index = layer_cache(prefix, slot)
            layer_prefix = {leaf: pre[leaf][index] for leaf in ("k", "v", "slot_pos")}
        x = _block_prefill(slot[0], p, x, positions, layer_cache(caches, slot), cfg, ring,
                           layer_prefix)
    caches["pos"] = start + s
    return _logits(params, x[:, -1:], cfg)[:, 0], caches


def decode_step(params, token, caches, cfg: ModelConfig):
    """token (B,) int -> (logits (B,V) fp32, caches with ``pos`` + 1).

    Dense caches carry a host-int ``pos``; paged caches a per-row one.  A
    windowed stack's ring keeps ``t < min(pos + 1, cap)`` (the argument is
    in ``attention.decode_attention``).  A stack with recurrent or
    LOCAL_ATTN blocks decodes in ``_decode_step_mixed``."""
    if not kv_only(cfg):
        return _decode_step_mixed(params, token, caches, cfg)
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
    x = shu.constrain(params["embed"][token[:, None]], shu.BATCH, None, None)
    for i, p in enumerate(params["layers"]):
        a = attn_lib.decode_attention(p["attn"], apply_norm(p["norm1"], x, cfg.norm_type),
                                      kv, i, pos, cache_len, cfg, window=window, plan=plan)
        x, _ = _ffn_residual(p, x + a, cfg)
    return _logits(params, x, cfg)[:, 0], {"scan": caches["scan"], "rem": (), "pos": pos + 1}


def _decode_step_mixed(params, token, caches, cfg: ModelConfig):
    """The dense decode step of a stack of several block kinds: each layer
    in the reference's order, its state or KV updated in place."""
    pos = caches["pos"]
    if torch.is_tensor(pos):
        raise ValueError("a recurrent or mixed stack decodes over dense caches with a "
                         "host-int pos")
    window = cfg.sliding_window
    cache_len = None
    x = shu.constrain(params["embed"][token[:, None]], shu.BATCH, None, None)
    for p, slot in zip(params["layers"], layer_slots(cfg)):
        kind = slot[0]
        cache = layer_cache(caches, slot)
        h = apply_norm(p["norm1"], x, cfg.norm_type)
        if kind in RECURRENT:
            y, state = _recurrent(kind, p, h, cfg, cache)
            for leaf, t in state.items():
                cache[leaf].copy_(t)
        else:
            kv, index = cache
            if cache_len is None:      # the same for every attention layer of the step
                filled = min(pos + 1, kv["k"].shape[2]) if window > 0 else pos + 1
                cache_len = torch.full((token.shape[0],), filled, dtype=torch.int32,
                                       device=token.device)
            y = attn_lib.decode_attention(p["attn"], h, kv, index, pos, cache_len, cfg,
                                          window=window)
        x, _ = _after_mixer(kind, p, x + y, cfg)
    return _logits(params, x, cfg)[:, 0], {"scan": caches["scan"], "rem": caches["rem"],
                                           "pos": pos + 1}


def decode_block(params, tokens, caches, cfg: ModelConfig):
    """tokens (B,k) verify block -> (logits (B,k,V) fp32, caches with ``pos``
    + k).  ``logits[:, i]`` is the next-token distribution after
    ``tokens[:, :i+1]`` on top of the cache.  Needs per-row positions
    (``paged_kv.row_pos_caches``); the caller rewinds rejected tokens."""
    if cfg.sliding_window > 0 or not kv_only(cfg):
        raise ValueError("block decode requires global-attention KV layers: a windowed "
                         "ring buffer overwrites slots a rewind would need back, and a "
                         "recurrent state cannot rewind")
    pos = caches["pos"]
    if not torch.is_tensor(pos):
        raise ValueError("decode_block needs per-row (B,) positions: convert the "
                         "caches with serving.paged_kv.row_pos_caches")
    kv = caches["scan"][0]
    plan = attn_lib.write_plan(kv, pos, tokens.shape[1], block=True)
    x = shu.constrain(params["embed"][tokens], shu.BATCH, None, None)
    for i, p in enumerate(params["layers"]):
        a = attn_lib.decode_attention_block(
            p["attn"], apply_norm(p["norm1"], x, cfg.norm_type), kv, i, pos, plan, cfg)
        x, _ = _ffn_residual(p, x + a, cfg)
    return _logits(params, x, cfg), {"scan": caches["scan"], "rem": (),
                                     "pos": pos + tokens.shape[1]}
