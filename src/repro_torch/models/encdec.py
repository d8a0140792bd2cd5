"""Whisper-style encoder-decoder (counterpart of ``src/repro/models/encdec.py``).

The mel-spectrogram and conv feature extractor are the reference's stub:
the caller supplies post-conv frame embeddings (B, F, d_model).  Sinusoidal
positions are added to the frames and to the decoder's token embeddings (no
rotary embeddings); the encoder is bidirectional, the decoder causal with
cross attention over the encoder's memory; the output head is tied to
``embed``.

Parameters: ``embed`` (V,d), ``enc_norm``, ``final_norm``, ``enc_layers``
(``norm1``, ``attn``, ``norm2``, ``mlp`` each) and ``dec_layers``
(``norm1``, ``self_attn``, ``norm2``, ``cross_attn``, ``norm3``, ``mlp``),
one dict per layer; ``checkpoint.convert`` maps them to the reference's
``enc_scan`` / ``dec_scan`` stacks.  There is no ``frontend_proj``.

Caches keep the reference's structure: ``self`` the decoder's stacked KV
(``k``/``v`` (L,B,T,Hk,dh), ``slot_pos`` (L,B,T)), ``cross_k`` /
``cross_v`` (L,B,F,Hk,dh) projected once by ``prefill``, and ``pos`` a host
integer.  Prefill attention runs the flash kernel (the encoder non-causal,
the decoder causal, cross attention non-causal at positions 0); a decode
step runs the dense decode kernel twice a layer, over its self cache and
over its cross K/V with every one of the F keys kept (where the reference
uses its naive composite).  No paged, block or prefix path: the reference's
capability flags are False for an encoder-decoder.

  encode(params, frames, cfg)                         -> memory (B,F,d)
  forward(params, frames, tokens, cfg)                -> (logits (B,S,V), aux 0)
  prefill(params, frames, tokens, cfg, capacity)      -> (last logits (B,V), caches)
  decode_step(params, token, caches, cfg)             -> (logits (B,V), caches)
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import torch_dtype

from . import attention as attn_lib
from . import sharding_utils as shu
from .config import ModelConfig
from .layers import (apply_mlp, apply_norm, init_mlp, init_norm, sinusoidal_positions,
                     truncated_normal)


def init_encdec(cfg: ModelConfig, generator: torch.Generator, device):
    """Random weights drawn on ``device`` from ``generator``."""
    d, dt = cfg.d_model, torch_dtype(cfg.dtype)
    norm = lambda: init_norm(d, cfg.norm_type, device)
    mlp = lambda: init_mlp(d, cfg.d_ff, cfg.mlp_type, dt, generator, device)
    params = {"embed": truncated_normal((cfg.padded_vocab, d), 0.02, dt, generator, device),
              "enc_norm": norm(), "final_norm": norm()}
    params["enc_layers"] = [
        {"norm1": norm(), "attn": attn_lib.init_attention(cfg, generator, device),
         "norm2": norm(), "mlp": mlp()} for _ in range(cfg.enc_layers)]
    params["dec_layers"] = [
        {"norm1": norm(), "self_attn": attn_lib.init_attention(cfg, generator, device),
         "norm2": norm(), "cross_attn": attn_lib.init_cross_attention(cfg, generator, device),
         "norm3": norm(), "mlp": mlp()} for _ in range(cfg.num_layers)]
    return params


def _remat(fn, cfg: ModelConfig, *args):
    """``fn(*args, cfg)``, recomputed in the backward with ``cfg.remat`` (the
    reference's ``nothing_saveable`` remat of each scanned layer)."""
    if cfg.remat:
        return checkpoint(fn, *args, cfg, use_reentrant=False)
    return fn(*args, cfg)


def _enc_block(p, x, positions, cfg: ModelConfig):
    h = apply_norm(p["norm1"], x, cfg.norm_type)
    a, _ = attn_lib.self_attention(p["attn"], h, positions, cfg, causal=False, use_rope=False)
    x = x + a
    return x + apply_mlp(p["mlp"], apply_norm(p["norm2"], x, cfg.norm_type), cfg.mlp_type)


def encode(params, frames, cfg: ModelConfig):
    """frames (B,F,d) stub conv output -> memory (B,F,d): the frames and
    the positions' sinusoids each cast to the model dtype, then added (the
    reference's rounding), through the bidirectional encoder."""
    b, f = frames.shape[:2]
    dt = torch_dtype(cfg.dtype)
    pos = torch.arange(f, dtype=torch.int32, device=frames.device)
    x = shu.constrain(frames.to(dt) + sinusoidal_positions(pos, cfg.d_model).to(dt),
                      shu.BATCH, None, None)
    positions = pos.expand(b, f).contiguous()
    for p in params["enc_layers"]:
        x = _remat(_enc_block, cfg, p, x, positions)
    return apply_norm(params["enc_norm"], x, cfg.norm_type)


def _dec_embed(params, tokens, cfg: ModelConfig):
    """Token embeddings plus their positions' sinusoids (in the embedding's
    dtype), and the positions (B,S) int32."""
    b, s = tokens.shape
    pos = torch.arange(s, dtype=torch.int32, device=tokens.device)
    x = params["embed"][tokens]
    x = shu.constrain(x + sinusoidal_positions(pos, cfg.d_model).to(x.dtype),
                      shu.BATCH, None, None)
    return x, pos.expand(b, s).contiguous()


def _dec_block(p, x, positions, ck, cv, cfg: ModelConfig, cache=None, layer: int = 0):
    """One decoder layer over the sequence: causal self attention (its K/V
    written into ``cache`` at ``layer`` when given), cross attention over
    ``ck``/``cv``, the MLP."""
    h = apply_norm(p["norm1"], x, cfg.norm_type)
    a, (k, v, k_pos) = attn_lib.self_attention(p["self_attn"], h, positions, cfg,
                                               causal=True, use_rope=False)
    if cache is not None:
        attn_lib.fill_kv_cache(cache, layer, k, v, k_pos)
    x = x + a
    h2 = apply_norm(p["norm2"], x, cfg.norm_type)
    x = x + attn_lib.cross_attention(p["cross_attn"], h2, ck, cv, cfg)
    return x + apply_mlp(p["mlp"], apply_norm(p["norm3"], x, cfg.norm_type), cfg.mlp_type)


def _dec_block_train(p, x, positions, memory, cfg: ModelConfig):
    """A training layer: the cross K/V projected inside it, so that remat
    recomputes them too."""
    ck, cv = attn_lib.cross_kv(p["cross_attn"], memory, cfg)
    return _dec_block(p, x, positions, ck, cv, cfg)


def _logits(params, x, cfg: ModelConfig):
    x = apply_norm(params["final_norm"], x, cfg.norm_type)
    return shu.constrain(x @ params["embed"].T, shu.BATCH, None, "model").float()


def forward(params, frames, tokens, cfg: ModelConfig):
    """Training forward: (fp32 logits (B,S,V_padded), aux = 0)."""
    memory = encode(params, frames, cfg)
    x, positions = _dec_embed(params, tokens, cfg)
    for p in params["dec_layers"]:
        x = _remat(_dec_block_train, cfg, p, x, positions, memory)
    return _logits(params, x, cfg), torch.zeros((), dtype=torch.float32, device=x.device)


def init_decode_caches(batch: int, capacity: int, cfg: ModelConfig, device):
    """Zero caches: the decoder's self KV at ``capacity`` slots and cross
    K/V of ``cfg.enc_frames`` frames."""
    hk, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    cross = (cfg.num_layers, batch, cfg.enc_frames, hk, dh)
    dt = torch_dtype(cfg.dtype)
    return {"self": attn_lib.init_kv_cache(cfg.num_layers, batch, capacity, cfg, device),
            "cross_k": torch.zeros(cross, dtype=dt, device=device),
            "cross_v": torch.zeros(cross, dtype=dt, device=device), "pos": 0}


def prefill(params, frames, tokens, cfg: ModelConfig, capacity: int):
    """frames (B,F,d), tokens (B,S) -> (last-token logits (B,V) fp32, caches).
    Each layer's cross K/V are projected once, attended over and kept."""
    memory = encode(params, frames, cfg)
    x, positions = _dec_embed(params, tokens, cfg)
    b, s = tokens.shape
    if s > capacity:
        raise ValueError(f"prefill of {s} tokens exceeds capacity {capacity}")
    caches = init_decode_caches(b, capacity, cfg.replace(enc_frames=memory.shape[1]),
                                tokens.device)
    for i, p in enumerate(params["dec_layers"]):
        ck, cv = attn_lib.cross_kv(p["cross_attn"], memory, cfg)
        caches["cross_k"][i] = ck
        caches["cross_v"][i] = cv
        x = _dec_block(p, x, positions, ck, cv, cfg, caches["self"], i)
    caches["pos"] = s
    return _logits(params, x[:, -1:], cfg)[:, 0], caches


def decode_step(params, token, caches, cfg: ModelConfig):
    """token (B,) int -> (logits (B,V) fp32, caches with ``pos`` + 1).  The
    token's sinusoid is the one row at ``pos`` (clamped to the table, as the
    reference's ``dynamic_slice`` clamps it); the self cache takes the token
    in place."""
    pos = caches["pos"]
    if torch.is_tensor(pos):
        raise ValueError("an encoder-decoder decodes over dense caches with a host-int pos")
    b, dev = token.shape[0], token.device
    row = torch.full((1,), min(pos, cfg.max_seq_len - 1), dtype=torch.int64, device=dev)
    x = params["embed"][token[:, None]]
    x = shu.constrain(x + sinusoidal_positions(row, cfg.d_model)[None].to(x.dtype),
                      shu.BATCH, None, None)
    kv, ck, cv = caches["self"], caches["cross_k"], caches["cross_v"]
    cache_len = torch.full((b,), pos + 1, dtype=torch.int32, device=dev)
    enc_len = torch.full((b,), ck.shape[2], dtype=torch.int32, device=dev)
    for i, p in enumerate(params["dec_layers"]):
        h = apply_norm(p["norm1"], x, cfg.norm_type)
        x = x + attn_lib.decode_attention(p["self_attn"], h, kv, i, pos, cache_len, cfg,
                                          use_rope=False)
        h2 = apply_norm(p["norm2"], x, cfg.norm_type)
        x = x + attn_lib.cross_decode_attention(p["cross_attn"], h2, ck[i], cv[i], enc_len, cfg)
        x = x + apply_mlp(p["mlp"], apply_norm(p["norm3"], x, cfg.norm_type), cfg.mlp_type)
    return _logits(params, x, cfg)[:, 0], {"self": kv, "cross_k": ck, "cross_v": cv,
                                           "pos": pos + 1}


def attention_calls(cfg: ModelConfig):
    """(prefill kernel calls a forward or prefill, decode kernel calls a
    decode step): an encoder layer's self attention, a decoder layer's self
    and cross attention."""
    return cfg.enc_layers + 2 * cfg.num_layers, 2 * cfg.num_layers
