"""MiniLM-class sentence embedder (counterpart of
``src/repro/models/embedder.py``).

Bidirectional encoder, masked attention over valid tokens, mean pooling,
L2 normalisation: unit vectors whose dot product is the cosine the cache
looks up.  Its attention is plain PyTorch: the JAX package computes it in
XLA, not in a Pallas kernel.
"""
from __future__ import annotations

import torch

from repro_torch.device import torch_dtype

from .attention import encoder_attention, init_attention
from .config import ModelConfig
from .layers import apply_mlp, apply_norm, dense_init, init_norm, truncated_normal

MINILM_CONFIG = ModelConfig(
    name="embedder-minilm", family="encoder", num_layers=6, d_model=384,
    num_heads=12, num_kv_heads=12, d_ff=1536, vocab_size=32768,
    mlp_type="gelu", norm_type="layernorm", rope_theta=10_000.0,
    dtype="float32", max_seq_len=512,
)


def tiny_embedder_config(vocab_size: int = 4096) -> ModelConfig:
    return MINILM_CONFIG.replace(num_layers=2, d_model=64, num_heads=4,
                                 num_kv_heads=4, d_ff=128, vocab_size=vocab_size)


def init_embedder(cfg: ModelConfig, generator: torch.Generator, device):
    """Random weights drawn on ``device`` from ``generator``."""
    dt = torch_dtype(cfg.dtype)
    d = cfg.d_model
    layers = []
    for _ in range(cfg.num_layers):
        layers.append({
            "norm1": init_norm(d, cfg.norm_type, device),
            "attn": init_attention(cfg, generator, device),
            "norm2": init_norm(d, cfg.norm_type, device),
            "mlp": {"w_up": dense_init((d, cfg.d_ff), dt, generator, device),
                    "w_down": dense_init((cfg.d_ff, d), dt, generator, device,
                                         stddev=cfg.d_ff ** -0.5)},
        })
    return {"embed": truncated_normal((cfg.padded_vocab, d), 0.02, dt, generator, device),
            "layers": layers,
            "final_norm": init_norm(d, cfg.norm_type, device)}


def pooled_states(params, tokens, positions, mask, cfg: ModelConfig):
    """The encoder over tokens (B,S) at ``positions`` (B,S), attention over
    the valid tokens of ``mask`` (B,S) {0,1}, final norm, then the fp32 mean
    over the valid tokens: (B,d).  The reranker shares it."""
    valid = mask.bool()
    x = params["embed"][tokens]
    for p in params["layers"]:
        h = apply_norm(p["norm1"], x, cfg.norm_type)
        x = x + encoder_attention(p["attn"], h, positions, valid, cfg)
        x = x + apply_mlp(p["mlp"], apply_norm(p["norm2"], x, cfg.norm_type), cfg.mlp_type)
    x = apply_norm(params["final_norm"], x, cfg.norm_type)
    m = mask.float()[..., None]
    return (x.float() * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)


def encode(params, tokens, mask, cfg: ModelConfig):
    """tokens (B,S) int, mask (B,S) {0,1} -> unit embeddings (B,d) fp32."""
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b, s)
    pooled = pooled_states(params, tokens, positions, mask, cfg)
    return pooled / torch.clamp(torch.linalg.norm(pooled, dim=-1, keepdim=True), min=1e-8)
