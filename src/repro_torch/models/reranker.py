"""Cross-encoder reranker: joint (query, candidate) duplicate scoring
(counterpart of ``src/repro/models/reranker.py``).

A pair is joined as ``[a, SEP, b]`` and read by the embedder's bidirectional
encoder; an fp32 ``score_head`` (d, 1) reads the mean over the valid
tokens.  It plays the GPTCache baseline's cross-encoder (``core/baseline.py``)
and the evidence of the router cascade's second stage
(``core/cache.py::make_second_stage``).

Positions are packed, the rank of a token among the valid ones
(``cumsum(mask) - 1``): padding inside the first segment must not move the
second segment's rotary phases, so a score depends on the tokens and not on
how they were padded.  Attention is plain PyTorch, as the reference's is XLA
(``impl="naive"``), not a Pallas kernel.
"""
from __future__ import annotations

import torch

from .config import ModelConfig
from .embedder import MINILM_CONFIG, init_embedder, pooled_states
from .layers import dense_init


def tiny_reranker_config(vocab_size: int = 4096) -> ModelConfig:
    return MINILM_CONFIG.replace(name="reranker", num_layers=2, d_model=64, num_heads=4,
                                 num_kv_heads=4, d_ff=128, vocab_size=vocab_size)


def init_reranker(cfg: ModelConfig, generator: torch.Generator, device):
    """The embedder's weights plus ``score_head`` (d, 1) fp32, drawn on
    ``device`` from ``generator``."""
    params = init_embedder(cfg, generator, device)
    params["score_head"] = dense_init((cfg.d_model, 1), torch.float32, generator, device)
    return params


def score_pairs(params, tokens_a, mask_a, tokens_b, mask_b, cfg: ModelConfig,
                sep_token: int = 3):
    """Duplicate logits (B,) of the pairs (tokens_a (B,Sa), tokens_b (B,Sb))."""
    b = tokens_a.shape[0]
    sep = torch.full((b, 1), sep_token, dtype=tokens_a.dtype, device=tokens_a.device)
    tokens = torch.cat([tokens_a, sep, tokens_b.to(tokens_a.dtype)], dim=1).long()
    mask = torch.cat([mask_a, torch.ones((b, 1), dtype=mask_a.dtype, device=mask_a.device),
                      mask_b.to(mask_a.dtype)], dim=1)
    positions = torch.clamp(torch.cumsum(mask.to(torch.int32), dim=1, dtype=torch.int32) - 1,
                            min=0)
    pooled = pooled_states(params, tokens, positions, mask, cfg)
    return (pooled @ params["score_head"])[:, 0]


def score_shortlist(params, q_tokens, q_mask, cand_tokens, cand_mask, cfg: ModelConfig,
                    sep_token: int = 3):
    """Logits (B,K) of each query (B,Sq) against its K candidates (B,K,Sc),
    scored as B*K independent pairs (so equivariant under a permutation of
    the candidates)."""
    b, k, sc = cand_tokens.shape
    flat = score_pairs(params, q_tokens.repeat_interleave(k, dim=0),
                       q_mask.repeat_interleave(k, dim=0), cand_tokens.reshape(b * k, sc),
                       cand_mask.reshape(b * k, sc), cfg, sep_token)
    return flat.reshape(b, k)
