"""Token samplers: greedy / temperature / top-k, fp32 logits in, id out
(counterpart of ``src/repro/serving/sampler.py``).

Temperature sampling draws from an explicit ``torch.Generator`` by the
Gumbel-max trick: one uniform draw of the logits' shape per call, no host
sync.  It cannot reproduce JAX's threefry stream; the port's own fused and
host loops draw identically, which the tests hold.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 0.0   # 0 => greedy
    top_k: int = 0             # 0 => full softmax
    vocab_size: int = 0        # mask padded logits above this (0 = off)


def greedy_ids(logits):
    """Argmax over the last axis, ties to the LOWEST id, spelled out as a
    min over the argmax set (as the JAX package does)."""
    v = logits.shape[-1]
    is_top = logits == logits.amax(dim=-1, keepdim=True)
    iota = torch.arange(v, dtype=torch.int32, device=logits.device).expand_as(is_top)
    return torch.where(is_top, iota, v).amin(dim=-1).to(torch.int32)


def mask_vocab(logits, cfg: SamplerConfig):
    """Mask padded logit lanes at and above ``cfg.vocab_size`` (0 = off)."""
    if cfg.vocab_size:
        keep = torch.arange(logits.shape[-1], dtype=torch.int32,
                            device=logits.device) < cfg.vocab_size
        logits = torch.where(keep, logits, -torch.inf)
    return logits


def sample(logits, cfg: SamplerConfig, generator=None):
    """logits (B,V) fp32 -> ids (B,) int32."""
    logits = mask_vocab(logits, cfg)
    if cfg.temperature <= 0.0:
        return greedy_ids(logits)
    logits = logits / cfg.temperature
    if cfg.top_k > 0:
        kth = torch.topk(logits, cfg.top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, -torch.inf, logits)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u))
    return greedy_ids(logits + gumbel)


def masked_sample(logits, done, eos_id: int, cfg: SamplerConfig, generator=None):
    """Decode-loop sampler with done-masking: finished rows keep emitting
    EOS.  Returns (ids, updated done)."""
    t = sample(logits, cfg, generator)
    t = torch.where(done, eos_id, t).to(torch.int32)
    return t, done | (t == eos_id)
