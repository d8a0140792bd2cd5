"""Batched generation: prefill plus a fused decode loop (counterpart of
``src/repro/serving/generate.py``, dense greedy/temperature decode).

The fused decode keeps every token, length and done flag on the device and
syncs with the host ONCE per call: the whole ``(B, max_new_tokens)`` block
comes back in one copy.  The JAX loop exits early on the device once every
row has emitted EOS; eager PyTorch would need a host sync each step to
decide that, so this loop runs the full budget with done-masking (finished
rows keep emitting EOS).  The output is the same; the cost is the steps
after the last row ends.  The host-driven loop, one sync per step, stays as
the differential oracle (``fused=False``).

Paged KV and speculative (draft-verify) decode are not ported and raise.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import to_device
from repro_torch.models.model import Model

from .sampler import SamplerConfig, masked_sample, sample


@dataclasses.dataclass(frozen=True)
class GenerateConfig:
    max_new_tokens: int = 32
    eos_id: int = 2
    sampler: SamplerConfig = SamplerConfig()
    fused: bool = True
    paged: bool = False
    spec_k: int = 1

    def __post_init__(self):
        if self.paged:
            raise NotImplementedError("paged KV decode is not ported")
        if self.spec_k != 1:
            raise NotImplementedError("speculative decode (spec_k > 1) is not ported")


@dataclasses.dataclass(frozen=True)
class PrefixCache:
    """Prefilled KV state of a shared prompt prefix at serve batch ``batch``
    (capacity exactly ``length``), reused read-only by every suffix prefill
    at that batch; ``token_ids`` records what was prefilled."""
    caches: Any
    length: int
    batch: int
    token_ids: Tuple[int, ...]


def _pack(toks, lengths, done):
    """One int32 block [tokens | length | ended] for a single host copy."""
    return torch.cat([toks, lengths[:, None], done[:, None].to(torch.int32)], dim=1)


class Generator:
    """Wraps a Model and its parameters for repeated serving calls."""

    def __init__(self, model: Model, params, gen_cfg: GenerateConfig):
        self.model = model
        self.params = params
        self.cfg = gen_cfg
        self.device = params["embed"].device
        # per-call seeds when the caller threads none
        self._auto_seed = itertools.count()

    @property
    def supports_prefix_prefill(self) -> bool:
        return self.model.supports_prefix_prefill

    def build_prefix_cache(self, prefix_ids: Sequence[int], batch: int) -> PrefixCache:
        """Prefill a shared prefix once at ``batch`` rows (every row holds the
        same ids), with the exact shapes the suffix prefills will see."""
        ids = tuple(int(t) for t in prefix_ids)
        if not ids:
            raise ValueError("prefix_ids must be non-empty")
        toks = torch.tensor(ids, dtype=torch.int64, device=self.device)
        toks = toks[None, :].expand(batch, len(ids)).contiguous()
        caches = self.model.prefill_prefix(self.params, toks)
        return PrefixCache(caches=caches, length=len(ids), batch=batch, token_ids=ids)

    def generate_with_lengths(
            self, batch: Dict[str, Any], *, max_new_tokens: Optional[int] = None,
            seed: Optional[int] = None, fused: Optional[bool] = None,
            prefix_cache: Optional[PrefixCache] = None, drafts=None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Returns (tokens (B,T_new) int32, lengths (B,), ended (B,)) on the host.

        ``lengths`` counts each row's real generated tokens, its EOS included
        when ``ended``.  With ``prefix_cache``, ``batch["tokens"]`` is only the
        suffix and the call matches generating from ``[prefix | suffix]``.
        """
        if drafts is not None:
            raise NotImplementedError("speculative decode (drafts) is not ported")
        mnt = self.cfg.max_new_tokens if max_new_tokens is None else max_new_tokens
        if mnt < 0:
            raise ValueError(f"max_new_tokens must be >= 0, got {mnt}")
        tokens = to_device(batch["tokens"], self.device).long()
        b, s = tokens.shape
        if mnt == 0:
            return (np.zeros((b, 0), np.int32), np.zeros((b,), np.int32),
                    np.zeros((b,), bool))
        if seed is None:
            seed = next(self._auto_seed)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        if prefix_cache is not None:
            if b != prefix_cache.batch:
                raise ValueError(
                    f"prefix cache was built for batch {prefix_cache.batch}, "
                    f"got a batch of {b} rows — build one per batch bucket")
            capacity = prefix_cache.length + s + mnt + 1
            logits, caches = self.model.prefill_with_prefix(
                self.params, {"tokens": tokens}, capacity, prefix_cache.caches)
        else:
            logits, caches = self.model.prefill(self.params, {"tokens": tokens}, s + mnt + 1)
        use_fused = self.cfg.fused if fused is None else fused
        if use_fused:
            packed = _pack(*self._decode_fused(logits, caches, gen, mnt)).cpu().numpy()
            # THE per-generate-call device->host sync
            return packed[:, :mnt], packed[:, mnt], packed[:, mnt + 1].astype(bool)
        return self._host_loop(logits, caches, gen, mnt)

    def _decode_fused(self, logits, caches, gen, mnt: int):
        """The whole decode without a host sync: (tokens, lengths, done)."""
        eos, scfg = self.cfg.eos_id, self.cfg.sampler
        b = logits.shape[0]
        tok = sample(logits, scfg, gen)
        done = tok == eos
        toks = torch.full((b, mnt), eos, dtype=torch.int32, device=logits.device)
        toks[:, 0] = tok
        lengths = torch.where(done, 1, mnt).to(torch.int32)
        for step in range(1, mnt):
            logits, caches = self.model.decode_step(self.params, tok, caches)
            t, new_done = masked_sample(logits, done, eos, scfg, gen)
            lengths = torch.where(new_done & ~done, step + 1, lengths).to(torch.int32)
            toks[:, step] = t
            tok, done = t, new_done
        return toks, lengths, done

    def _host_loop(self, logits, caches, gen, mnt: int):
        """Host-driven per-step decode, one sync per token: the oracle."""
        eos = self.cfg.eos_id
        tok = sample(logits, self.cfg.sampler, gen)
        t = tok.cpu().numpy()
        b = t.shape[0]
        out = np.full((b, mnt), eos, np.int32)
        out[:, 0] = t
        done = t == eos
        lengths = np.where(done, 1, mnt).astype(np.int32)
        for i in range(1, mnt):
            if done.all():
                break
            logits, caches = self.model.decode_step(self.params, tok, caches)
            tok = sample(logits, self.cfg.sampler, gen)
            t = np.where(done, eos, tok.cpu().numpy())
            out[:, i] = t
            lengths[~done & (t == eos)] = i + 1
            done |= t == eos
        return out, lengths, done
