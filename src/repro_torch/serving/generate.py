"""Batched generation: prefill plus a fused decode loop (counterpart of
``src/repro/serving/generate.py``): dense or paged KV, greedy or sampled
decode, and draft-verify speculative decode.

The fused decode keeps every token, length and done flag on the device and
syncs with the host ONCE per call: the whole ``(B, max_new_tokens)`` block
comes back in one copy.  The JAX loop exits early on the device once every
row has emitted EOS; eager PyTorch would need a host sync each step to
decide that, so this loop runs the full budget with done-masking (finished
rows keep emitting EOS).  The output is the same; the cost is the steps
after the last row ends.  The host-driven loop, one sync per step, stays as
the differential oracle (``fused=False``).

With ``paged=True`` the dense prefill is scattered into the pages of a
``PagePool`` and the same loop decodes through the block table; a prefix
cache's full pages are pinned once and shared by every row.  With
``drafts`` the speculative loop verifies ``spec_k`` tokens per forward
(see ``_decode_fused_spec`` for its host syncs).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import to_device
from repro_torch.models.model import Model

from . import paged_kv as paged_lib
from .sampler import SamplerConfig, greedy_ids, mask_vocab, masked_sample, sample


@dataclasses.dataclass(frozen=True)
class GenerateConfig:
    max_new_tokens: int = 32
    eos_id: int = 2
    sampler: SamplerConfig = SamplerConfig()
    fused: bool = True
    # Paged KV decode: prefill stays dense, then the KV is scattered into
    # pool pages and the same fused loop decodes through the block table.
    # pool_pages=0 sizes the pool to the first paged call's need.
    paged: bool = False
    page_size: int = 16
    pool_pages: int = 0
    # Draft-verify block width; greedy only (the acceptance rule compares
    # argmax choices).  1 verifies one token per forward.
    spec_k: int = 1

    def __post_init__(self):
        if self.spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {self.spec_k}")
        if self.spec_k > self.max_new_tokens:
            raise ValueError(
                f"spec_k ({self.spec_k}) > max_new_tokens ({self.max_new_tokens}): a "
                f"verify block can never exceed the decode budget")
        if self.spec_k > 1 and self.sampler.temperature > 0:
            raise ValueError(
                "speculative decode is greedy-only (temperature 0): the lossless "
                "acceptance rule compares argmax choices; set spec_k=1 or "
                "temperature=0.0")


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
        if gen_cfg.spec_k > 1 and not model.supports_spec_decode:
            raise ValueError(
                f"{model.cfg.name}: spec_k={gen_cfg.spec_k} but this architecture "
                f"cannot verify draft blocks — use spec_k=1")
        self.model = model
        self.params = params
        self.cfg = gen_cfg
        self.device = params["embed"].device
        # per-call seeds when the caller threads none
        self._auto_seed = itertools.count()
        # page pool for cfg.paged, built on first use
        self._pool: Optional[paged_lib.PagePool] = None
        # speculation counters: cumulative, and the last call's
        self.spec_stats = {"proposed": 0, "accepted": 0, "spec_steps": 0}
        self.last_spec_stats = {"proposed": 0, "accepted": 0, "spec_steps": 0}
        self.last_spec_syncs = 0          # host syncs of the last speculative call

    # ------------------------------------------------------ paged decode
    @property
    def pool(self) -> Optional[paged_lib.PagePool]:
        """The page pool behind ``cfg.paged`` decode (None until used)."""
        return self._pool

    def _ensure_pool(self, batch: int, capacity: int) -> paged_lib.PagePool:
        if self._pool is None:
            need = batch * (-(-capacity // self.cfg.page_size))
            self._pool = paged_lib.PagePool(
                self.model, paged_lib.PagePoolConfig(
                    page_size=self.cfg.page_size,
                    num_pages=max(self.cfg.pool_pages, need)), self.device)
        return self._pool

    def _page_in(self, caches, batch: int, capacity: int,
                 prefix_cache: Optional["PrefixCache"]):
        """Scatter a dense prefill's caches into pool pages.

        Returns (paged caches, (block_tbl, writable)): the host-side lease
        the caller releases with ``pool.free_block_table`` once decode is
        done.  With a prefix cache, its full pages are pinned once (keyed by
        its token ids) and shared read-only by every row.
        """
        pool = self._ensure_pool(batch, capacity)
        pin = pool.ensure_pinned(prefix_cache) if prefix_cache is not None else None
        tbl, writable = pool.alloc_block_table(batch, capacity, pin)
        try:
            paged = paged_lib.pack_caches(
                pool.storage, caches, to_device(tbl.astype(np.int32), self.device),
                to_device(writable, self.device))
        except Exception:
            pool.free_block_table(tbl, writable)
            raise
        pool.adopt(paged)
        return paged, (tbl, writable)

    # ------------------------------------------------------ prefix cache
    @property
    def supports_prefix_prefill(self) -> bool:
        return self.model.supports_prefix_prefill

    @property
    def speculation_ready(self) -> bool:
        """True when callers should thread drafts: a verify block wider than
        plain decode, the fused loop, greedy sampling and an architecture
        that can rewind."""
        return (self.cfg.spec_k > 1 and self.cfg.fused
                and self.cfg.sampler.temperature <= 0
                and self.model.supports_spec_decode)

    def build_prefix_cache(self, prefix_ids: Sequence[int], batch: int) -> PrefixCache:
        """Prefill a shared prefix once at ``batch`` rows (every row holds the
        same ids), with the exact shapes the suffix prefills will see."""
        ids = tuple(int(t) for t in prefix_ids)  # hostsync: ok one-time prefix build, host-side ids
        if not ids:
            raise ValueError("prefix_ids must be non-empty")
        toks = to_device(np.asarray(ids, np.int64), self.device)
        toks = toks[None, :].expand(batch, len(ids)).contiguous()
        caches = self.model.prefill_prefix(self.params, toks)
        return PrefixCache(caches=caches, length=len(ids), batch=batch, token_ids=ids)

    def _draft_pack(self, drafts, b: int, mnt: int, use_fused: bool):
        """Validate drafts and pack ``[draft_len | draft_ids]`` (B, mnt+1)
        int32 on the device in one transfer."""
        if not use_fused:
            raise ValueError("speculative decode requires the fused loop — the host "
                             "oracle is the plain differential baseline (fused=True)")
        if self.cfg.sampler.temperature > 0:
            raise ValueError("speculative decode is greedy-only (temperature 0): "
                             "lossless acceptance compares argmax choices")
        if not self.model.supports_spec_decode:
            raise NotImplementedError(
                f"{self.model.cfg.name}: draft-verify decode unsupported for this "
                f"architecture — drop the drafts")
        if self.cfg.spec_k > mnt:
            raise ValueError(f"spec_k ({self.cfg.spec_k}) > max_new_tokens ({mnt}) for "
                             f"this call: shrink the block or raise the budget")
        raw_ids, raw_lens = drafts
        raw_ids = np.asarray(raw_ids, np.int32)
        pack = np.zeros((b, mnt + 1), np.int32)
        w = min(raw_ids.shape[1], mnt)
        pack[:, 1:1 + w] = raw_ids[:, :w]
        pack[:, 0] = np.minimum(np.asarray(raw_lens, np.int32), mnt)
        return to_device(pack, self.device)

    def generate_with_lengths(
            self, batch: Dict[str, Any], *, max_new_tokens: Optional[int] = None,
            seed: Optional[int] = None, fused: Optional[bool] = None,
            prefix_cache: Optional[PrefixCache] = None, drafts=None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Returns (tokens (B,T_new) int32, lengths (B,), ended (B,)) on the host.

        ``batch`` holds ``tokens`` (B,S), and ``frames`` (an encoder-decoder)
        or ``prefix_embeds`` (a frontend config) where the model takes them.

        ``lengths`` counts each row's real generated tokens, its EOS included
        when ``ended``.  With ``prefix_cache``, ``batch["tokens"]`` is only the
        suffix and the call matches generating from ``[prefix | suffix]``.
        With ``drafts`` — ``(draft_ids (B, D), draft_lens (B,))`` host ints,
        per-row predicted output tokens (the TWEAK route's cached response) —
        decode runs the speculative verify loop at ``cfg.spec_k`` tokens per
        forward; the tokens equal the plain call's.  Rows with an empty
        draft decode plainly inside the same call.
        """
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
        use_fused = self.cfg.fused if fused is None else fused
        # drafts go up before the prefill is enqueued: one transfer
        draft_pack = None if drafts is None else self._draft_pack(drafts, b, mnt, use_fused)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))  # hostsync: ok host int seed
        if prefix_cache is not None:
            if b != prefix_cache.batch:
                raise ValueError(
                    f"prefix cache was built for batch {prefix_cache.batch}, "
                    f"got a batch of {b} rows — build one per batch bucket")
            capacity = prefix_cache.length + s + mnt + 1
            logits, caches = self.model.prefill_with_prefix(
                self.params, {"tokens": tokens}, capacity, prefix_cache.caches)
        else:
            # the frontend's prefix positions come first (the reference counts
            # them whether or not the batch holds prefix_embeds)
            capacity = s + mnt + 1 + self.model.cfg.num_prefix_tokens
            inputs = {"tokens": tokens}
            for key in ("frames", "prefix_embeds"):
                if key in batch:
                    inputs[key] = to_device(batch[key], self.device)
            logits, caches = self.model.prefill(self.params, inputs, capacity)
        lease = None
        if self.cfg.paged:
            if not self.model.supports_paged_decode:
                raise NotImplementedError(
                    f"{self.model.cfg.name}: paged KV decode unsupported for this "
                    f"architecture — use dense decode")
            caches, lease = self._page_in(caches, b, capacity, prefix_cache)
        try:
            if draft_pack is not None:
                return self._decode_fused_spec(logits, caches, draft_pack, mnt,
                                               self.cfg.spec_k)
            if use_fused:
                # hostsync: ok THE one per-call copy of the decode block
                packed = _pack(*self._decode_fused(logits, caches, gen, mnt)).cpu().numpy()
                return packed[:, :mnt], packed[:, mnt], packed[:, mnt + 1].astype(bool)
            return self._host_loop(logits, caches, gen, mnt)
        finally:
            if lease is not None:
                self._pool.free_block_table(*lease)

    def _decode_fused(self, logits, caches, gen, mnt: int):
        """The whole decode without a host sync: (tokens, lengths, done)."""
        eos, scfg = self.cfg.eos_id, self.cfg.sampler
        b = logits.shape[0]
        tok = sample(logits, scfg, gen)
        done = tok == eos
        toks = torch.full((b, mnt), eos, dtype=torch.int32, device=logits.device)
        toks[:, 0] = tok
        lengths = torch.full((b,), mnt, dtype=torch.int32, device=logits.device).masked_fill_(
            done, 1)
        for step in range(1, mnt):
            logits, caches = self.model.decode_step(self.params, tok, caches)
            t, new_done = masked_sample(logits, done, eos, scfg, gen)
            lengths = torch.where(new_done & ~done, step + 1, lengths).to(torch.int32)
            toks[:, step] = t
            tok, done = t, new_done
        return toks, lengths, done

    def _decode_fused_spec(self, logits0, caches, draft_pack, mnt: int, k: int):
        """Draft-verify speculative decode, greedy (the JAX package's
        ``_decode_fused_spec``, two ``while_loop``s with data-dependent
        exits).

        1. While any active row still speculates, verify a (B, k) block per
           forward: ``[last token, draft...]``; accept the longest prefix
           whose greedy choices match the draft plus one correction token
           (``a`` in [1, k] per active row) and rewind the k - a
           optimistic cache writes.  A rejection or an exhausted draft drops
           the row to phase 2 for good.
        2. Plain single-token blocks (k = 1) for the rest of the budget.

        Host syncs per call, without a per-step sync in phase 2:
        ``spec_steps + 2``.  Phase 1 reads one small tensor per iteration
        test (whether any row still speculates, and how many phase-2 steps
        the unfinished rows need), ``spec_steps + 1`` reads in all; the last
        of them bounds phase 2, which then runs with done-masking, past the
        point where JAX's loop would stop if rows end early; the final copy
        brings back tokens, lengths, flags and counters.  Phase 1 runs
        exactly JAX's iterations, so ``spec_steps`` equals JAX's.
        """
        eos, scfg = self.cfg.eos_id, self.cfg.sampler
        b = logits0.shape[0]
        dev = logits0.device
        draft_len, draft_ids = draft_pack[:, 0], draft_pack[:, 1:]
        d = draft_ids.shape[1]
        caches = paged_lib.row_pos_caches(caches, b)
        tok = greedy_ids(mask_vocab(logits0, scfg))
        eos_done = tok == eos
        toks = torch.full((b, mnt), eos, dtype=torch.int32, device=dev)
        toks[:, 0] = tok
        lengths = torch.full((b,), mnt, dtype=torch.int32, device=dev).masked_fill_(eos_done, 1)
        ne = torch.ones(b, dtype=torch.int32, device=dev)            # tokens emitted
        # speculate only while the draft tracks the stream: token 0 must match
        spec_on = ~eos_done & (draft_len > 0) & (tok == draft_ids[:, 0])
        prop = torch.zeros((), dtype=torch.int32, device=dev)
        acc = torch.zeros((), dtype=torch.int32, device=dev)
        iota_k = torch.arange(k, dtype=torch.int32, device=dev)
        cm = torch.arange(mnt, dtype=torch.int32, device=dev)[None, :]
        steps = syncs = 0
        while True:
            active = ~eos_done & (ne < mnt) & spec_on
            left = torch.where(eos_done, 0, mnt - ne).amax()
            # hostsync: ok the speculative loop's per-iteration flag read
            flag = torch.stack([active.any().to(torch.int32), left.to(torch.int32)]).cpu()
            syncs += 1
            if not flag[0]:
                break
            dpos = ne[:, None] + iota_k[None, :k - 1]                 # (B,k-1)
            dval = draft_ids.gather(1, dpos.clamp(0, d - 1).long())
            x = torch.cat([tok[:, None], dval], dim=1)                 # (B,k)
            logits, caches = self.model.decode_block(self.params, x, caches)
            g = greedy_ids(mask_vocab(logits, scfg))                  # (B,k)
            # g[:, i] is the true greedy token at output position ne + i when
            # the fed draft prefix matched; cumprod keeps the leading run
            match = (g[:, :k - 1] == dval) & (dpos < draft_len[:, None])
            lmatch = match.to(torch.int32).cumprod(dim=1, dtype=torch.int32).sum(dim=1,
                                                                           dtype=torch.int32)
            eos_idx = torch.where(g == eos, iota_k[None, :], k).amin(dim=1)
            a = torch.minimum(torch.minimum(lmatch + 1, eos_idx + 1), mnt - ne)
            a = torch.where(active, a, 0).to(torch.int32)
            last = (a - 1).clamp(0, k - 1)
            tlast = g.gather(1, last[:, None].long())[:, 0]
            ended_now = (a > 0) & (tlast == eos)
            lengths = torch.where(ended_now, ne + a, lengths)
            sel = (cm - ne[:, None]).clamp(0, k - 1)
            in_rng = (cm >= ne[:, None]) & (cm < (ne + a)[:, None])
            toks = torch.where(in_rng, g.gather(1, sel.long()), toks)
            tok = torch.where(a > 0, tlast, tok)
            # drop the k - a rejected positions; inactive rows roll back all k
            caches = paged_lib.rewind_kv(caches, k - a)
            n_fed = (draft_len - ne).clamp(0, k - 1)
            prop = prop + torch.where(active, n_fed, 0).sum(dtype=torch.int32)
            acc = acc + torch.where(active, torch.minimum(lmatch, a), 0).sum(dtype=torch.int32)
            ne = ne + a
            spec_on = active & (a == k) & (ne < draft_len)
            eos_done = eos_done | ended_now
            steps += 1
        for _ in range(int(flag[1])):  # hostsync: ok host copy of that flag
            logits, caches = self.model.decode_block(self.params, tok[:, None], caches)
            g1 = greedy_ids(mask_vocab(logits, scfg))[:, 0]
            active = ~eos_done & (ne < mnt)
            t = torch.where(active, g1, tok)
            end_now = active & (t == eos)
            lengths = torch.where(end_now, ne + 1, lengths)
            toks = torch.where((cm == ne[:, None]) & active[:, None], t[:, None], toks)
            ne = ne + active.to(torch.int32)
            eos_done = eos_done | end_now
            tok = t
        counters = torch.stack([prop, acc]).expand(b, 2)
        # hostsync: ok the speculative call's final copy
        packed = torch.cat([_pack(toks, lengths, eos_done), counters], dim=1).cpu().numpy()
        syncs += 1
        prop, acc = (int(x) for x in packed[0, mnt + 2:mnt + 4])  # hostsync: ok host numpy
        self.last_spec_stats = {"proposed": prop, "accepted": acc, "spec_steps": steps}
        self.last_spec_syncs = syncs
        for stat, inc in self.last_spec_stats.items():
            self.spec_stats[stat] += inc
        return packed[:, :mnt], packed[:, mnt], packed[:, mnt + 1].astype(bool)

    # hostsync: ok the differential oracle syncs per step by design
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
