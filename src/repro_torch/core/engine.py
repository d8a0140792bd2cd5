"""TweakLLMEngine — the paper's Figure-1 pipeline (counterpart of
``src/repro/core/engine.py``: engines over a local or row-sharded bank with a
flat or IVF index and per-cluster admission, FIFO/LRU/LFU, the router with
its stage-2 cascade; dense or paged decode, greedy or sampled, speculative
TWEAK decode on cached-response drafts; and ``ReplicaGroup``, N engines over
one shared bank or private ones).

Per batch of text queries:
  1. tokenize + embed (MiniLM-class embedder, unit vectors);
  2. fused lookup + route + touch on the bank (cosine top-k kernels);
  3. ONE device->host copy of scores, slots, decisions and admit flags;
     with the cascade on (``band > 0`` and a reranker), a batch that holds
     UNCERTAIN rows runs stage 2 on the device and makes a SECOND copy, of
     its final decisions and slots;
  4. EXACT -> the cached response verbatim;
     TWEAK -> the small LM prefills the Appendix-A prompt's suffix over the
              shared instruction-prefix KV and decodes; a speculating small
              generator verifies the cached response's own token ids as
              drafts (``SharedCacheBank.draft_store``);
     MISS  -> the big LM prefills the query and decodes, then the pairs
              whose cluster admits are committed with one ``insert_batch``
              (an IVF bank may then recluster: ``maybe_reindex``).

Token counts are real generated tokens (up to and including each row's
EOS) and real prompt lengths, as in the reference.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import to_device
from repro_torch.models.embedder import encode as embed_encode
from repro_torch.serving.batcher import (bucket_batch, bucket_len, floor_len_bucket,
                                         pad_to_buckets)
from repro_torch.serving.continuous import leaked_pages
from repro_torch.serving.generate import Generator
from repro_torch.tokenizer import HashWordTokenizer

from . import cache as cache_lib
from . import distributed as dist_lib
from . import index as index_lib
from . import router as router_lib
from . import tweak as tweak_lib


@dataclasses.dataclass
class EngineStats:
    total: int = 0
    miss: int = 0
    tweak: int = 0
    exact: int = 0
    # stage-2 cascade: rows that entered the uncertainty band, and those of
    # them that committed as TWEAK (recovered hits)
    uncertain: int = 0
    recovered: int = 0
    suppressed_inserts: int = 0
    big_tokens: int = 0             # REAL generated tokens, Big LLM
    small_tokens: int = 0           # REAL generated tokens, Small LLM
    big_prompt_tokens: int = 0      # real (unpadded) prompt tokens
    small_prompt_tokens: int = 0
    baseline_prompt_tokens: int = 0  # real query tokens of all requests
    # speculative-decode counters of the reference; 0 without speculation
    proposed: int = 0
    accepted: int = 0
    spec_steps: int = 0
    big_cost_per_token: float = 25.0
    small_cost_per_token: float = 1.0

    @property
    def cost(self) -> float:
        return ((self.big_tokens + self.big_prompt_tokens) * self.big_cost_per_token
                + (self.small_tokens + self.small_prompt_tokens) * self.small_cost_per_token)

    @property
    def baseline_cost(self) -> float:
        """What the same traffic would cost all-Big."""
        return (self.big_tokens + self.small_tokens
                + self.baseline_prompt_tokens) * self.big_cost_per_token

    @property
    def hit_rate(self) -> float:
        return (self.tweak + self.exact) / max(self.total, 1)

    @property
    def acceptance_rate(self) -> float:
        """Fraction of drafted tokens the verify loop accepted."""
        return self.accepted / max(self.proposed, 1)

    @classmethod
    def aggregate(cls, parts) -> "EngineStats":
        """Counters summed across replicas; their cost rates must agree (an
        average would make ``cost`` meaningless)."""
        parts = list(parts)
        if not parts:
            return cls()
        rates = {(p.big_cost_per_token, p.small_cost_per_token) for p in parts}
        if len(rates) != 1:
            raise ValueError(f"replicas disagree on cost rates: {sorted(rates)}")
        big_rate, small_rate = rates.pop()
        out = cls(big_cost_per_token=big_rate, small_cost_per_token=small_rate)
        for f in ("total", "miss", "tweak", "exact", "uncertain", "recovered",
                  "suppressed_inserts", "big_tokens", "small_tokens", "big_prompt_tokens",
                  "small_prompt_tokens", "baseline_prompt_tokens", "proposed", "accepted",
                  "spec_steps"):
            setattr(out, f, sum(getattr(p, f) for p in parts))
        return out


@dataclasses.dataclass
class BatchResult:
    """Per-batch responses with per-request metadata (sim, decision, band,
    generated tokens) and the batch's token counts."""
    responses: List[str]
    meta: List[dict]
    big_tokens: int = 0
    small_tokens: int = 0
    big_prompt_tokens: int = 0
    small_prompt_tokens: int = 0


class SharedCacheBank:
    """The semantic cache state plus its host text mirror, shareable.

    One bank serves one engine, or every replica of a ``ReplicaGroup``: a
    response one replica commits is an EXACT or TWEAK hit for the others on
    their next lookup.  The state is updated in place by every lookup and
    commit.  ``reranker=(params, model_cfg)`` wires the stage-2 resolver of
    the router cascade, which ``band > 0`` needs.

    With a ``mesh`` (``launch/mesh.py::make_cache_mesh``) the rows, and an
    IVF bank's member tables, are row-sharded over its devices and the entry
    points come from ``core/distributed.py``: lookups merge per-shard
    winners, inserts (FIFO only) land on the shard owning each slot, and
    stage 2 gathers tokens and touches on the owning shards.  ``state`` is a
    local-layout state either way; a sharded bank splits it.
    """

    def __init__(self, cache_cfg: cache_lib.CacheConfig,
                 router_cfg: Optional[router_lib.RouterConfig] = None, *,
                 device="cuda", mesh=None, state=None, reranker=None):
        router_cfg = router_cfg or router_lib.RouterConfig()
        if router_cfg.band > 0.0 and reranker is None:
            raise ValueError("router band > 0 enables the stage-2 cascade, which needs "
                             "reranker=(params, model_cfg) on the bank")
        self.cfg = cache_cfg
        self.router_cfg = router_cfg
        self.mesh = None if mesh is None else tuple(torch.device(d) for d in mesh)
        self.device = torch.device(device) if mesh is None else self.mesh[0]
        self.text_store: Dict[int, Tuple[str, str]] = {}
        # cached-response token ids, the speculation drafts: the exact ids
        # generation produced (a text round trip need not be identity)
        self.draft_store: Dict[int, List[int]] = {}
        # commits so far: the seed stream of the IVF rebuilds
        self.insert_seq = 0
        self._default_costs: Dict[int, torch.Tensor] = {}
        if state is None:
            state = cache_lib.init_cache(cache_cfg, self.device)
        if mesh is None:
            self.state = state
            self._lookup_touch = lambda st, q, c: cache_lib.lookup_route_touch(
                st, cache_cfg, router_cfg, q, c)
            self._insert = lambda st, *args: cache_lib.insert_batch(st, cache_cfg, *args)
        else:
            if cache_cfg.index == "ivf":
                self.state = dist_lib.shard_ivf_cache_state(state, self.mesh, cache_cfg)
            else:
                self.state = dist_lib.shard_cache_state(state, self.mesh)
            self._lookup_touch = dist_lib.make_distributed_lookup_and_touch(
                self.mesh, cache_cfg, router_cfg)
            self._insert = dist_lib.make_distributed_insert_batch(self.mesh, cache_cfg)
        self._second_stage = None
        if reranker is not None:
            self._second_stage = cache_lib.make_second_stage(cache_cfg, self.router_cfg,
                                                             *reranker)

    @property
    def sharded(self) -> bool:
        return self.mesh is not None

    @property
    def cascading(self) -> bool:
        """Is the stage-2 cascade on (band > 0 and a reranker wired)?"""
        return self.router_cfg.band > 0.0 and self._second_stage is not None

    def default_cost(self, batch: int):
        """The (batch,) default-cost tensor, built once per batch size."""
        c = self._default_costs.get(batch)
        if c is None:
            c = torch.full((batch,), self.router_cfg.default_cost, dtype=torch.float32,
                           device=self.device)
            self._default_costs[batch] = c
        return c

    def route_batch(self, q_embs, cost=None):
        """Fused lookup + route + touch.  Returns device tensors
        ``(scores, idx, decisions, tau, cluster, admit)``."""
        if cost is None:
            cost = self.default_cost(q_embs.shape[0])
        (self.state, scores, idx, dec, tau, cluster, admit) = self._lookup_touch(
            self.state, q_embs, cost)
        return scores, idx, dec, tau, cluster, admit

    def second_stage(self, q_tokens, q_mask, scores, idx, decisions, tau, cluster):
        """Resolve UNCERTAIN rows on the device: returns ``(final decisions,
        slot, conf)`` (B,) tensors; ``slot`` is the serving slot of each row
        (the stage-2 pick for committed uncertain rows, the top-1 otherwise)."""
        if self._second_stage is None:
            raise ValueError("bank built without a reranker; stage 2 unavailable")
        self.state, final, slot, conf = self._second_stage(
            self.state, q_tokens, q_mask, scores, idx, decisions, tau, cluster)
        return final, slot, conf

    def insert_batch(self, embs, q_tokens, q_mask, r_tokens, r_mask, count):
        """One commit; returns the device ``slots`` tensor."""
        self.state, slots = self._insert(self.state, embs, q_tokens, q_mask, r_tokens, r_mask,
                                         count)
        return slots

    def maybe_reindex(self) -> bool:
        """IVF maintenance after a commit (no-op for a flat bank); advances
        ``insert_seq``, the rebuilds' seed stream, either way."""
        rebuilt = False
        if self.cfg.index == "ivf":
            if self.mesh is None:
                self.state, rebuilt = index_lib.maybe_reindex(self.state, self.cfg,
                                                              seed=self.insert_seq)
            else:
                rebuilt = self._maybe_reindex_sharded()
        self.insert_seq += 1
        return rebuilt

    def _maybe_reindex_sharded(self) -> bool:
        """The sharded recluster: gather, ``build_index``, reshard, on the
        same rule and seed as a local bank, so both hold the same index
        after it.  One host read of the two replicated scalars."""
        st = self.state
        flags = torch.stack([st["ivf_overflow"].to(torch.int32), st["ivf_pending"]])
        # hostsync: ok the sharded recluster's one read of two flags
        overflow, pending = flags.cpu().tolist()
        if not (overflow or pending >= index_lib.resolve(self.cfg).reindex_every):
            return False
        local = index_lib.build_index(dist_lib.gather_cache_state(st, self.cfg), self.cfg,
                                      seed=self.insert_seq)
        self.state = dist_lib.shard_ivf_cache_state(local, self.mesh, self.cfg)
        return True


def _fetch_route(scores, idx, dec, admit):
    """Scores (B,k) f32, indices (B,k) i32, decisions (B,) i32 and admit
    flags (B,) bool to the host in ONE copy: the integers ride bit-for-bit
    as float32 lanes."""
    ints = torch.stack([dec.to(torch.int32), admit.to(torch.int32)], dim=1)
    packed = torch.cat([scores, idx.view(torch.float32), ints.view(torch.float32)], dim=1)
    host = packed.cpu().numpy()  # hostsync: ok THE per-batch route fetch
    k = scores.shape[1]
    return (host[:, :k], host[:, k:2 * k].view(np.int32),
            host[:, 2 * k].view(np.int32), host[:, 2 * k + 1].view(np.int32) != 0)


class TweakLLMEngine:
    def __init__(self, *, tokenizer: HashWordTokenizer, embedder_params, embedder_cfg,
                 big: Generator, small: Generator,
                 cache_cfg: Optional[cache_lib.CacheConfig] = None,
                 router_cfg: Optional[router_lib.RouterConfig] = None,
                 max_query_len: int = 64, use_prefix_cache: bool = True,
                 bank: Optional[SharedCacheBank] = None, replica_id: int = 0, reranker=None):
        if bank is None:
            if cache_cfg is None:
                raise ValueError("pass cache_cfg or a SharedCacheBank")
            bank = SharedCacheBank(cache_cfg, router_cfg,
                                   device=embedder_params["embed"].device, reranker=reranker)
        else:
            if cache_cfg is not None and cache_cfg != bank.cfg:
                raise ValueError("cache_cfg disagrees with the shared bank")
            if router_cfg is not None and router_cfg != bank.router_cfg:
                raise ValueError("router_cfg disagrees with the shared bank")
        self.bank = bank
        self.replica_id = replica_id
        self.tok = tokenizer
        self.embedder_params = embedder_params
        self.embedder_cfg = embedder_cfg
        self.device = embedder_params["embed"].device
        self.big = big
        self.small = small
        self.cache_cfg = bank.cfg
        self.router_cfg = bank.router_cfg
        self.max_query_len = max_query_len
        self.use_prefix_cache = use_prefix_cache
        self.stats = EngineStats()
        # tweak-instruction prefix KV, one PrefixCache per batch bucket,
        # rebuilt when the small generator, its configs or the ids change
        self._prefix_ids: Optional[Tuple[int, ...]] = None
        self._prefix_caches: Dict[int, object] = {}
        self._prefix_sig = None
        self._static_counts: Optional[Tuple[int, int]] = None
        # per-batch seeds: distinct serve batches sample distinct streams
        self._seed_seq = itertools.count()
        # device->host copies of routing results in the last batch: 1, or 2
        # when stage 2 ran
        self.last_route_syncs = 0

    @property
    def state(self):
        return self.bank.state

    @property
    def _text_store(self) -> Dict[int, Tuple[str, str]]:
        return self.bank.text_store

    # ------------------------------------------------------------- embed
    def embed_texts(self, texts: List[str]):
        return self._embed_with_lengths(texts)[0]

    def _embed_with_lengths(self, texts: List[str]):
        """(embeddings (n,D) on the device, real query-token lengths, host
        query tokens and mask (n, max_query_len); stage 2 copies those to the
        device only when it runs)."""
        toks, mask = self.tok.encode_batch(texts, self.max_query_len)
        qlens = mask.sum(axis=1).astype(np.int64).tolist()
        ptoks, pmask, b = pad_to_buckets(toks, mask)
        embs = embed_encode(self.embedder_params, to_device(ptoks, self.device).long(),
                            to_device(pmask, self.device), self.embedder_cfg)[:b]
        return embs, qlens, toks, mask

    # ------------------------------------------------------------- serve
    def handle_batch(self, queries: List[str], *, max_new_tokens: int = 32,
                     collect_meta: bool = False, cost_thresholds=None):
        res = self.handle_batch_result(queries, max_new_tokens=max_new_tokens,
                                       cost_thresholds=cost_thresholds)
        if collect_meta:
            return res.responses, res.meta
        return res.responses

    def _resolve_costs(self, n: int, cost_thresholds) -> List[float]:
        dc = self.router_cfg.default_cost
        if cost_thresholds is None:
            return [dc] * n
        if np.isscalar(cost_thresholds):
            return [float(cost_thresholds)] * n  # hostsync: ok host float cost thresholds
        if len(cost_thresholds) != n:
            raise ValueError(f"{len(cost_thresholds)} cost thresholds for {n} queries")
        # hostsync: ok host float cost thresholds
        return [dc if c is None else float(c) for c in cost_thresholds]

    def handle_batch_result(self, queries: List[str], *, max_new_tokens: int = 32,
                            cost_thresholds=None) -> BatchResult:
        """Serve a batch; responses plus per-request metadata."""
        queries = [tweak_lib.preprocess_query(q) for q in queries]
        n = len(queries)
        if n == 0:
            return BatchResult([], [])
        # fail fast on an unservable budget before any state changes
        self._tweak_encode_len(max_new_tokens)
        cost_l = self._resolve_costs(n, cost_thresholds)
        embs, qlens, qtoks, qmask = self._embed_with_lengths(queries)
        self.stats.baseline_prompt_tokens += sum(qlens)
        cost_dev = (None if cost_thresholds is None
                    else to_device(np.asarray(cost_l, np.float32), self.device))
        d_scores, d_idx, d_dec, d_tau, d_cluster, d_admit = self.bank.route_batch(embs,
                                                                                  cost_dev)
        # THE per-serve-batch device->host sync
        scores, idxs, decisions, admit = _fetch_route(d_scores, d_idx, d_dec, d_admit)
        self.last_route_syncs = 1
        top1 = scores[:, 0]
        slot_arr = idxs[:, 0]
        stage2_rows = decisions == router_lib.UNCERTAIN
        n_unc = int(stage2_rows.sum())  # hostsync: ok host numpy routes
        if n_unc:
            final, slot, _ = self.bank.second_stage(
                to_device(qtoks, self.device).long(), to_device(qmask, self.device),
                d_scores, d_idx, d_dec, d_tau, d_cluster)
            # hostsync: ok the stage-2 fetch, only on batches that hold uncertain rows
            decisions, slot_arr = torch.stack([final, slot.to(torch.int32)]).cpu().numpy()
            self.last_route_syncs = 2
            self.stats.uncertain += n_unc
            # hostsync: ok host numpy routes
            self.stats.recovered += int((decisions[stage2_rows] == router_lib.TWEAK).sum())
        slot_l = slot_arr.tolist()  # hostsync: ok host numpy routes
        dec_l = decisions.tolist()  # hostsync: ok host numpy routes

        responses: List[Optional[str]] = [None] * n
        gen_tokens = [0] * n
        prompt_tokens = [0] * n
        for i in np.nonzero(decisions == router_lib.EXACT)[0]:
            cached = self._text_store.get(slot_l[i])
            responses[i] = cached[1] if cached else self._decode_cached(slot_l[i])
            self.stats.exact += 1
        tweak_ids = np.nonzero(decisions == router_lib.TWEAK)[0]
        if len(tweak_ids):
            self._run_tweak(queries, tweak_ids, slot_l, responses, max_new_tokens,
                            gen_tokens, prompt_tokens)
        miss_ids = np.nonzero(decisions == router_lib.MISS)[0]
        if len(miss_ids):
            self._run_miss(queries, miss_ids, embs, responses, max_new_tokens,
                           gen_tokens, prompt_tokens, admit)

        self.stats.total += n
        bands = np.full(n, -1, np.int32)
        for bi, (lo, hi) in enumerate(router_lib.bands_for(self.router_cfg)):
            bands[(top1 >= lo) & (top1 < hi)] = bi
        top1_l = top1.tolist()  # hostsync: ok host numpy scores
        # hostsync: ok host numpy bands and routes
        meta = [{"sim": top1_l[i], "decision": dec_l[i], "band": int(bands[i]),
                 "gen_tokens": gen_tokens[i], "cost": cost_l[i],
                 "stage2": bool(stage2_rows[i])}  # hostsync: ok host numpy routes
                for i in range(n)]
        miss = decisions == router_lib.MISS
        return BatchResult(
            responses, meta,
            big_tokens=sum(t for i, t in enumerate(gen_tokens) if miss[i]),
            small_tokens=sum(t for i, t in enumerate(gen_tokens) if not miss[i]),
            big_prompt_tokens=sum(t for i, t in enumerate(prompt_tokens) if miss[i]),
            small_prompt_tokens=sum(t for i, t in enumerate(prompt_tokens) if not miss[i]))

    # ------------------------------------------------------------- paths
    def _next_seed(self) -> int:
        return next(self._seed_seq)

    def _decode_slot(self, slot: int, which: str) -> List[int]:
        """A slot's cached ``q`` or ``r`` tokens from the device (a cold
        fallback, and a host sync, when the text mirror lacks the slot)."""
        at = torch.tensor([slot], device=self.device)
        # hostsync: ok cold fallback read of a slot the text mirror lacks
        toks = cache_lib.gather_rows(self.state, f"{which}_tokens", at)[0].tolist()
        # hostsync: ok cold fallback read of a slot the text mirror lacks
        mask = cache_lib.gather_rows(self.state, f"{which}_mask", at)[0].tolist()
        return [t for t, m in zip(toks, mask) if m > 0]

    def _decode_cached(self, slot: int) -> str:
        return self.tok.decode_ids(self._decode_slot(slot, "r"))

    def _decode_cached_query(self, slot: int) -> str:
        return self.tok.decode_ids([t for t in self._decode_slot(slot, "q")
                                    if t != self.tok.bos])

    @staticmethod
    def _visible_ids(row: np.ndarray, n_gen: int, ended: bool) -> List[int]:
        """Visible ids of a generated row: everything before its EOS."""
        return row[:n_gen - 1 if ended else n_gen].tolist()  # hostsync: ok host numpy tokens

    def _tweak_static_tokens(self, suffix_only: bool = False) -> int:
        if self._static_counts is None:
            self._static_counts = (
                tweak_lib.static_token_count(self.tok),
                tweak_lib.static_token_count(self.tok, suffix_only=True))
        return self._static_counts[1 if suffix_only else 0]

    def _tweak_encode_len(self, max_new_tokens: int) -> int:
        """Prompt-token budget for the tweak path, bucket-rounding-safe
        (see the reference for the reasoning); raises when nothing fits."""
        msl = self.small.model.cfg.max_seq_len
        budget = msl - max_new_tokens - 1
        if budget < 1:
            raise ValueError(
                f"max_new_tokens={max_new_tokens} leaves no room for the "
                f"tweak prompt: small model max_seq_len={msl} requires "
                f"max_new_tokens <= {msl - 2}")
        if bucket_len(budget) + max_new_tokens + 1 > msl:
            budget = floor_len_bucket(budget)
            if bucket_len(budget) + max_new_tokens + 1 > msl:
                raise ValueError(
                    f"max_new_tokens={max_new_tokens} leaves no length "
                    f"bucket for the tweak prompt within small model "
                    f"max_seq_len={msl} (smallest bucket rounds past it)")
        statics = self._tweak_static_tokens()
        if budget < statics:
            raise ValueError(
                f"max_new_tokens={max_new_tokens} leaves a {budget}-token "
                f"tweak prompt budget, below the {statics} tokens the "
                f"static Appendix-A segments need — lower max_new_tokens "
                f"or raise the small model's max_seq_len={msl}")
        return budget

    # ------------------------------------------------- tweak prefix cache
    def _tweak_prefix_ids(self) -> Tuple[int, ...]:
        if self._prefix_ids is None:
            self._prefix_ids = tuple(tweak_lib.tweak_prefix_ids(self.tok))
        return self._prefix_ids

    def _prefix_path_available(self) -> bool:
        return (self.use_prefix_cache
                and getattr(self.small, "supports_prefix_prefill", False)
                and callable(getattr(self.small, "build_prefix_cache", None)))

    def _small_prefix_cache(self, batch: int):
        """The instruction-prefix PrefixCache for one batch bucket, rebuilt
        when the small generator object, its configs or the ids change."""
        ids = self._tweak_prefix_ids()
        sig = (id(self.small), self.small.model.cfg, getattr(self.small, "cfg", None), ids)
        if sig != self._prefix_sig:
            self._prefix_caches.clear()
            self._prefix_sig = sig
        pc = self._prefix_caches.get(batch)
        if pc is None:
            pc = self.small.build_prefix_cache(ids, batch)
            self._prefix_caches[batch] = pc
        return pc

    def _tweak_suffix_budget(self, max_new_tokens: int, prefix_len: int) -> Optional[int]:
        """Per-row suffix budget for the prefix-cached prefill, or None when
        no bucket fits (the caller then takes the full-prompt path)."""
        msl = self.small.model.cfg.max_seq_len
        budget = msl - max_new_tokens - 1 - prefix_len
        if budget < 1:
            return None
        if bucket_len(budget) + prefix_len + max_new_tokens + 1 > msl:
            budget = floor_len_bucket(budget)
            if bucket_len(budget) + prefix_len + max_new_tokens + 1 > msl:
                return None
        if budget < self._tweak_static_tokens(suffix_only=True):
            return None
        return budget

    def _run_tweak(self, queries, ids, slot_l, responses, max_new_tokens,
                   gen_tokens, prompt_tokens):
        slots = [slot_l[i] for i in ids]
        cached = []
        for s in slots:
            c = self._text_store.get(s)
            if c is None:
                c = (self._decode_cached_query(s), self._decode_cached(s))
            cached.append(c)
        new_qs = [queries[i] for i in ids]
        cqs = [cq for cq, _ in cached]
        crs = [cr for _, cr in cached]
        drafts = self._tweak_drafts(slots, crs, max_new_tokens)
        suffix_budget = None
        if self._prefix_path_available():
            suffix_budget = self._tweak_suffix_budget(max_new_tokens,
                                                      len(self._tweak_prefix_ids()))
        if suffix_budget is None:
            self._run_tweak_full(new_qs, cqs, crs, ids, responses, max_new_tokens,
                                 gen_tokens, prompt_tokens, drafts)
        else:
            self._run_tweak_prefixed(new_qs, cqs, crs, ids, responses, max_new_tokens,
                                     suffix_budget, gen_tokens, prompt_tokens, drafts)

    def _tweak_drafts(self, slots, crs, max_new_tokens):
        """Per-row speculation drafts for a TWEAK sub-batch, or None.

        The tweak prompt asks the small model for a light edit of the cached
        response, so the cached response's own token ids plus EOS are the
        draft.  Ids come from the bank's draft store, with a tokenized-text
        fallback for slots populated elsewhere.  Returns ``(ids (B, D), lens
        (B,))``, or None when the small generator is not speculation-ready
        or the budget is below ``spec_k``.
        """
        if not getattr(self.small, "speculation_ready", False):
            return None
        if self.small.cfg.spec_k > max_new_tokens:
            return None
        eos = self.small.cfg.eos_id
        rows = []
        for s, cr in zip(slots, crs):
            ids = self.bank.draft_store.get(s)
            if ids is None:
                t, m = self.tok.encode_batch([cr], self.cache_cfg.max_response_tokens,
                                             add_bos=False)
                # hostsync: ok host numpy tokenizer output
                ids = [tt for tt, mm in zip(t[0].tolist(), m[0].tolist()) if mm > 0]
            rows.append(list(ids) + [eos])
        width = max(len(r) for r in rows)
        did = np.full((len(rows), width), eos, np.int32)
        for j, r in enumerate(rows):
            did[j, :len(r)] = r
        return did, np.asarray([len(r) for r in rows], np.int32)

    def _bill_spec_stats(self):
        """Fold the small generator's last speculative call into stats."""
        st = getattr(self.small, "last_spec_stats", None)
        if st:
            self.stats.proposed += st["proposed"]
            self.stats.accepted += st["accepted"]
            self.stats.spec_steps += st["spec_steps"]

    @staticmethod
    def _pad_drafts(drafts, rows: int):
        """Empty drafts for the batch-bucket padding rows."""
        did, dlen = drafts
        pad = rows - did.shape[0]
        if pad:
            did = np.concatenate([did, np.zeros((pad, did.shape[1]), did.dtype)])
            dlen = np.concatenate([dlen, np.zeros((pad,), dlen.dtype)])
        return did, dlen

    def _emit_tweak_rows(self, rows, ids, out, lengths, ended, responses, gen_tokens):
        lengths = lengths.tolist()  # hostsync: ok host numpy lengths
        ended = ended.tolist()  # hostsync: ok host numpy flags
        for j, row in enumerate(rows):
            i = ids[row]
            n_gen = lengths[j]
            responses[i] = self.tok.decode_ids(self._visible_ids(out[j], n_gen, ended[j]))
            self.stats.small_tokens += n_gen
            self.stats.tweak += 1
            gen_tokens[i] = n_gen

    def _run_tweak_full(self, new_qs, cqs, crs, ids, responses, max_new_tokens,
                        gen_tokens, prompt_tokens, drafts=None):
        """Prefill the whole Appendix-A prompt (no prefix reuse)."""
        toks, mask = tweak_lib.build_tweak_batch(
            self.tok, new_qs, cqs, crs, self._tweak_encode_len(max_new_tokens))
        real_lens = mask.sum(axis=1).astype(np.int64).tolist()
        toks, mask, _ = pad_to_buckets(toks, mask)
        kw = {} if drafts is None else {"drafts": self._pad_drafts(drafts, toks.shape[0])}
        out, lengths, ended = self.small.generate_with_lengths(
            {"tokens": toks}, max_new_tokens=max_new_tokens, seed=self._next_seed(), **kw)
        if drafts is not None:
            self._bill_spec_stats()
        self._emit_tweak_rows(range(len(ids)), ids, out, lengths, ended, responses,
                              gen_tokens)
        for j, i in enumerate(ids):
            prompt_tokens[i] = real_lens[j]
            self.stats.small_prompt_tokens += real_lens[j]

    def _run_tweak_prefixed(self, new_qs, cqs, crs, ids, responses, max_new_tokens,
                            suffix_budget, gen_tokens, prompt_tokens, drafts=None):
        """Shared-prefix KV reuse, rows grouped by the length bucket of their
        REAL suffix."""
        prefix_ids = self._tweak_prefix_ids()
        toks, mask = tweak_lib.build_tweak_suffix_batch(self.tok, new_qs, cqs, crs,
                                                        suffix_budget)
        real_lens = mask.sum(axis=1).astype(np.int64).tolist()
        groups: Dict[int, List[int]] = {}
        for row, rl in enumerate(real_lens):
            groups.setdefault(bucket_len(max(rl, 1)), []).append(row)
        for bucket in sorted(groups):
            rows = groups[bucket]
            sub_t = pad_to_buckets(toks[rows][:, :bucket], mask[rows][:, :bucket])[0]
            pc = self._small_prefix_cache(sub_t.shape[0])
            kw = {}
            if drafts is not None:
                kw["drafts"] = self._pad_drafts((drafts[0][rows], drafts[1][rows]),
                                                sub_t.shape[0])
            out, lengths, ended = self.small.generate_with_lengths(
                {"tokens": sub_t}, max_new_tokens=max_new_tokens, seed=self._next_seed(),
                prefix_cache=pc, **kw)
            if drafts is not None:
                self._bill_spec_stats()
            self._emit_tweak_rows(rows, ids, out, lengths, ended, responses, gen_tokens)
            for row in rows:
                real = len(prefix_ids) + real_lens[row]
                prompt_tokens[ids[row]] = real
                self.stats.small_prompt_tokens += real

    def _insert_entries(self, texts, resp_tokens, resp_texts, embs):
        """Commit entries to the bank in one call (one host copy of slots),
        then the bank's IVF maintenance."""
        n = len(texts)
        ccfg = self.cache_cfg
        qt, qm = self.tok.encode_batch(texts, ccfg.max_query_tokens)
        rt = np.zeros((n, ccfg.max_response_tokens), np.int32)
        rm = np.zeros((n, ccfg.max_response_tokens), np.float32)
        for j, ids in enumerate(resp_tokens):
            rl = min(len(ids), ccfg.max_response_tokens)
            rt[j, :rl] = ids[:rl]
            rm[j, :rl] = 1.0
        nb = bucket_batch(n)
        pad = lambda a: (np.concatenate([a, np.zeros((nb - n,) + a.shape[1:], a.dtype)])
                         if nb > n else a)
        if nb > n:
            embs = torch.cat([embs, embs.new_zeros((nb - n, embs.shape[1]))])
        dev = self.device
        slots = self.bank.insert_batch(embs, to_device(pad(qt), dev), to_device(pad(qm), dev),
                                       to_device(pad(rt), dev), to_device(pad(rm), dev), n)
        # hostsync: ok the one host copy of the slots per insert
        slots = slots.cpu().numpy().tolist()  # the one host copy per insert
        for j in range(n):
            self._text_store[slots[j]] = (texts[j], resp_texts[j])
            self.bank.draft_store[slots[j]] = list(resp_tokens[j])
        self.bank.maybe_reindex()

    def _run_miss(self, queries, ids, embs, responses, max_new_tokens,
                  gen_tokens, prompt_tokens, admit=None):
        texts = [queries[i] for i in ids]
        toks, mask = self.tok.encode_batch(texts, self.max_query_len)
        real_lens = mask.sum(axis=1).astype(np.int64).tolist()
        toks, mask, _ = pad_to_buckets(toks, mask)
        out, lengths, ended = self.big.generate_with_lengths(
            {"tokens": toks}, max_new_tokens=max_new_tokens, seed=self._next_seed())
        lengths = lengths.tolist()  # hostsync: ok host numpy lengths
        ended = ended.tolist()  # hostsync: ok host numpy flags
        resp_tokens, resp_texts = [], []
        for j, i in enumerate(ids):
            n_gen = lengths[j]
            visible = self._visible_ids(out[j], n_gen, ended[j])
            resp_text = self.tok.decode_ids(visible)
            responses[i] = resp_text
            resp_tokens.append(visible)
            resp_texts.append(resp_text)
            self.stats.big_tokens += n_gen
            self.stats.big_prompt_tokens += real_lens[j]
            self.stats.miss += 1
            gen_tokens[i] = n_gen
            prompt_tokens[i] = real_lens[j]
        # admission control: the response is served either way, but rows of
        # a cluster whose hit EMA has shut are not cached
        keep = [j for j, i in enumerate(ids) if admit is None or admit[i]]
        self.stats.suppressed_inserts += len(ids) - len(keep)
        if not keep:
            return
        rows = to_device(np.asarray([ids[j] for j in keep], np.int64), self.device)
        self._insert_entries([texts[j] for j in keep], [resp_tokens[j] for j in keep],
                             [resp_texts[j] for j in keep], embs[rows])

    # ------------------------------------------------- offline population
    def populate(self, queries: List[str], responses: List[str]):
        """Bulk-insert known (query, response) pairs."""
        if len(queries) != len(responses):
            raise ValueError(f"populate got {len(queries)} queries but "
                             f"{len(responses)} responses")
        if not queries:
            return
        queries = [tweak_lib.preprocess_query(q) for q in queries]
        embs = self.embed_texts(queries)
        rt, rm = self.tok.encode_batch(responses, self.cache_cfg.max_response_tokens,
                                       add_bos=False)
        rt_l, rm_l = rt.tolist(), rm.tolist()  # hostsync: ok host numpy tokenizer output
        resp_tokens = [[t for t, m in zip(rt_l[i], rm_l[i]) if m > 0]
                       for i in range(len(queries))]
        self._insert_entries(queries, resp_tokens, responses, embs)


class ReplicaGroup:
    """N engine replicas over one shared cache bank, or private ones.

    The generators are shared handles or built per replica; the bank is ONE
    ``SharedCacheBank`` serving every replica (``shared=False`` gives each a
    private bank, the baseline the reference's replica bench compares
    against).  The replicas run one after another in one process, as the
    reference's do.
    """

    def __init__(self, engines: List[TweakLLMEngine]):
        if not engines:
            raise ValueError("ReplicaGroup needs at least one engine")
        self.engines = list(engines)

    @classmethod
    def build(cls, n: int, *, tokenizer, embedder_params, embedder_cfg, big, small,
              cache_cfg: cache_lib.CacheConfig,
              router_cfg: Optional[router_lib.RouterConfig] = None, shared: bool = True,
              mesh=None, reranker=None, **engine_kw) -> "ReplicaGroup":
        """``n`` replicas.  ``big``/``small`` are generators shared by every
        replica, or callables ``replica_id -> Generator`` for per-replica
        handles (distinct KV pools).  ``mesh`` row-shards each bank."""
        dev = embedder_params["embed"].device

        def bank():
            return SharedCacheBank(cache_cfg, router_cfg, device=dev, mesh=mesh,
                                   reranker=reranker)

        one = bank() if shared else None
        return cls([TweakLLMEngine(
            tokenizer=tokenizer, embedder_params=embedder_params, embedder_cfg=embedder_cfg,
            big=big(rid) if callable(big) else big,
            small=small(rid) if callable(small) else small,
            bank=one if shared else bank(), replica_id=rid, **engine_kw)
            for rid in range(n)])

    def __len__(self) -> int:
        return len(self.engines)

    def __getitem__(self, rid: int) -> TweakLLMEngine:
        return self.engines[rid]

    @property
    def shared(self) -> bool:
        return all(e.bank is self.engines[0].bank for e in self.engines)

    @property
    def bank(self) -> SharedCacheBank:
        if not self.shared:
            raise ValueError("replicas hold private banks; no single bank")
        return self.engines[0].bank

    @property
    def stats(self) -> EngineStats:
        """Serve counters summed over every replica."""
        return EngineStats.aggregate(e.stats for e in self.engines)

    def leaked_kv_pages(self) -> List[int]:
        """Per-replica leaked (live minus pinned) KV pages of paged pools;
        every entry must be 0 once all work is harvested."""
        return [leaked_pages(e.big, e.small) for e in self.engines]
