"""Persistent slot-based decode over the paged KV pool (counterpart of
``src/repro/serving/continuous.py``).

``DecodeSession`` removes the bucket barrier of batch-to-completion
serving: a fixed set of ``slots`` rows decodes together, finished rows are
harvested and their pages freed between chunks, and new requests are
spliced into the free slots — mid-flight join and leave.

  admit(prompts) -> dense prefill at the cohort's shape, pages allocated,
                    KV scattered and the rows spliced in; the first token
                    is sampled from the prefill logits
  run_chunk(n)   -> n decode steps over every slot, no host sync
  harvest()      -> the one device->host copy per chunk; finished rows
                    return (tokens, length, ended), their block tables
                    point at the TRASH page (so freed pages can be re-issued
                    without being stomped) and their pages are freed

A fused chunk runs its full ``steps`` with done-masking: the JAX chunk
exits early on the device once no row is active, which eager PyTorch could
only decide with a host sync per step.  The extra steps change nothing a
caller sees: finished and empty rows emit nothing, their writes go to their
own pages or to TRASH, and harvest resets them.  ``run_chunk(fused=False)``
is the host-stepped oracle (one sync per step, stopping when no row is
active, as the JAX loop does).

Contracts held by the tests: a cohort that fills every slot at step 0 and
runs to completion equals ``Generator.generate_with_lengths`` (dense) at the
same capacity; fused chunks equal the oracle; under greedy decoding a row's
tokens do not depend on chunk size or on co-resident rows.  Under
temperature sampling the draws of a chunk's extra steps shift later draws,
so those equalities are greedy-only.

A ``spec_k > 1`` session decodes in (slots, k) verify blocks: a row admitted
with a draft (the cached response) accepts the longest matching prefix plus
one correction token per block, a row without one accepts one token, and the
rejected positions are rewound.  A chunk step is one verify block; the
tokens equal the plain session's.  Done-masked blocks accept nothing, so
``spec_stats`` counts exactly the JAX loop's iterations.

State lives on the generator's device; page writes and slot updates are in
place (the JAX package donates the state).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import to_device

from . import paged_kv as paged_lib
from .generate import Generator
from .sampler import greedy_ids, mask_vocab, sample


class NoFreeSlots(RuntimeError):
    """Admission rejected: every slot is occupied.  Harvest first."""


class FinishedRow(dict):
    """One harvested row: {"slot", "tag", "tokens", "length", "ended"}."""


class DecodeSession:
    """A persistent decode batch over ``slots`` rows of paged KV.

    Owns a ``PagePool`` sized for its slots; the generator supplies the
    model, parameters, sampler and device.  ``capacity`` is one static bound
    for every row; admission raises rather than truncates when a prompt
    would not fit.
    """

    def __init__(self, gen: Generator, *, slots: int, capacity: int, seed: int = 0,
                 spec_k: int = 1):
        if not gen.model.supports_paged_decode:
            raise NotImplementedError(f"{gen.model.cfg.name}: paged KV decode unsupported")
        if spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {spec_k}")
        if spec_k > 1:
            # speculation is lossless only under greedy argmax
            if gen.cfg.sampler.temperature > 0:
                raise ValueError("spec_k > 1 requires greedy sampling "
                                 f"(temperature={gen.cfg.sampler.temperature})")
            if not gen.model.supports_spec_decode:
                raise ValueError(f"{gen.model.cfg.name}: speculative decode unsupported "
                                 f"for this architecture")
            if spec_k > gen.cfg.max_new_tokens:
                raise ValueError(f"spec_k={spec_k} exceeds the "
                                 f"max_new_tokens={gen.cfg.max_new_tokens} budget")
        self.gen = gen
        self.model = gen.model
        self.params = gen.params
        self.cfg = gen.cfg
        self.device = gen.device
        self.slots = slots
        self.capacity = capacity
        self.spec_k = spec_k
        self.mnt = gen.cfg.max_new_tokens
        self.pool = paged_lib.PagePool(
            gen.model, paged_lib.PagePoolConfig(
                page_size=gen.cfg.page_size,
                num_pages=max(gen.cfg.pool_pages, slots * (-(-capacity // gen.cfg.page_size)))),
            self.device)
        self._leases: Dict[int, Any] = {}     # slot -> (tbl_row, writable_row)
        self._tags: Dict[int, Any] = {}       # slot -> caller's request tag
        self._free_slots: List[int] = list(range(slots - 1, -1, -1))
        self._rng = torch.Generator(device=self.device)
        self._rng.manual_seed(int(seed))  # hostsync: ok host int seed
        self._cols = torch.arange(self.mnt, dtype=torch.int32, device=self.device)[None, :]
        self.state = self._init_state()

    # ------------------------------------------------------------- state
    def _init_state(self):
        b, mnt, eos = self.slots, self.mnt, self.cfg.eos_id
        npg = self.pool.pages_per_seq(self.capacity)
        dev = self.device

        def empty(pool_leaf):
            layers = pool_leaf["kp"].shape[0]
            return {"kp": pool_leaf["kp"], "vp": pool_leaf["vp"],
                    "block_tbl": torch.full((b, npg), self.pool.trash_page,
                                            dtype=torch.int32, device=dev),
                    "slot_pos": torch.full((layers, b, self.capacity), -1,
                                           dtype=torch.int32, device=dev)}

        caches = paged_lib.map_kv_leaves(self.pool.storage, empty)
        caches["pos"] = torch.zeros(b, dtype=torch.int32, device=dev)
        state = {
            "caches": caches,
            "tok": torch.full((b,), eos, dtype=torch.int32, device=dev),
            "toks": torch.full((b, mnt), eos, dtype=torch.int32, device=dev),
            "n_emitted": torch.zeros(b, dtype=torch.int32, device=dev),
            "lengths": torch.zeros(b, dtype=torch.int32, device=dev),
            "eos_done": torch.zeros(b, dtype=torch.bool, device=dev),
            "occupied": torch.zeros(b, dtype=torch.bool, device=dev),
        }
        if self.spec_k > 1:
            state.update(
                draft=torch.zeros((b, mnt), dtype=torch.int32, device=dev),
                draft_len=torch.zeros(b, dtype=torch.int32, device=dev),
                spec_on=torch.zeros(b, dtype=torch.bool, device=dev),
                prop=torch.zeros((), dtype=torch.int32, device=dev),
                acc=torch.zeros((), dtype=torch.int32, device=dev),
                spec_steps=torch.zeros((), dtype=torch.int32, device=dev))
        return state

    def _splice(self, dense, logits0, slot_ids, tbl, writable, drafts=None):
        """Scatter a prefilled cohort's KV into its pages and splice its rows
        into ``slot_ids``; sample the first token from the prefill logits.  A
        spec session also splices the cohort's drafts ``(ids (k, mnt), lens
        (k,))`` and arms speculation for rows whose draft predicted the first
        token, so mid-flight joins speculate as inaugural rows do."""
        st = self.state
        for leaf, d in zip(paged_lib.kv_leaves(st["caches"]), paged_lib.kv_leaves(dense)):
            paged_lib.scatter_pages(leaf["kp"], leaf["vp"], d["k"], d["v"], tbl, writable)
            leaf["block_tbl"][slot_ids] = tbl
            leaf["slot_pos"][:, slot_ids] = d["slot_pos"]
        # hostsync: ok the dense prefill's host-int pos
        st["caches"]["pos"][slot_ids] = int(dense["pos"])
        t0 = sample(logits0, self.cfg.sampler, self._rng)
        done0 = t0 == self.cfg.eos_id
        row_toks = torch.full((t0.shape[0], self.mnt), self.cfg.eos_id, dtype=torch.int32,
                              device=self.device)
        row_toks[:, 0] = t0
        st["tok"][slot_ids] = t0
        st["toks"][slot_ids] = row_toks
        st["n_emitted"][slot_ids] = 1
        st["lengths"][slot_ids] = torch.where(done0, 1, self.mnt).to(torch.int32)
        st["eos_done"][slot_ids] = done0
        st["occupied"][slot_ids] = True
        if drafts is not None:
            did, dlen = drafts
            st["draft"][slot_ids] = did
            st["draft_len"][slot_ids] = dlen
            st["spec_on"][slot_ids] = ~done0 & (dlen > 0) & (t0 == did[:, 0])

    def _active(self):
        st = self.state
        return st["occupied"] & ~st["eos_done"] & (st["n_emitted"] < self.mnt)

    def _step(self):
        """One decode step over every slot (the JAX chunk body): per-row write
        columns, so rows at different depths decode together."""
        st = self.state
        eos = self.cfg.eos_id
        logits, st["caches"] = self.model.decode_step(self.params, st["tok"], st["caches"])
        inactive = ~st["occupied"] | st["eos_done"] | (st["n_emitted"] >= self.mnt)
        t = torch.where(inactive, eos, sample(logits, self.cfg.sampler, self._rng))
        t = t.to(torch.int32)
        new_eos = st["eos_done"] | (~inactive & (t == eos))
        col = st["n_emitted"]
        hot = (self._cols == col[:, None]) & ~inactive[:, None]
        st["toks"] = torch.where(hot, t[:, None], st["toks"])
        st["lengths"] = torch.where(new_eos & ~st["eos_done"], col + 1, st["lengths"])
        st["n_emitted"] = torch.where(inactive, col, col + 1)
        st["tok"], st["eos_done"] = t, new_eos

    def _step_spec(self):
        """One (slots, k) verify block over every row (the JAX package's
        ``step_body_spec``).  A speculating row verifies ``[last token,
        draft...]`` and accepts ``a`` in [1, k] tokens; any other active row
        accepts its one greedy token (position 0 of the block is the plain
        step, in-block causal masking hides the optimistic writes); an
        inactive row accepts none.  The k - a rejected positions are
        rewound, so a block in which no row is active changes nothing."""
        st = self.state
        k, mnt, eos = self.spec_k, self.mnt, self.cfg.eos_id
        tok, ne = st["tok"], st["n_emitted"]
        draft, dlen = st["draft"], st["draft_len"]
        act = self._active()
        spec = act & st["spec_on"]
        iota_k = torch.arange(k, dtype=torch.int32, device=self.device)
        dpos = ne[:, None] + iota_k[None, :k - 1]                   # (B,k-1)
        dval = draft.gather(1, dpos.clamp(0, mnt - 1).long())
        x = torch.cat([tok[:, None], dval], dim=1)                   # (B,k)
        logits, st["caches"] = self.model.decode_block(self.params, x, st["caches"])
        g = greedy_ids(mask_vocab(logits, self.cfg.sampler))         # (B,k)
        match = (g[:, :k - 1] == dval) & (dpos < dlen[:, None])
        lmatch = match.to(torch.int32).cumprod(dim=1).sum(dim=1).to(torch.int32)
        eos_idx = torch.where(g == eos, iota_k[None, :], k).amin(dim=1)
        a_spec = torch.minimum(torch.minimum(lmatch + 1, eos_idx + 1), mnt - ne)
        a = torch.where(spec, a_spec, act.to(torch.int32)).to(torch.int32)
        tlast = g.gather(1, (a - 1).clamp(0, k - 1)[:, None].long())[:, 0]
        ended_now = (a > 0) & (tlast == eos)
        st["lengths"] = torch.where(ended_now, ne + a, st["lengths"])
        sel = (self._cols - ne[:, None]).clamp(0, k - 1)
        in_rng = (self._cols >= ne[:, None]) & (self._cols < (ne + a)[:, None])
        st["toks"] = torch.where(in_rng, g.gather(1, sel.long()), st["toks"])
        st["tok"] = torch.where(a > 0, tlast, tok)
        st["caches"] = paged_lib.rewind_kv(st["caches"], k - a)
        ne2 = ne + a
        n_fed = (dlen - ne).clamp(0, k - 1)
        st["n_emitted"] = ne2
        st["eos_done"] = st["eos_done"] | ended_now
        # full acceptance keeps a row speculating; rejection or exhaustion drops it
        st["spec_on"] = spec & (a == k) & (ne2 < dlen)
        st["prop"] = st["prop"] + torch.where(spec, n_fed, 0).sum().to(torch.int32)
        st["acc"] = st["acc"] + torch.where(spec, torch.minimum(lmatch, a), 0).sum().to(
            torch.int32)
        st["spec_steps"] = st["spec_steps"] + spec.any().to(torch.int32)

    def _evict(self, slot_ids):
        """Clear harvested slots: block tables -> TRASH so the freed pages can
        be re-issued without being stomped."""
        st = self.state
        for leaf in paged_lib.kv_leaves(st["caches"]):
            leaf["block_tbl"][slot_ids] = self.pool.trash_page
            leaf["slot_pos"][:, slot_ids] = -1
        st["caches"]["pos"][slot_ids] = 0
        st["tok"][slot_ids] = self.cfg.eos_id
        st["toks"][slot_ids] = self.cfg.eos_id
        st["n_emitted"][slot_ids] = 0
        st["lengths"][slot_ids] = 0
        st["eos_done"][slot_ids] = False
        st["occupied"][slot_ids] = False
        if self.spec_k > 1:
            st["draft"][slot_ids] = 0
            st["draft_len"][slot_ids] = 0
            st["spec_on"][slot_ids] = False

    # --------------------------------------------------------- protocol
    @property
    def free_slots(self) -> int:
        return len(self._free_slots)

    @property
    def spec_stats(self) -> Dict[str, int]:
        """Cumulative speculation counters: ``proposed`` drafted tokens fed to
        verify blocks, ``accepted`` drafted tokens emitted, ``spec_steps``
        verify blocks with at least one speculating row.  Reading them costs
        one device->host copy (nothing on a ``spec_k == 1`` session)."""
        if self.spec_k == 1:
            return {"proposed": 0, "accepted": 0, "spec_steps": 0}
        st = self.state
        # hostsync: ok stats readout at a step boundary, caller-paced
        prop, acc, steps = torch.stack([st["prop"], st["acc"], st["spec_steps"]]).tolist()
        return {"proposed": prop, "accepted": acc, "spec_steps": steps}

    def admit(self, tokens, tags: Optional[Sequence[Any]] = None,
              slots: Optional[Sequence[int]] = None, drafts=None) -> List[int]:
        """Splice a cohort of prompts (k, S) into free slots; returns the slot
        ids used.  ``tags`` ride along to ``harvest``; ``slots`` pins
        explicit slot choices.  ``drafts`` is an optional ``(ids (k, D), lens
        (k,))`` pair of host ints, per-row draft continuations (cached
        response ids) that a ``spec_k > 1`` session verifies in k-wide
        blocks; rows with ``lens == 0`` decode plainly.  All or nothing:
        raises ``NoFreeSlots``, ``PagePoolExhausted`` or ``ValueError``
        before touching the state.
        """
        if drafts is not None and self.spec_k == 1:
            raise ValueError("drafts require a spec_k > 1 session")
        tokens = to_device(np.asarray(tokens), self.device).long()
        k, s = tokens.shape
        if s + self.mnt + 1 > self.capacity:
            raise ValueError(f"prompt of {s} tokens + {self.mnt} new exceeds session "
                             f"capacity {self.capacity}")
        if slots is None:
            if k > len(self._free_slots):
                raise NoFreeSlots(f"cohort of {k} rows, {len(self._free_slots)} free slots")
            chosen = [self._free_slots[-1 - i] for i in range(k)]
        else:
            chosen = [int(x) for x in slots]  # hostsync: ok caller-supplied host ints
            if len(chosen) != k or len(set(chosen)) != k:
                raise ValueError("slots must name one distinct free slot per row")
            if any(c not in self._free_slots for c in chosen):
                raise NoFreeSlots(f"requested slots {chosen} not all free")
        spec = None
        if self.spec_k > 1:
            # pad or clip to the mnt-column draft block the verify body indexes
            pack = np.zeros((k, self.mnt + 1), np.int32)
            if drafts is not None:
                raw_ids = np.asarray(drafts[0], np.int32)
                w = min(raw_ids.shape[1], self.mnt)
                pack[:, 1:1 + w] = raw_ids[:, :w]
                pack[:, 0] = np.minimum(np.asarray(drafts[1], np.int32), self.mnt)
            pack = to_device(pack, self.device)
            spec = (pack[:, 1:], pack[:, 0])
        tbl, writable = self.pool.alloc_block_table(k, self.capacity)
        try:
            logits0, dense = self.model.prefill(self.params, {"tokens": tokens},
                                                self.capacity)
            self._splice(dense, logits0, to_device(np.asarray(chosen, np.int64), self.device),
                         to_device(tbl.astype(np.int32), self.device),
                         to_device(writable, self.device), spec)
        except Exception:
            self.pool.free_block_table(tbl, writable)
            raise
        for i, c in enumerate(chosen):
            self._free_slots.remove(c)
            self._leases[c] = (tbl[i], writable[i])
            self._tags[c] = None if tags is None else tags[i]
        return chosen

    def run_chunk(self, steps: int, *, fused: bool = True) -> None:
        """Advance every occupied row by ``steps`` decode steps.

        ``fused=True`` enqueues the steps with no host sync (all ``steps``,
        done-masked); ``fused=False`` is the host-stepped oracle, one sync
        per step, stopping once no row is active.  On a ``spec_k > 1``
        session a step is one verify block, up to ``spec_k`` tokens a row.
        """
        step = self._step_spec if self.spec_k > 1 else self._step
        for _ in range(steps):
            # hostsync: ok the host-stepped oracle syncs per step by design
            if not fused and not bool(self._active().any()):
                break
            step()

    def harvest(self) -> List[FinishedRow]:  # hostsync: ok THE one per-chunk copy
        """Collect finished rows, free their pages, clear their slots.

        THE one device->host copy per chunk: flags, lengths and the token
        block come back in a single transfer.
        """
        st = self.state
        packed = torch.cat([st["toks"], st["lengths"][:, None], st["n_emitted"][:, None],
                            st["occupied"][:, None].to(torch.int32),
                            st["eos_done"][:, None].to(torch.int32)], dim=1).cpu().numpy()
        mnt = self.mnt
        toks, lengths, n_emitted = packed[:, :mnt], packed[:, mnt], packed[:, mnt + 1]
        occupied, eos_done = packed[:, mnt + 2].astype(bool), packed[:, mnt + 3].astype(bool)
        fin = np.flatnonzero(occupied & (eos_done | (n_emitted >= mnt)))
        if fin.size == 0:
            return []
        out = [FinishedRow(slot=int(c), tag=self._tags.pop(int(c)), tokens=toks[c].copy(),
                           length=int(lengths[c]), ended=bool(eos_done[c])) for c in fin]
        self._evict(to_device(fin.astype(np.int64), self.device))
        for c in fin:
            self.pool.free_block_table(*self._leases.pop(int(c)))
            self._free_slots.append(int(c))
        self._free_slots.sort(reverse=True)
        return out

    def drain(self, *, chunk: int = 0, fused: bool = True) -> List[FinishedRow]:
        """Run chunks until every occupied slot has finished and been
        harvested (end of stream).  ``chunk=0`` uses the full budget."""
        steps = chunk or self.mnt
        out: List[FinishedRow] = []
        for _ in range(self.slots * self.mnt + 1):
            if len(self._free_slots) == self.slots:
                break
            self.run_chunk(steps, fused=fused)
            out.extend(self.harvest())
        return out


def leaked_pages(*owners) -> int:
    """Total leaked (live minus pinned) KV pages across paged generators or
    sessions: once every request is harvested it must be 0.  Dense
    generators have no pool; repeated objects count once."""
    total = 0
    for owner in {id(o): o for o in owners}.values():
        pool = getattr(owner, "pool", None)
        if pool is not None:
            total += pool.live_pages - pool.pinned_pages
    return total
