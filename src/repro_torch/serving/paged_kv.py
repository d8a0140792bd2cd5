"""Paged KV pool: fixed-size pages, a free-list allocator, refcounted
sharing (counterpart of ``src/repro/serving/paged_kv.py``).

* **Storage** — per attention stack, K/V live in ``(layers, P+1, page, Hk,
  dh)`` page tensors, matching the dense cache's stacked ``(layers, B, cap,
  Hk, dh)``.  A sequence owns a *block table*: the page ids backing its
  logical slots ``[0, capacity)`` in order.  Page ``P`` (the last) is the
  TRASH page: writes of evicted or empty rows land there, so a freed page
  can be re-issued without being stomped.
* **Allocator** — a host-side LIFO free list and per-page refcounts, plain
  numpy on host values: allocation costs no device sync.  Exhaustion
  raises ``PagePoolExhausted`` before any state changes.
* **Pinned prefixes** — the shared tweak prefix is written into pages once
  and pinned; every TWEAK row's block table points at those pages
  (refcount += rows).  Only whole pages are shared; the prefix remainder
  rides in each row's first private page.

A paged cache keeps the port's caches structure ``{"scan": (leaf,), "rem":
(), "pos"}`` with the leaf ``{"kp", "vp", "block_tbl" (B,npg) int32,
"slot_pos" (layers,B,cap) int32}`` and ``pos`` per row, a ``(B,)`` int32
device tensor.  The JAX package donates the pool to its jitted writers;
here the page writes are in place on the pool's tensors, so the caches
and ``PagePool.storage`` share them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device, to_device


class PagePoolExhausted(RuntimeError):
    """Allocation rejected: not enough free pages.  Pool state unchanged."""


# ------------------------------------------------------------ tree utils

def _is_dense_leaf(x) -> bool:
    return isinstance(x, dict) and {"k", "v", "slot_pos"} <= set(x)


def _is_paged_leaf(x) -> bool:
    return isinstance(x, dict) and "kp" in x


def map_kv_leaves(tree, fn):
    """Map ``fn`` over every KV leaf dict of a caches tree; other entries
    (the top-level ``pos``) pass through untouched."""
    if _is_dense_leaf(tree) or _is_paged_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_kv_leaves(v, fn) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_kv_leaves(v, fn) for v in tree)
    return tree


def kv_leaves(tree) -> List[dict]:
    """The KV leaf dicts of a caches tree, in tree order."""
    out: List[dict] = []

    def grab(leaf):
        out.append(leaf)
        return leaf

    map_kv_leaves(tree, grab)
    return out


def _device_of(caches) -> torch.device:
    return kv_leaves(caches)[0]["slot_pos"].device


def row_positions(pos, batch: int, device) -> torch.Tensor:
    """A cache position as a per-row (B,) int32 tensor."""
    if torch.is_tensor(pos):
        return pos
    # hostsync: ok host int position
    return torch.full((batch,), int(pos), dtype=torch.int32, device=device)


# ------------------------------------------------------------ page writes

def scatter_pages(kp, vp, k, v, tbl, writable) -> None:
    """Write dense KV (layers, B, cap, Hk, dh) into pages, in place.

    ``tbl`` (B, npg) maps logical page j of row b to a physical page;
    entries that are not ``writable`` (pinned prefix pages, TRASH) are
    redirected to the TRASH page, so shared pages are never rewritten.
    Several rows may write TRASH in one call; its contents are garbage.
    """
    layers, b, cap = k.shape[:3]
    page = kp.shape[2]
    npg = tbl.shape[1]
    trash = kp.shape[1] - 1
    pad = npg * page - cap
    kpg = F.pad(k, (0, 0, 0, 0, 0, pad)).reshape(layers, b, npg, page, *k.shape[3:])
    vpg = F.pad(v, (0, 0, 0, 0, 0, pad)).reshape(layers, b, npg, page, *v.shape[3:])
    tbl_w = torch.where(writable, tbl, trash).long()
    kp[:, tbl_w] = kpg.to(kp.dtype)
    vp[:, tbl_w] = vpg.to(vp.dtype)


def pack_caches(pool_tree, dense_caches, tbl, writable):
    """Scatter a dense prefill's caches into pool pages -> paged caches.

    ``tbl`` (B, npg) int32 and ``writable`` (B, npg) bool are device
    tensors.  The pool's page tensors are written in place (the JAX package
    donates them); the returned caches reference them, keep the dense
    ``slot_pos`` and carry ``pos`` per row.
    """
    pools = iter(kv_leaves(pool_tree))

    def pack(leaf):
        pool = next(pools)
        scatter_pages(pool["kp"], pool["vp"], leaf["k"], leaf["v"], tbl, writable)
        return {"kp": pool["kp"], "vp": pool["vp"], "block_tbl": tbl,
                "slot_pos": leaf["slot_pos"]}

    out = map_kv_leaves(dense_caches, pack)
    out["pos"] = row_positions(dense_caches["pos"], tbl.shape[0], tbl.device)
    return out


def write_pinned(pool_tree, prefix_caches, pin_ids) -> None:
    """Write a shared prefix's KV into pinned pages ``pin_ids`` (device
    int64), once, in place: row 0's first ``len(pin_ids) * page`` slots
    (every row of a ``PrefixCache`` is identical by construction)."""
    prefixes = iter(kv_leaves(prefix_caches))
    for leaf in kv_leaves(pool_tree):
        pre = next(prefixes)
        kp, vp = leaf["kp"], leaf["vp"]
        layers, page = kp.shape[0], kp.shape[2]
        n_pin = pin_ids.shape[0]
        kp[:, pin_ids] = pre["k"][:, 0, :n_pin * page].reshape(
            layers, n_pin, page, *kp.shape[3:]).to(kp.dtype)
        vp[:, pin_ids] = pre["v"][:, 0, :n_pin * page].reshape(
            layers, n_pin, page, *vp.shape[3:]).to(vp.dtype)


def row_pos_caches(caches, batch: int):
    """Caches with a per-row ``(B,)`` position (a dense prefill carries a
    host int).  Block (speculative) decode advances rows by different
    amounts, so a single position cannot describe the batch; paged caches
    are already per row."""
    out = dict(caches)
    out["pos"] = row_positions(caches["pos"], batch, _device_of(caches))
    return out


def rewind_kv(caches, rollback):
    """Rewind per-row positions by ``rollback`` (B,) int32 >= 0.

    A verify block writes k positions optimistically; a row that accepts
    ``a`` of them moves ``pos`` back by ``k - a`` and marks every slot at or
    past the new position empty (``slot_pos = -1``, in place on every
    layer), which the attention masks out until the next write.  Dense and
    paged caches alike; ``pos`` must be per row (``row_pos_caches``).
    """
    pos = caches["pos"] - rollback
    leaves = kv_leaves(caches)
    cap = leaves[0]["slot_pos"].shape[-1]
    stale = (torch.arange(cap, dtype=torch.int32, device=pos.device)[None, :]
             >= pos[:, None])
    for leaf in leaves:
        leaf["slot_pos"].masked_fill_(stale[None], -1)
    out = dict(caches)
    out["pos"] = pos
    return out


def extract_pool(paged_caches):
    """The pool storage tree of packed or stepped paged caches."""
    return map_kv_leaves(paged_caches, lambda leaf: {"kp": leaf["kp"], "vp": leaf["vp"]})


# ---------------------------------------------------------------- pool

@dataclasses.dataclass(frozen=True)
class PagePoolConfig:
    page_size: int = 16
    num_pages: int = 256

    def __post_init__(self):
        if self.page_size < 1:
            raise ValueError("page_size must be >= 1")
        if self.num_pages < 1:
            raise ValueError("num_pages must be >= 1")


@dataclasses.dataclass
class PinnedPrefix:
    """One pinned shared-prefix page set (the tweak prefix)."""
    key: Tuple[int, ...]          # the prefix token ids
    ids: np.ndarray               # (n_pin,) page ids, refcounted
    tokens: int                   # tokens covered = n_pin * page_size


class PagePool:
    """Device-resident KV page pool with a host-side free-list allocator.

    One pool serves one model: page id ``p`` names page ``p`` in every
    layer's storage.  Allocation, freeing and refcounting run on host ints;
    the device half (``pack_caches``, ``write_pinned``) writes the storage
    tensors in place.  The pool lives on ``device`` (the model's).
    """

    def __init__(self, model, cfg: PagePoolConfig, device="cuda"):
        self.cfg = cfg
        self.model = model
        self.device = resolve_device(device)
        template = model.init_caches(1, cfg.page_size, self.device)
        n = cfg.num_pages + 1  # +1: the TRASH page (never allocated)

        def make(leaf):
            shape = leaf["k"].shape        # (layers, 1, page, hk, dh)
            pshape = (shape[0], n, cfg.page_size) + tuple(shape[3:])
            return {"kp": torch.zeros(pshape, dtype=leaf["k"].dtype, device=self.device),
                    "vp": torch.zeros(pshape, dtype=leaf["v"].dtype, device=self.device)}

        self.storage = map_kv_leaves(template, make)
        self._refcount = np.zeros(cfg.num_pages, np.int32)
        self._free: List[int] = list(range(cfg.num_pages - 1, -1, -1))
        self._pins: Dict[Tuple[int, ...], PinnedPrefix] = {}

    # ----------------------------------------------------- host allocator
    @property
    def trash_page(self) -> int:
        return self.cfg.num_pages

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def live_pages(self) -> int:
        return self.cfg.num_pages - len(self._free)

    @property
    def pinned_pages(self) -> int:
        return sum(len(p.ids) for p in self._pins.values())

    def pages_per_seq(self, capacity: int) -> int:
        return -(-capacity // self.cfg.page_size)

    def alloc(self, n: int) -> np.ndarray:
        """Take ``n`` free pages (refcount 1 each); raises, never corrupts."""
        if n > len(self._free):
            raise PagePoolExhausted(
                f"need {n} pages, only {len(self._free)} of {self.cfg.num_pages} free")
        ids = np.asarray([self._free.pop() for _ in range(n)], np.int32)
        self._refcount[ids] = 1
        return ids

    def incref(self, ids: np.ndarray, count: int = 1) -> None:
        np.add.at(self._refcount, np.asarray(ids, np.int64), count)

    def decref(self, ids) -> None:  # hostsync: ok refcount bookkeeping, pure host numpy
        """Drop one reference per id; pages return to the free list at 0."""
        for p in np.asarray(ids, np.int64).ravel():
            c = int(self._refcount[p]) - 1
            if c < 0:
                raise RuntimeError(f"page {p} over-freed")
            self._refcount[p] = c
            if c == 0:
                self._free.append(int(p))

    def adopt(self, paged_caches) -> None:
        """Point ``storage`` at the page tensors inside packed or stepped
        caches (the same tensors here: writes are in place)."""
        self.storage = extract_pool(paged_caches)

    # ------------------------------------------------------ row tables
    def alloc_block_table(self, batch: int, capacity: int,
                          pin: Optional[PinnedPrefix] = None
                          ) -> Tuple[np.ndarray, np.ndarray]:
        """(block_tbl (B, npg) int32, writable (B, npg) bool) for a batch.

        With ``pin``, the leading pinned pages are shared by every row
        (refcount += batch) and read-only; private pages cover the rest of
        ``capacity``.  All or nothing: exhaustion leaves refcounts as they
        were.
        """
        npg = self.pages_per_seq(capacity)
        n_pin = 0 if pin is None else len(pin.ids)
        if n_pin > npg:
            raise ValueError(f"pinned prefix ({n_pin} pages) exceeds capacity ({npg})")
        private = npg - n_pin
        if batch * private > len(self._free):
            raise PagePoolExhausted(
                f"need {batch * private} pages, only {len(self._free)} of "
                f"{self.cfg.num_pages} free")
        rows = self.alloc(batch * private).reshape(batch, private)
        writable = np.zeros((batch, npg), bool)
        writable[:, n_pin:] = True
        if pin is None:
            return rows, writable
        self.incref(pin.ids, count=batch)
        tbl = np.concatenate([np.broadcast_to(pin.ids, (batch, n_pin)), rows], axis=1)
        return np.ascontiguousarray(tbl, dtype=np.int32), writable

    def free_block_table(self, tbl: np.ndarray, writable: np.ndarray) -> None:
        """Release a batch's pages: private pages free, pinned decref."""
        tbl, writable = np.asarray(tbl), np.asarray(writable)
        self.decref(tbl[writable])
        pinned = tbl[~writable]
        self.decref(pinned[pinned != self.trash_page])

    # ---------------------------------------------------- pinned prefixes
    def ensure_pinned(self, prefix_cache) -> Optional[PinnedPrefix]:
        """Pin a ``PrefixCache``'s full pages once, keyed by its token ids.

        Returns None when the prefix is shorter than one page (nothing to
        share: the whole prefix rides in each row's private pages).
        """
        key = tuple(prefix_cache.token_ids)
        hit = self._pins.get(key)
        if hit is not None:
            return hit
        n_pin = prefix_cache.length // self.cfg.page_size
        if n_pin == 0:
            return None
        ids = self.alloc(n_pin)
        try:
            write_pinned(self.storage, prefix_cache.caches,
                         to_device(ids.astype(np.int64), self.device))
        except Exception:
            self.decref(ids)
            raise
        pin = PinnedPrefix(key=key, ids=ids, tokens=n_pin * self.cfg.page_size)
        self._pins[key] = pin
        return pin

    def unpin(self, key: Tuple[int, ...]) -> None:
        pin = self._pins.pop(tuple(key), None)
        if pin is not None:
            self.decref(pin.ids)

    def refcounts(self) -> np.ndarray:
        return self._refcount.copy()
