"""Contract checks over the registered hot paths (counterpart of
``src/repro/analysis/contracts.py``, DESIGN.md §10, Layer 2).

The reference traces each hot path to a jaxpr and checks the lowered
artifact.  Eager PyTorch has no jaxpr, so each contract RUNS its path over
the reference's bucket sets (``_BATCH_BUCKETS``, suffix buckets ``(8, 16)``,
the reference's tiny configs) twice, under :class:`SyncCounter`, and holds
it to the counterpart of each JAX contract:

* **no callbacks -> host syncs within budget.**  :class:`SyncCounter` is a
  ``TorchFunctionMode``: it sees every torch call, on any device, so it
  counts on the CPU too (where a device->host copy does not exist and a
  dispatch mode would see nothing).  It counts, per call site (the port's
  file and line): reads of a tensor on the host (``.item``, ``.cpu``,
  ``.numpy``, ``.tolist``, ``__bool__``, ``__int__``, ``__float__``,
  ``__index__``, ``__array__``, ``__format__``, a copy into a host tensor);
  ops whose output shape depends on the data (``nonzero``,
  ``masked_select``, ``unique``, a boolean-mask ``__getitem__``); and
  blocking uploads (``.to(device)`` or ``copy_`` of host data without
  ``non_blocking``, ``torch.tensor(..., device=)``, a list or host tensor
  used as an index).  A read of host data (a tensor made from numpy, or
  the result of an earlier copy) is no sync and is not counted: on CUDA
  such a tensor lives on the CPU; on the CPU the counter marks it host.  On
  the CPU ``.to(<the cpu device>)`` cannot be told from a no-op move, so
  the port spells each copy to the host ``.cpu()`` (the lint's HS103 flags
  ``.to("cpu")``); on CUDA ``.to`` the host counts as well.  On CUDA the
  counter also records what CUDA reports under
  ``torch.cuda.set_sync_debug_mode("warn")`` (each warning attributed to
  the torch call that raised it), and the two counts must agree.
* **donation is real -> state written in place.**  Every tensor of an
  argument the registry lists under ``writes`` keeps its ``data_ptr()``
  across the call; a reallocated leaf is a failure that names it.
* **read-only -> unwritten.**  Every tensor of an argument listed under
  ``reads`` keeps its ``._version``: the shared prefix KV of a prefixed
  generate, the bank of an IVF lookup.
* **no 64-bit widening.**  No op on a registered path turns inputs without
  a 64-bit dtype into a float64 or complex128 output on the device.  The
  port's idiom allows int64 where torch requires it: the indices an index
  op returns (``topk``, ``sort``, ``argmax``, ``nonzero``, ...) and an int64
  the call names itself (``.long()``, ``.to(torch.int64)``, ``dtype=
  torch.int64``), which makes the index argument of ``gather``, ``scatter``
  and ``index_copy_`` (torch takes no int32 there).  An int64 nobody asked
  for (``arange`` without a dtype, ``where`` of two Python ints, the sum or
  cumsum of an int32 tensor) is widening and fails.
* **the fused decode** makes one sync per ``Generator`` call whatever
  ``max_new_tokens`` is; the speculative call makes ``spec_steps + 2``,
  equal to ``last_spec_syncs``.
* **the IVF lookup** returns the same output shapes for different query
  contents (a fixed shortlist, DESIGN.md §7).
* **the recompile gate** has no eager counterpart, except that the second
  sweep builds no kernel: ``kernels/build.py``'s ``builds`` count does not
  move across it.
* **the engine** makes, per ``handle_batch``, 1 route fetch, +1 with
  UNCERTAIN rows (stage 2), +1 per ``Generator`` call, +1 per
  ``insert_batch``: ``last_route_syncs`` plus the generator and insert
  terms.  A train step of ``make_train_step`` makes none.

Run via ``python -m repro_torch.analysis.contracts [--device cuda|cpu]``
(``cuda`` by default).  Shapes are tiny: the properties checked do not
depend on them.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import functools
import os
import sys
import warnings
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from . import registry

_T = torch.Tensor
_TORCH_DIR = os.path.dirname(os.path.abspath(torch.__file__))
_HERE = os.path.abspath(__file__)
SYNC_WARNING = "called a synchronizing CUDA operation"

READS = {_T.item, _T.tolist, _T.numpy, _T.__bool__, _T.__int__, _T.__float__,
         _T.__index__, _T.__array__, _T.__format__}
SHAPE_OPS = {torch.nonzero, _T.nonzero, torch.argwhere, _T.argwhere, torch.masked_select,
             _T.masked_select, torch.unique, _T.unique, torch.unique_consecutive,
             _T.unique_consecutive}
# torch.from_numpy is not among them: torch does not route it through
# __torch_function__, so on the CPU its result counts as device data (the
# port's hot paths upload through device.to_device, i.e. as_tensor)
FACTORIES = {torch.tensor, torch.as_tensor, torch.zeros, torch.ones,
             torch.full, torch.empty, torch.arange, torch.linspace, torch.eye, torch.rand,
             torch.randn, torch.randint}
INDEX_OPS = {torch.topk, _T.topk, torch.sort, _T.sort, torch.argsort, _T.argsort,
             torch.argmax, _T.argmax, torch.argmin, _T.argmin, torch.nonzero, _T.nonzero,
             torch.max, _T.max, torch.min, _T.min, torch.kthvalue, _T.kthvalue,
             torch.searchsorted, _T.long}
WIDE = (torch.float64, torch.complex128, torch.int64)


def _flat(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _flat(v)]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _flat(v)]
    return []


def _leaves(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """{path: tensor} of a tree of dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return {prefix or ".": tree}
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{prefix}[{i}]"))
    return out


_OWN = ("_site", "_count", "__torch_function__", "_check_wide")


def _site() -> str:
    """The innermost caller outside torch and the counter: 'file:line'."""
    f = sys._getframe(1)
    while f is not None:
        path = os.path.abspath(f.f_code.co_filename)
        if not (path.startswith(_TORCH_DIR) or (path == _HERE and f.f_code.co_name in _OWN)):
            break
        f = f.f_back
    if f is None:
        return "<unknown>"
    path = f.f_code.co_filename.replace(os.sep, "/")
    cut = path.rfind("/src/repro_torch/")
    short = path[cut + len("/src/repro_torch/"):] if cut >= 0 else os.path.basename(path)
    return f"{short}:{f.f_lineno}"


def _asks_int64(args, kwargs) -> bool:
    """Does the call name int64 itself (``.to(torch.int64)``, a factory's or
    a reduction's ``dtype=torch.int64``)?"""
    return kwargs.get("dtype") == torch.int64 or any(a is torch.int64 for a in args)


class SyncCounter(TorchFunctionMode):
    """Counts host syncs per call site while active (see the module
    docstring for what counts).  ``syncs`` {site: n} and ``kinds`` {kind:
    n}; ``wide`` lists 64-bit widenings; on CUDA ``cuda_syncs`` {site: n}
    holds what ``set_sync_debug_mode("warn")`` reported."""

    def __init__(self, device, sync_warnings=None):
        super().__init__()
        self.device = torch.device(device)
        self.host_is_cpu = self.device.type == "cpu"
        self.syncs: collections.Counter = collections.Counter()
        self.kinds: collections.Counter = collections.Counter()
        self.cuda_syncs: collections.Counter = collections.Counter()
        self.wide: List[str] = []
        self._warns = sync_warnings
        self._seen_warns = 0

    # ------------------------------------------------------------- host
    def _host(self, t) -> bool:
        """Does ``t`` hold host data (no sync to read it)?"""
        if not isinstance(t, torch.Tensor):
            return True
        if self.host_is_cpu:
            return getattr(t, "_repro_host", False)
        return t.device.type == "cpu"

    def _mark(self, t, host: bool):
        if self.host_is_cpu and isinstance(t, torch.Tensor):
            t._repro_host = host
        return t

    @property
    def total(self) -> int:
        return sum(self.syncs.values())

    @property
    def cuda_total(self) -> int:
        return sum(self.cuda_syncs.values())

    def _count(self, kind: str) -> None:
        self.syncs[_site()] += 1
        self.kinds[kind] += 1

    # ---------------------------------------------------------- classify
    def _to_target(self, func, args, kwargs):
        """(target device or None, non_blocking) of a ``.to``/``.cpu``/``.cuda``."""
        if func is _T.cpu:
            return torch.device("cpu"), False
        if func is _T.cuda:
            dev = args[1] if len(args) > 1 else kwargs.get("device")
            return torch.device("cuda" if dev is None else dev), kwargs.get("non_blocking",
                                                                           False)
        dev, _, non_blocking, _ = torch._C._nn._parse_to(*args[1:], **kwargs)
        return dev, non_blocking

    def _index_kind(self, func, args) -> str:
        """'shape' (a boolean mask), 'upload' (a list or host tensor index)
        or '' for ``__getitem__``/``__setitem__`` on a device tensor."""
        if len(args) < 2 or self._host(args[0]):
            return ""
        idx = args[1] if isinstance(args[1], tuple) else (args[1],)
        for i in idx:
            if isinstance(i, torch.Tensor) and i.dtype == torch.bool:
                if func is _T.__setitem__ and len(idx) == 1 and i.shape == args[0].shape:
                    value = args[2]
                    if not isinstance(value, torch.Tensor):
                        return ""           # masked_fill_: no sync
                    if value.numel() == 1:
                        return "" if self._host(value) else "read"
                return "shape"
            if isinstance(i, list) or (isinstance(i, torch.Tensor) and i.dim() > 0
                                       and self._host(i)):
                return "upload"
        return ""

    def _classify(self, func, args, kwargs) -> str:
        if func in READS:
            return "" if self._host(args[0]) else "read"
        if func in SHAPE_OPS:
            return "" if self._host(args[0]) else "shape"
        if func in (_T.__getitem__, _T.__setitem__):
            return self._index_kind(func, args)
        if func is torch.where and len(args) == 1 and not kwargs:
            return "" if self._host(args[0]) else "shape"
        if func in (_T.cpu, _T.to, _T.cuda):
            dev, non_blocking = self._to_target(func, args, kwargs)
            if dev is None:
                return ""
            if dev.type == "cpu" and not self._host(args[0]):
                # a copy to the host; on the CPU only .cpu() is one
                return "read" if (func is _T.cpu or not self.host_is_cpu) else ""
            if dev.type == self.device.type and self._host(args[0]):
                return "" if non_blocking else "upload"
            return ""
        if func is _T.copy_ and len(args) > 1 and isinstance(args[1], torch.Tensor):
            dst_host, src_host = self._host(args[0]), self._host(args[1])
            if dst_host and not src_host:
                return "read"
            if src_host and not dst_host and not kwargs.get("non_blocking", False) \
                    and not (len(args) > 2 and args[2]):
                return "upload" if args[1].numel() > 0 else ""
            return ""
        if func in (torch.tensor, torch.as_tensor) and kwargs.get("device") is not None:
            data = args[0] if args else kwargs.get("data")
            if not (isinstance(data, torch.Tensor) and not self._host(data)) and \
                    torch.device(kwargs["device"]).type == self.device.type:
                return "upload"
        if func is _T.new_tensor and not self._host(args[0]):
            return "upload"
        return ""

    # ------------------------------------------------------------ mark
    def _after(self, func, args, kwargs, out, kind: str):
        if not self.host_is_cpu:
            return out
        if func in (_T.cpu, _T.to) and isinstance(out, torch.Tensor):
            dev, _ = self._to_target(func, args, kwargs)
            if dev is not None and dev.type == "cpu":
                if kind == "read":                   # a copy to the host
                    return self._mark(out.view_as(out) if out is args[0] else out, True)
                if self._host(args[0]) and func is _T.to:   # an upload
                    return self._mark(out.view_as(out) if out is args[0] else out, False)
        outs = _flat(out)
        if not outs:
            return out
        if func in FACTORIES:
            host = kwargs.get("device") is None and not (
                func is torch.as_tensor and args and isinstance(args[0], torch.Tensor)
                and not self._host(args[0]))
            for t in outs:
                self._mark(t, host)
            return out
        ins = _flat(list(args)) + _flat(list(kwargs.values()))
        if ins and all(self._host(t) for t in ins):
            for t in outs:
                if all(t is not i for i in ins):
                    self._mark(t, True)
        return out

    def _check_wide(self, func, args, kwargs, out) -> None:
        outs = [t for t in _flat(out) if t.dtype in WIDE and not self._host(t)]
        if not outs:
            return
        ins = _flat(list(args)) + _flat(list(kwargs.values()))
        in_dtypes = {t.dtype for t in ins}
        for t in outs:
            if t.dtype in in_dtypes:
                continue                             # carried, not widened
            if t.dtype == torch.int64 and (func in INDEX_OPS or _asks_int64(args, kwargs)):
                continue
            name = getattr(func, "__qualname__", getattr(func, "__name__", str(func)))
            self.wide.append(f"{_site()} {name} -> {str(t.dtype).replace('torch.', '')}")

    # ------------------------------------------------------------ hook
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        kind = self._classify(func, args, kwargs)
        out = func(*args, **kwargs)
        if kind:
            self._count(kind)
        if self._warns is not None and len(self._warns) > self._seen_warns:
            new = sum(SYNC_WARNING in str(w.message) for w in self._warns[self._seen_warns:])
            self._seen_warns = len(self._warns)
            if new:
                self.cuda_syncs[_site()] += new
        out = self._after(func, args, kwargs, out, kind)
        self._check_wide(func, args, kwargs, out)
        return out

    def finish(self) -> None:
        """Attribute CUDA's reports raised outside any torch call."""
        if self._warns is not None:
            new = sum(SYNC_WARNING in str(w.message) for w in self._warns[self._seen_warns:])
            self._seen_warns = len(self._warns)
            if new:
                self.cuda_syncs["<outside torch calls>"] += new

    def report(self) -> dict:
        out = {"syncs": self.total, "by_site": dict(self.syncs), "kinds": dict(self.kinds)}
        if self._warns is not None:
            out["cuda_syncs"] = self.cuda_total
            out["cuda_by_site"] = dict(self.cuda_syncs)
        return out


@contextlib.contextmanager
def counting(device):
    """A :class:`SyncCounter` over the block; on CUDA also under
    ``set_sync_debug_mode("warn")``, its warnings captured."""
    device = torch.device(device)
    if device.type != "cuda":
        with SyncCounter(device) as counter:
            yield counter
        return
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        before = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with SyncCounter(device, caught) as counter:
                yield counter
                counter.finish()
        finally:
            torch.cuda.set_sync_debug_mode(before)


# ------------------------------------------------------------- checks

def check_counter(name: str, counter: SyncCounter, budget: int) -> List[str]:
    """Syncs within budget, CUDA's count equal to the counter's, no
    widening."""
    failures = []
    if counter.total > budget:
        failures.append(f"{name}: {counter.total} host syncs, budget {budget}: "
                        f"{dict(counter.syncs)}")
    if counter._warns is not None and counter.cuda_total != counter.total:
        failures.append(f"{name}: set_sync_debug_mode reported {counter.cuda_total} syncs "
                        f"{dict(counter.cuda_syncs)}, the counter {counter.total} "
                        f"{dict(counter.syncs)}")
    if counter.wide:
        failures.append(f"{name}: 64-bit widening on the device: {sorted(set(counter.wide))[:6]}")
    return failures


def storage_of(tree) -> Dict[str, int]:
    return {k: t.data_ptr() for k, t in _leaves(tree).items()}


def versions_of(tree) -> Dict[str, int]:
    return {k: t._version for k, t in _leaves(tree).items()}


def check_in_place(name: str, arg: str, before: Dict[str, int], tree) -> List[str]:
    after = storage_of(tree)
    moved = sorted(k for k, p in before.items() if after.get(k) != p)
    if moved:
        return [f"{name}: {arg} leaves reallocated instead of written in place: {moved}"]
    return []


def check_unwritten(name: str, arg: str, before: Dict[str, int], tree) -> List[str]:
    after = versions_of(tree)
    written = sorted(k for k, v in before.items() if after.get(k) != v)
    if written:
        return [f"{name}: {arg} written (read-only by contract): {written}"]
    return []


def _builds() -> int:
    from repro_torch.kernels import build
    return build.builds


def check_no_build(name: str, before: int) -> List[str]:
    if _builds() != before:
        return [f"{name}: the second sweep built a kernel library ({before} -> {_builds()})"]
    return []


# ------------------------------------------------------------- contracts

_BATCH_BUCKETS: Tuple[int, ...] = (1, 2, 4, 8)
_SUFFIX_BUCKETS: Tuple[int, ...] = (8, 16)
_DIM = 32


def _cache_cfg(**kw):
    from repro_torch.core.cache import CacheConfig
    base = dict(capacity=64, dim=_DIM, max_query_tokens=8, max_response_tokens=16, topk=4)
    base.update(kw)
    return CacheConfig(**base)


def _unit_rows(b: int, device, seed: int = 0) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, _DIM)).astype(np.float32)
    return torch.from_numpy(x / np.linalg.norm(x, axis=1, keepdims=True)).to(device)


def _filled_cache(cfg, device, rows: int = 48, seed: int = 1):
    """A bank holding ``rows`` random entries (and, for IVF, its index)."""
    from repro_torch.core import cache, index
    state = cache.init_cache(cfg, device)
    z = lambda w, dt: torch.ones((rows, w), dtype=dt, device=device)
    state, _ = cache.insert_batch(state, cfg, _unit_rows(rows, device, seed),
                                  z(cfg.max_query_tokens, torch.int32),
                                  z(cfg.max_query_tokens, torch.float32),
                                  z(cfg.max_response_tokens, torch.int32),
                                  z(cfg.max_response_tokens, torch.float32), rows)
    if cfg.index == "ivf":
        state = index.build_index(state, cfg, seed=seed)
    return state


def _sweeps(name: str, run_one: Callable[[int], List[str]], buckets: Sequence[int]):
    """Run ``run_one(bucket)`` over the buckets twice; the second sweep
    must build no kernel."""
    failures = []
    for b in buckets:
        failures += run_one(b)
    before = _builds()
    for b in buckets:
        failures += run_one(b)
    return failures + check_no_build(name, before)


def contract_lookup_and_touch(device="cuda", buckets: Sequence[int] = _BATCH_BUCKETS):
    """Fused lookup + route + touch: no sync, the hit accounting written in
    place (the single-round-trip invariant, DESIGN.md §5)."""
    from repro_torch.core import cache, router
    cfg = _cache_cfg()
    rcfg = router.RouterConfig(tweak_threshold=0.0)
    spec = registry.path("core/cache.py", "lookup_and_touch")

    def run_one(b):
        name = f"lookup_and_touch[b={b}]"
        state = _filled_cache(cfg, device)
        q = torch.cat([state["emb"][:b // 2], _unit_rows(b - b // 2, device, b)])
        before = storage_of(state)
        hits = state["hits"].clone()
        with counting(device) as c:
            state2, scores, idx, dec = cache.lookup_and_touch(state, cfg, rcfg, q)
        f = check_counter(name, c, spec.syncs)
        f += check_in_place(name, "state", before, state2)
        if torch.equal(state2["hits"].cpu(), hits.cpu()):
            f.append(f"{name}: no hit was recorded")
        return f

    return _sweeps("lookup_and_touch", run_one, buckets)


def contract_insert_batch(device="cuda", buckets: Sequence[int] = _BATCH_BUCKETS):
    """Miss-batch commit: no sync, every buffer written in place; the host
    ``count`` (not the batch width) varies within a bucket."""
    from repro_torch.core import cache
    cfg = _cache_cfg()
    spec = registry.path("core/cache.py", "insert_batch")
    runs = iter(range(1 << 30))

    def run_one(b):
        count = max(1, b - (next(runs) % 2))
        name = f"insert_batch[b={b},count={count}]"
        state = _filled_cache(cfg, device, rows=8)
        z = lambda w, dt: torch.ones((b, w), dtype=dt, device=device)
        args = (_unit_rows(b, device, b), z(cfg.max_query_tokens, torch.int32),
                z(cfg.max_query_tokens, torch.float32), z(cfg.max_response_tokens, torch.int32),
                z(cfg.max_response_tokens, torch.float32))
        before = storage_of(state)
        with counting(device) as c:
            state2, slots = cache.insert_batch(state, cfg, *args, count)
        f = check_counter(name, c, spec.syncs)
        f += check_in_place(name, "state", before, state2)
        if int(state2["size"]) != 8 + count:
            f.append(f"{name}: size {int(state2['size'])}, want {8 + count}")
        return f

    return _sweeps("insert_batch", run_one, buckets)


def contract_ivf_lookup(device="cuda", buckets: Sequence[int] = _BATCH_BUCKETS):
    """Clustered (IVF) probe: no sync and no data-dependent shape, the same
    output shapes for different queries, the bank unwritten (DESIGN.md §7)."""
    from repro_torch.core import cache
    cfg = _cache_cfg(index="ivf", nclusters=8, nprobe=4)
    state = _filled_cache(cfg, device)
    spec = registry.path("core/cache.py", "lookup")

    def run_one(b):
        name = f"ivf_lookup[b={b}]"
        f, shapes = [], set()
        for seed in (b, b + 100):
            q = _unit_rows(b, device, seed)
            before = versions_of(state)
            with counting(device) as c:
                scores, idx = cache.lookup(state, cfg, q)
            f += check_counter(name, c, spec.syncs)
            f += check_unwritten(name, "state", before, state)
            shapes.add((tuple(scores.shape), tuple(idx.shape)))
        if len(shapes) != 1:
            f.append(f"{name}: output shapes depend on the queries: {sorted(shapes)}")
        return f

    return _sweeps("ivf_lookup", run_one, buckets)


def _tiny_generator(device, mnt: int = 4, spec_k: int = 1):
    """The reference's tiny generator (2 layers, 2 heads over 1 KV head,
    head dim 16, fp32), for the plain and the speculative contracts alike."""
    from repro_torch.models import ModelConfig, build_model
    from repro_torch.serving import generate as gen_lib
    from repro_torch.serving.sampler import SamplerConfig
    vocab = 128
    cfg = ModelConfig(num_layers=2, d_model=32, num_heads=2, num_kv_heads=1,
                      d_ff=64, vocab_size=vocab, max_seq_len=128, dtype="float32",
                      attention_impl="xla_flash", flash_block_q=16, flash_block_k=16)
    model = build_model(cfg)
    g = torch.Generator(device=device)
    g.manual_seed(1234)  # seed: ok deterministic contract probe
    gc = gen_lib.GenerateConfig(max_new_tokens=mnt, sampler=SamplerConfig(vocab_size=vocab),
                                spec_k=spec_k)
    return gen_lib.Generator(model, model.init(g, torch.device(device)), gc)


def _tokens(b: int, s: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(3, 128, (b, s)).astype(np.int32)


def contract_fused_decode(device="cuda", buckets: Sequence[int] = (1, 2)):
    """Fused decode: no sync inside the loop, the KV written in place, and
    one sync per Generator call whatever ``max_new_tokens`` is (DESIGN.md §8)."""
    gen = _tiny_generator(device, mnt=8)
    loop = registry.path("serving/generate.py", "Generator._decode_fused")
    call = registry.path("serving/generate.py", "Generator.generate_with_lengths")

    def run_one(b):
        f = []
        toks = torch.from_numpy(_tokens(b, 8, b)).to(device).long()
        logits, caches = gen.model.prefill(gen.params, {"tokens": toks}, 8 + 8 + 1)
        before = storage_of(caches)
        rng = torch.Generator(device=device)
        rng.manual_seed(b)
        with counting(device) as c:
            gen._decode_fused(logits, caches, rng, 8)
        f += check_counter(f"decode_fused[b={b}]", c, loop.syncs)
        f += check_in_place(f"decode_fused[b={b}]", "caches", before, caches)
        for mnt in (2, 8):
            name = f"generate[b={b},mnt={mnt}]"
            with counting(device) as c:
                gen.generate_with_lengths({"tokens": _tokens(b, 8, b)}, max_new_tokens=mnt,
                                          seed=b)
            f += check_counter(name, c, call.syncs)
            if c.total != call.syncs:
                f.append(f"{name}: {c.total} syncs, want exactly {call.syncs}")
        return f

    return _sweeps("decode_fused", run_one, buckets)


def contract_spec_decode(device="cuda", buckets: Sequence[int] = (1, 2)):
    """Speculative decode: ``spec_steps + 2`` syncs a call, equal to
    ``last_spec_syncs``; the KV written in place."""
    mnt, k = 8, 2
    gen = _tiny_generator(device, mnt=mnt, spec_k=k)
    spec = registry.path("serving/generate.py", "Generator._decode_fused_spec")

    def run_one(b):
        f = []
        prompt = _tokens(b, 8, b)
        plain = _greedy(gen, prompt, mnt)
        for overlap in (mnt, mnt // 2):
            name = f"spec_decode[b={b},draft={overlap}]"
            drafts = (plain[:, :overlap], np.full((b,), overlap, np.int32))
            with counting(device) as c:
                out, _, _ = gen.generate_with_lengths({"tokens": prompt}, max_new_tokens=mnt,
                                                      seed=b, drafts=drafts)
            budget = spec.syncs + gen.last_spec_stats["spec_steps"]
            f += check_counter(name, c, budget)
            if c.total != gen.last_spec_syncs or c.total != budget:
                f.append(f"{name}: {c.total} syncs, last_spec_syncs {gen.last_spec_syncs}, "
                         f"spec_steps + 2 = {budget}")
            if not np.array_equal(out, plain):
                f.append(f"{name}: speculative tokens differ from plain decode")
        return f

    return _sweeps("spec_decode", run_one, buckets)


def _greedy(gen, prompt, mnt: int) -> np.ndarray:
    out, _, _ = gen.generate_with_lengths({"tokens": prompt}, max_new_tokens=mnt, seed=0)  # seed: ok deterministic contract probe, greedy
    return out


def contract_prefix_suffix_prefill(device="cuda",
                                   suffix_buckets: Sequence[int] = _SUFFIX_BUCKETS):
    """Prefix-KV reuse: the suffix prefill over a FIXED shared-prefix KV
    leaves that KV unwritten (DESIGN.md §9), one sync a call, none to build it."""
    mnt, b = 4, 2
    gen = _tiny_generator(device, mnt)
    build_spec = registry.path("serving/generate.py", "Generator.build_prefix_cache")
    call = registry.path("serving/generate.py", "Generator.generate_with_lengths")
    with counting(device) as c:
        prefix = gen.build_prefix_cache((5, 6, 7, 8), batch=b)
    failures = check_counter("build_prefix_cache", c, build_spec.syncs)

    def run_one(s):
        name = f"prefill_with_prefix[s={s}]"
        before = versions_of(prefix.caches)
        with counting(device) as c:
            gen.generate_with_lengths({"tokens": _tokens(b, s, s)}, max_new_tokens=mnt,
                                      seed=s, prefix_cache=prefix)
        f = check_counter(name, c, call.syncs)
        return f + check_unwritten(name, "prefix_cache", before, prefix.caches)

    return failures + _sweeps("prefill_with_prefix", run_one, suffix_buckets)


ENGINE_QUERIES = ("how do i reset my router password",
                  "what is the capital of france",
                  "best way to learn python quickly",
                  "how to bake sourdough bread at home")
ENGINE_EDITS = ("how do i reset my modem password", "what is the capital of spain")
ENGINE_FRESH = ("why is the sky blue during the day", "explain quantum tunnelling simply")


def _engine(device, band: float = 0.0):
    from repro_torch.launch.serve import build_engine
    eng = build_engine(model="serve-tiny", device=device, capacity=64, train_embedder_steps=0,
                       threshold=0.75, band=band, train_reranker_steps=0, max_new_tokens=8,
                       vocab=512)
    eng.populate(list(ENGINE_QUERIES), [f"answer {i} to that" for i in range(4)])
    return eng


def engine_budget(eng, fn: Callable) -> Tuple[object, Dict[str, int]]:
    """Run ``fn()`` (a ``handle_batch``) counting the generator calls and
    inserts it makes: ``(result, {"generate": n, "insert": n})``."""
    calls = {"generate": 0, "insert": 0}

    def wrap(obj, attr, key):
        inner = getattr(obj, attr)

        @functools.wraps(inner)
        def counted(*a, **k):
            calls[key] += 1
            return inner(*a, **k)
        setattr(obj, attr, counted)
        return inner

    gens = {id(g): g for g in (eng.big, eng.small)}.values()
    saved = [(g, "generate_with_lengths", wrap(g, "generate_with_lengths", "generate"))
             for g in gens]
    saved.append((eng.bank, "insert_batch", wrap(eng.bank, "insert_batch", "insert")))
    try:
        return fn(), calls
    finally:
        for obj, attr, _ in saved:
            delattr(obj, attr)


def check_engine_batch(name: str, eng, counter: SyncCounter, calls: Dict[str, int]):
    """The engine's budget: 1 route fetch (+1 with UNCERTAIN rows), +1 per
    Generator call, +1 per insert; ``last_route_syncs`` plus those terms."""
    spec = registry.path("core/engine.py", "TweakLLMEngine.handle_batch_result")
    budget = eng.last_route_syncs + calls["generate"] + calls["insert"]
    f = check_counter(name, counter, budget)
    if eng.last_route_syncs not in (spec.syncs, spec.syncs + 1):
        f.append(f"{name}: last_route_syncs {eng.last_route_syncs}")
    if counter.total != budget:
        f.append(f"{name}: {counter.total} syncs, want last_route_syncs "
                 f"{eng.last_route_syncs} + {calls['generate']} generator calls + "
                 f"{calls['insert']} inserts = {budget}")
    return f


def contract_engine(device="cuda", buckets: Sequence[int] = (1, 2, 4, 8)):
    """``handle_batch`` on the default stack (flat, FIFO), then with the
    cascade on: the syncs are exactly the budget's terms."""
    failures = []
    for band in (0.0, 0.2):
        eng = _engine(device, band)
        mix = list(ENGINE_QUERIES[:2]) + list(ENGINE_EDITS) + list(ENGINE_FRESH)
        seen = collections.Counter()

        def run_one(b, eng=eng, band=band, seen=seen):
            queries = [mix[(i + b) % len(mix)] + ("" if i < len(mix) else f" {i}")
                       for i in range(b)]
            name = f"handle_batch[band={band},b={b}]"
            with counting(device) as c:
                res, calls = engine_budget(eng, lambda: eng.handle_batch(
                    queries, max_new_tokens=8, collect_meta=True))
            for m in res[1]:
                seen[m["decision"]] += 1
            return check_engine_batch(name, eng, c, calls)

        failures += _sweeps(f"handle_batch[band={band}]", run_one, buckets)
        if band == 0.0 and not (seen[0] and seen[1] and seen[2]):
            failures.append(f"handle_batch: the sweep lacks a MISS, TWEAK or EXACT row: "
                            f"{dict(seen)}")
    return failures


def contract_train_step(device="cuda", buckets: Sequence[int] = (2, 4)):
    """A train step of ``make_train_step`` (microbatches 2): no sync, the
    parameters and AdamW moments written in place."""
    from repro_torch.models import ModelConfig, build_model
    from repro_torch.training import AdamWConfig, init_opt_state, make_train_step
    spec = registry.path("training/trainer.py", "make_train_step")
    cfg = ModelConfig(num_layers=2, d_model=32, num_heads=2, num_kv_heads=1, d_ff=64,
                      vocab_size=128, max_seq_len=64, dtype="float32")
    model = build_model(cfg)
    g = torch.Generator(device=device)
    g.manual_seed(7)  # seed: ok deterministic contract probe
    params = model.init(g, torch.device(device))
    opt = init_opt_state(params)
    step = make_train_step(model, AdamWConfig(), microbatches=2)

    def run_one(b):
        nonlocal params, opt
        name = f"train_step[b={b}]"
        toks = torch.from_numpy(_tokens(b, 16, b)).to(device).long()
        batch = {"tokens": toks, "targets": toks.roll(-1, 1),
                 "mask": torch.ones(toks.shape, dtype=torch.float32, device=device)}
        before = {"params": storage_of(params), "opt_state": storage_of(opt)}
        with counting(device) as c:
            params, opt, metrics = step(params, opt, batch)
        f = check_counter(name, c, spec.syncs)
        f += check_in_place(name, "params", before["params"], params)
        f += check_in_place(name, "opt_state", before["opt_state"], opt)
        if not bool(torch.isfinite(metrics["loss"])):
            f.append(f"{name}: loss not finite")
        return f

    return _sweeps("train_step", run_one, buckets)


CONTRACTS = (
    ("lookup_and_touch", contract_lookup_and_touch),
    ("insert_batch", contract_insert_batch),
    ("ivf_lookup", contract_ivf_lookup),
    ("fused_decode", contract_fused_decode),
    ("spec_decode", contract_spec_decode),
    ("prefix_suffix_prefill", contract_prefix_suffix_prefill),
    ("engine", contract_engine),
    ("train_step", contract_train_step),
)


def run_all(device="cuda") -> List[str]:
    from repro_torch.device import resolve_device
    device = resolve_device(device)
    failures: List[str] = []
    for name, fn in CONTRACTS:
        try:
            with torch.no_grad() if name != "train_step" else contextlib.nullcontext():
                failures += fn(device)
        except Exception as e:          # a path that cannot run fails its contract
            failures.append(f"{name}: raised {type(e).__name__}: {e}")
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="hot-path contracts of the port (DESIGN.md §10)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    failures = run_all(args.device)
    for f in failures:
        print(f)
    if failures:
        print(f"FAIL: {len(failures)} contract violation(s)")
        return 1
    print(f"analysis contracts: {len(CONTRACTS)} hot paths clean on {args.device}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
