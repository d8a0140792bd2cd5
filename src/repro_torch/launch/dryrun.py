"""Dry-run of the assigned shapes: what each (arch x shape x mesh) needs, and
the one-card plan run on the H100 (counterpart of
``src/repro/launch/dryrun.py``).

The reference lowers and compiles every combination for its 16 x 16 and
2 x 16 x 16 TPU meshes and records ``memory_analysis`` and
``cost_analysis``.  The port reckons the same quantities by the GPU idiom:

1. the step's arguments (params, optimizer state, batch, caches) placed on
   the reference's mesh by ``launch.sharding``'s rules: the bytes one
   device holds (``memory.argument_size_in_bytes``);
2. one step traced over meta tensors (``launch.shapes``) at the per-card
   batch, the reference's batch of one data shard: ``flops`` from
   ``torch.utils.flop_counter`` (the aten products) plus the attention
   kernels' work (``kernels.meta.flops``), and ``peak_bytes``, the most
   bytes of storage live at once (:class:`LiveBytes`);
3. the one-card plan: that batch, the microbatches the reference's clip
   gives, and the largest depth in whole pattern periods whose reckoned
   peak fits ``CARD_BYTES`` with ``HEADROOM`` to spare;
4. with ``device="cuda"`` (the default) that plan run on the card: random
   weights from ``seed``, ms a step, ``torch.cuda.max_memory_allocated``
   against the reckoned peak, kernel launches.  A decode plan starts from
   caches filled at random with ``pos`` at the shape's length (the
   reference lowers a zero cache at pos 0), takes ``DECODE_STEPS`` greedy
   steps twice from the same cache, and requires the two runs' logits
   bitwise equal and finite.

``collectives``, ``collectives_body_once`` and ``loop_trip_count`` are
the reference's three keys, reckoned by ``launch.collectives`` from the
placement (arithmetic on shapes: no step is traced for them).  Records go to
``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama-3.1-8b --shape prefill_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --device meta [--mesh both]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
import weakref
from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as pytree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import kernels
from repro_torch.configs import ASSIGNED_ARCHS, get_config, skip_reason
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.kernels import meta as kernel_meta
from repro_torch.launch import sharding as shd
from repro_torch.launch.collectives import collective_bytes
from repro_torch.launch.mesh import batch_axes, make_production_mesh
from repro_torch.launch.shapes import (INPUT_SHAPES, META, abstract_params, decode_capacity,
                                       decode_inputs, frontend_shapes, make_step_fn,
                                       prefill_inputs, train_inputs)
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import build_model
from repro_torch.training.optimizer import init_opt_state, tree_leaves

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "experiments",
                       "dryrun_torch")

CARD_BYTES = 80 * 10 ** 9       # an H100's 80 GB
HEADROOM = 0.10                 # kept free of the reckoned peak: allocator rounding,
#                                 fragmentation, cuBLAS workspaces
DECODE_STEPS = 8


class LiveBytes(TorchDispatchMode):
    """The most bytes of storage alive at once while the mode is on: each
    new untyped storage an op returns adds its bytes, and they come off when
    the storage is freed.  :meth:`track` counts storages made before the
    mode (params, inputs).  Views share their base's storage and count
    once; on the meta device the storages hold no memory but keep their
    sizes, so a meta step reckons a card's."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._seen = set()

    def track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._seen:
            return
        n = st.nbytes()
        self._seen.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n).atexit = False

    def _free(self, key, n) -> None:
        self._seen.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in pytree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.track(t)
        return out


def cut_depth(cfg: ModelConfig, periods: int) -> ModelConfig:
    """``cfg`` with ``periods`` whole pattern periods (an encoder-decoder:
    that many decoder layers, and at most as many encoder layers); the full
    config when ``periods`` covers it."""
    if periods >= full_periods(cfg):
        return cfg
    if cfg.enc_layers:
        return cfg.replace(num_layers=periods, enc_layers=min(cfg.enc_layers, periods))
    return cfg.replace(num_layers=periods * len(cfg.block_pattern))


def full_periods(cfg: ModelConfig) -> int:
    return cfg.num_layers if cfg.enc_layers else cfg.pattern_periods


def data_shards(mesh) -> int:
    return math.prod(mesh.shape[a] for a in batch_axes(mesh))


def clip_microbatches(microbatches: int, per_dev: int) -> int:
    """The reference's clip: at most the per-device batch, and a divisor of it."""
    microbatches = max(1, min(microbatches, per_dev))
    while per_dev % microbatches:
        microbatches -= 1
    return microbatches


# ------------------------------------------------------------------ reckoning

def argument_bytes(cfg: ModelConfig, kind: str, seq: int, batch: int, mesh, *,
                   zero1: bool = False, grad_sync_once: bool = False) -> Dict[str, int]:
    """Bytes one device of ``mesh`` holds of the step's arguments under the
    placement rules (the reference's ``argument_size_in_bytes``).  With
    ``zero1`` or ``grad_sync_once`` a train step's params take the serve
    placement; the optimizer state follows the train placement under
    ``zero1`` alone, the params' under ``grad_sync_once`` (the reference's
    shard_map step keeps it replicated over data)."""
    p_leaves = shd.param_leaves(abstract_params(cfg), cfg)
    p_mode = "serve" if kind == "decode" or ((zero1 or grad_sync_once) and kind == "train") \
        else "train"
    p_specs = shd.param_specs(mesh, p_leaves, p_mode)
    out = {"params": shd.per_device_bytes(p_leaves, p_specs, mesh)}
    if kind == "train":
        o_base = shd.param_specs(mesh, p_leaves, "train") if zero1 and not grad_sync_once \
            else p_specs
        out["opt_state"] = shd.per_device_bytes(shd.opt_state_leaves(p_leaves),
                                                shd.opt_state_specs(mesh, o_base), mesh)
        inputs = shd.tensor_leaves(train_inputs(cfg, seq, batch))
        out["batch"] = shd.per_device_bytes(inputs, shd.batch_spec(mesh, cfg), mesh)
    elif kind == "prefill":
        inputs = shd.tensor_leaves(prefill_inputs(cfg, seq, batch))
        out["batch"] = shd.per_device_bytes(inputs, shd.batch_spec(mesh, cfg), mesh)
    else:
        inputs = decode_inputs(cfg, seq, batch)
        c_leaves = shd.cache_leaves(inputs["caches"])
        out["caches"] = shd.per_device_bytes(c_leaves, shd.cache_specs(mesh, c_leaves, batch),
                                             mesh)
        out["token"] = shd.per_device_bytes(shd.tensor_leaves({"token": inputs["token"]}),
                                            {"token": shd.token_spec(mesh, batch)}, mesh)
    out["argument_size_in_bytes"] = sum(out.values())
    return out


def step_args(cfg: ModelConfig, kind: str, seq: int, batch: int, device):
    """The step's arguments on ``device``, uninitialised (meta: no storage)."""
    params = abstract_params(cfg, device)
    if kind == "train":
        return params, init_opt_state(params), train_inputs(cfg, seq, batch, device)
    if kind == "prefill":
        return params, prefill_inputs(cfg, seq, batch, device)
    inputs = decode_inputs(cfg, seq, batch, device)
    return params, inputs["token"], inputs["caches"]


def train_step_fn(cfg: ModelConfig, kind: str, microbatches: int, grad_sync_once: bool):
    """The step of ``kind``; a train step from ``launch.zero_trainer`` with
    ``grad_sync_once`` (one process: no group, nothing to reduce)."""
    if kind == "train" and grad_sync_once:
        from repro_torch.launch.zero_trainer import make_zero_train_step
        from repro_torch.training import AdamWConfig
        return make_zero_train_step(build_model(cfg), AdamWConfig(), microbatches=microbatches)
    return make_step_fn(cfg, kind, microbatches=microbatches)


def reckon(cfg: ModelConfig, kind: str, seq: int, batch: int, microbatches: int = 1,
           grad_sync_once: bool = False):
    """(flops, peak live bytes) of one step traced over meta tensors."""
    args = step_args(cfg, kind, seq, batch, META)
    step = train_step_fn(cfg, kind, microbatches, grad_sync_once)
    kernel_meta.flops = 0
    with FlopCounterMode(display=False) as counter, LiveBytes() as live:
        for t in tree_leaves(list(args)):
            if isinstance(t, torch.Tensor):
                live.track(t)
        out = step(*args)
        del out, args
    return counter.get_total_flops() + kernel_meta.flops, live.peak


def card_budget(device=None) -> int:
    """Bytes a plan may reckon: ``CARD_BYTES`` less ``HEADROOM``; on a card,
    of what it has left beside the memory the process already holds, when
    that is less (the card's tensors of earlier work stay where they are)."""
    room = CARD_BYTES
    if device is not None and torch.device(device).type == "cuda":
        total = torch.cuda.get_device_properties(device).total_memory
        room = min(room, total - torch.cuda.memory_allocated(device))
    return int(room * (1 - HEADROOM))


def one_card_plan(cfg: ModelConfig, kind: str, seq: int, batch: int, microbatches: int,
                  full: tuple, budget: int = None, grad_sync_once: bool = False
                  ) -> Dict[str, Any]:
    """The largest depth in whole pattern periods whose reckoned peak fits
    ``budget`` (``card_budget()`` by default); ``full`` is the full depth's
    (flops, peak).  The peak grows about linearly with depth: the estimate
    from one period and the full depth is checked by reckoning it, and moved
    down (or one period up) until it is the largest that fits."""
    budget = card_budget() if budget is None else budget
    periods = full_periods(cfg)
    reckoned = {periods: full}

    def fits(n):
        if n not in reckoned:
            reckoned[n] = reckon(cut_depth(cfg, n), kind, seq, batch, microbatches,
                                 grad_sync_once)
        return reckoned[n][1] <= budget

    n = periods
    if not fits(n):
        fits(1)
        slope = max((full[1] - reckoned[1][1]) / max(periods - 1, 1), 1.0)
        n = max(1, min(periods - 1, 1 + int((budget - reckoned[1][1]) // slope)))
        while n > 1 and not fits(n):
            n -= 1
        while n + 1 < periods and fits(n + 1):
            n += 1
    cut = cut_depth(cfg, n)
    return {"batch": batch, "microbatches": microbatches, "periods": n,
            "full_periods": periods, "layers": cut.num_layers, "full_layers": cfg.num_layers,
            "flops": reckoned[n][0], "peak_bytes": reckoned[n][1], "budget_bytes": budget,
            "headroom": HEADROOM, "fits": reckoned[n][1] <= budget}


# ------------------------------------------------------------------ the card

def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fill_decode_caches(caches, pos: int, generator) -> None:
    """Random K/V and recurrent states in place, and each KV slot's position
    as a cache holding ``pos`` tokens keeps it: slot t position t in a
    dense cache, the last ``cap`` positions in a ring."""
    for entry in _cache_entries(caches):
        for name, t in entry.items():
            if name == "slot_pos":
                cap = t.shape[-1]
                s = torch.arange(cap, device=t.device)
                if cap > pos:          # dense: slot t holds position t below pos
                    t.copy_(torch.where(s < pos, s, -1).to(t.dtype).expand_as(t))
                else:                  # ring: slot s holds the last p < pos with p % cap == s
                    t.copy_(((pos - 1) - ((pos - 1 - s) % cap)).to(t.dtype).expand_as(t))
            else:
                t.normal_(generator=generator)
    for name in ("cross_k", "cross_v"):
        if name in caches:
            caches[name].normal_(generator=generator)
    caches["pos"] = pos


def _cache_entries(caches):
    """(the per-layer dicts of) the leaves a decode step writes."""
    if "scan" in caches:
        return list(caches["scan"]) + list(caches["rem"])
    return [caches["self"]]


def _written_slots(cap: int, pos: int, steps: int, window: int, device):
    p = torch.arange(pos, pos + steps, device=device)
    return p % cap if window > 0 else torch.clamp(p, max=cap - 1)


def snapshot(caches, cfg: ModelConfig, steps: int):
    """What ``steps`` decode steps from ``caches`` overwrite: the slots they
    write of every KV leaf, and every recurrent state whole."""
    saved = []
    pos = caches["pos"]
    for entry in _cache_entries(caches):
        for name, t in entry.items():
            if "k" in entry:
                axis = t.dim() - (3 if name in ("k", "v") else 1)
                idx = _written_slots(t.shape[axis], pos, steps, cfg.sliding_window, t.device)
                saved.append((t, axis, idx, t.index_select(axis, idx)))
            else:
                saved.append((t, None, None, t.clone()))
    return saved, pos


def restore(caches, saved) -> None:
    leaves, pos = saved
    for t, axis, idx, value in leaves:
        if axis is None:
            t.copy_(value)
        else:
            t.index_copy_(axis, idx, value)
    caches["pos"] = pos


def decode_run(model, params, token, caches, steps: int):
    """``steps`` greedy decode steps: (logits of each (steps, B, V), the
    step ms measured on the host around synchronised steps)."""
    out, ms = [], []
    for _ in range(steps):
        _sync(token.device)
        t0 = time.perf_counter()
        logits, caches = model.decode_step(params, token, caches)
        _sync(token.device)
        ms.append((time.perf_counter() - t0) * 1e3)
        out.append(logits)
        token = logits.argmax(-1).to(torch.int32)
    return torch.stack(out), ms


def card_run(cfg: ModelConfig, kind: str, seq: int, batch: int, microbatches: int,
             device, seed: int = 0, grad_sync_once: bool = False) -> Dict[str, Any]:
    """Run the plan ``cfg`` (already cut) on ``device``: random weights and
    inputs from ``seed``; ms a step, peak memory (on the card), kernel
    launches.  The CPU tests run it at smoke sizes."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    gen = torch.Generator(device=device).manual_seed(seed)
    model = build_model(cfg)
    _sync(device)
    if cuda:
        before = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    params = model.init(gen, device)
    rand_tokens = lambda *shape: torch.randint(0, cfg.vocab_size, shape, generator=gen,
                                               device=device, dtype=torch.int32)
    frontend = {k: torch.randn(s, generator=gen, device=device).to(torch_dtype(cfg.dtype))
                for k, s in frontend_shapes(cfg, batch).items()}
    rec: Dict[str, Any] = {"layers": cfg.num_layers, "batch": batch}
    launched = kernels.launch_counts()
    if kind == "train":
        step = train_step_fn(cfg, "train", microbatches, grad_sync_once)
        opt = init_opt_state(params)
        data = {"tokens": rand_tokens(batch, seq), "targets": rand_tokens(batch, seq),
                "mask": torch.ones((batch, seq), dtype=torch.float32, device=device),
                **frontend}
        ms, losses = [], []
        for _ in range(2):          # the first step warms up
            _sync(device)
            t0 = time.perf_counter()
            params, opt, metrics = step(params, opt, data)
            losses.append(float(metrics["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
        ok = all(math.isfinite(x) for x in losses)
        rec.update(ms_per_step=ms[-1], ms_first=ms[0], losses=losses,
                   microbatches=microbatches)
    elif kind == "prefill":
        step = make_step_fn(cfg, "prefill")
        data = {"tokens": rand_tokens(batch, seq), **frontend}
        ms = []
        for _ in range(2):
            _sync(device)
            t0 = time.perf_counter()
            logits, caches = step(params, data)
            _sync(device)
            ms.append((time.perf_counter() - t0) * 1e3)
            del caches
        ok = bool(torch.isfinite(logits).all()) and tuple(logits.shape) == (
            batch, cfg.padded_vocab)
        rec.update(ms_per_step=ms[-1], ms_first=ms[0])
    else:
        caches = model.init_caches(batch, decode_capacity(seq), device)
        fill_decode_caches(caches, seq, gen)
        token = rand_tokens(batch)
        saved = snapshot(caches, cfg, DECODE_STEPS)
        first, _ = decode_run(model, params, token, caches, DECODE_STEPS)
        restore(caches, saved)
        again, ms = decode_run(model, params, token, caches, DECODE_STEPS)
        bitwise = bool(torch.equal(first, again))
        ok = bitwise and bool(torch.isfinite(again).all())
        rec.update(ms_per_step=sum(ms) / len(ms), ms_steps=ms, pos=seq,
                   decode_steps=DECODE_STEPS, bitwise_repeat=bitwise)
    _sync(device)
    rec["launches"] = {k: v - launched[k] for k, v in kernels.launch_counts().items()
                       if v > launched[k]}
    rec["max_memory_allocated"] = (torch.cuda.max_memory_allocated(device) - before
                                   if cuda else None)
    rec["ok"] = ok
    rec["device_name"] = torch.cuda.get_device_name(device) if cuda else str(device)
    return rec


# ------------------------------------------------------------------ one case

def run_one(arch: str, shape_name: str, mesh=None, *, device="cuda", microbatches: int = 0,
            zero1: bool = False, grad_sync_once: bool = False, smoke: bool = False,
            seed: int = 0, reckon_step: bool = True) -> Dict[str, Any]:
    """The record of ``arch`` x ``shape_name`` on ``mesh`` (the 16 x 16
    production mesh by default).  ``device="meta"`` only reckons;
    ``"cuda"`` also runs the one-card plan.  ``smoke`` takes the arch's
    smoke config; ``reckon_step`` False stops after the argument bytes,
    before the meta step (the tests' sweep)."""
    if torch.device(device).type != "meta":
        resolve_device(device)          # no card: raise before reckoning
    mesh = mesh or make_production_mesh()
    cfg = get_config(arch, smoke=smoke)
    seq, batch, kind = INPUT_SHAPES[shape_name]
    per_dev = max(batch // data_shards(mesh), 1)
    microbatches = microbatches or cfg.train_microbatches
    microbatches = clip_microbatches(microbatches, per_dev) if kind == "train" else 1
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh.name, "kind": kind,
        "seq_len": seq, "global_batch": batch, "smoke": smoke,
        "params_exact": cfg.param_count(),
        "params_active": cfg.param_count(active_only=True),
    }
    reason = skip_reason(arch, shape_name)
    if reason:
        rec["status"] = "skipped"
        rec["reason"] = reason
        return rec
    t0 = time.perf_counter()
    rec["memory"] = argument_bytes(cfg, kind, seq, batch, mesh, zero1=zero1,
                                   grad_sync_once=grad_sync_once)
    rec["microbatches"] = microbatches
    (rec["collectives"], rec["collectives_body_once"],
     rec["loop_trip_count"]) = collective_bytes(cfg, kind, seq, batch, mesh,
                                                microbatches=microbatches, zero1=zero1,
                                                grad_sync_once=grad_sync_once)
    if not reckon_step:
        rec["status"] = "ok"
        return rec
    flops, peak = reckon(cfg, kind, seq, per_dev, microbatches, grad_sync_once)
    rec["flops"] = flops
    rec["peak_bytes"] = peak
    on_card = torch.device(device).type == "cuda"
    plan = rec["one_card"] = one_card_plan(cfg, kind, seq, per_dev, microbatches,
                                           (flops, peak), card_budget(device if on_card else None),
                                           grad_sync_once)
    rec["reckon_s"] = time.perf_counter() - t0
    if on_card:
        plan["held_bytes"] = torch.cuda.memory_allocated(device)
        if not plan["fits"]:
            rec["status"] = "fail"
            rec["error"] = "one period does not fit one card"
            return rec
        rec["card"] = card_run(cut_depth(cfg, plan["periods"]), kind, seq, per_dev,
                               microbatches, device, seed, grad_sync_once)
        rec["card"]["reckoned_peak_bytes"] = plan["peak_bytes"]
        if not rec["card"]["ok"]:
            rec["status"] = "fail"
            rec["error"] = "the card run's outputs were not finite or did not repeat"
            return rec
    rec["status"] = "ok"
    return rec


def out_path(arch: str, shape: str, mesh_name: str, out_dir: str = None) -> str:
    d = out_dir or OUT_DIR
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"{arch.replace('/', '_')}__{shape}__{mesh_name}.json")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES) + [None])
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: reckon, then run the one-card plan) or meta "
                         "(reckon only)")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--microbatches", type=int, default=0,
                    help="0 = each config's train_microbatches")
    ap.add_argument("--zero1", action="store_true",
                    help="params TP-resident, optimizer state FSDP-sharded")
    ap.add_argument("--grad-sync-once", action="store_true",
                    help="local fp32 gradient accumulation, one all-reduce a step "
                         "(launch/zero_trainer.py); params TP-resident")
    ap.add_argument("--out-dir", default=None)
    args = ap.parse_args(argv)

    archs = list(ASSIGNED_ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    n_ok = n_skip = n_fail = 0
    for arch in archs:
        for shape in shapes:
            for multi in meshes:
                mesh = make_production_mesh(multi_pod=multi)
                path = out_path(arch, shape, mesh.name, args.out_dir)
                if args.skip_existing and os.path.exists(path):
                    print(f"[cached] {arch} {shape} {mesh.name}")
                    continue
                try:
                    rec = run_one(arch, shape, mesh, device=args.device,
                                  microbatches=args.microbatches, zero1=args.zero1,
                                  grad_sync_once=args.grad_sync_once)
                except Exception as e:
                    rec = {"arch": arch, "shape": shape, "mesh": mesh.name, "status": "fail",
                           "error": str(e), "traceback": traceback.format_exc()}
                with open(path, "w") as f:
                    json.dump(rec, f, indent=2)
                st = rec["status"]
                n_ok += st == "ok"
                n_skip += st == "skipped"
                n_fail += st == "fail"
                extra = rec.get("reason", rec.get("error", ""))
                if st == "ok":
                    plan = rec["one_card"]
                    extra = (f"args/dev={rec['memory']['argument_size_in_bytes'] / 2**30:.2f}GiB "
                             f"flops={rec['flops']:.3e} "
                             f"coll/dev={sum(rec['collectives'].values()):.3e}B "
                             f"peak={rec['peak_bytes'] / 1e9:.2f}GB "
                             f"one-card: batch {plan['batch']} x{plan['microbatches']} "
                             f"layers {plan['layers']}/{plan['full_layers']} "
                             f"peak {plan['peak_bytes'] / 1e9:.2f}GB")
                    if "card" in rec:
                        card = rec["card"]
                        extra += (f" card: {card['ms_per_step']:.1f} ms/step, max allocated "
                                  f"{card['max_memory_allocated'] / 1e9:.2f}GB")
                print(f"[{st}] {arch} {shape} {mesh.name} {extra}", flush=True)
    print(f"done: ok={n_ok} skipped={n_skip} fail={n_fail}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
