"""One run of one cell: set-up, the measured window, the metrics, the check.

``run`` is the whole of ``portbench/run.py`` but for the look for a chip,
so the CPU tests can drive a run at a small size.  Everything that belongs
to one configuration, traffic mix or per-layer metric is found by name
under the spec's root: ``BENCHMARK.json``, ``portbench/configs/``,
``portbench/traffic/``, ``portbench/metrics/<name>.py`` and
``portbench/limits/<workload>.json`` (the limits of the check).
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import check as check_lib
from . import stack as stack_lib
from . import trace as trace_lib
from .traffic import Traffic

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TRACE_SECONDS = 6.0      # the traced part of a --trace 1 window


def load_spec(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def resolve(root: Path, spec: dict, workload: str):
    """(cell, configuration entry, configuration file, traffic file, limits)
    of a workload, each found by its name."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; known: {sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    cfg_file = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "portbench" / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    limits = json.loads((root / "portbench" / "limits" / f"{workload}.json").read_text())
    return cell, conf, cfg_file, traffic, limits


def metrics_of(spec: dict, cell: dict, trace: bool):
    """The cell's end-to-end metrics (``trace`` False) or per-layer ones."""
    name = cell["name"]
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def reader(root: Path, metric: str):
    """The ``read`` of ``metrics/<metric>.py``; a name ``<base>.<variant>``
    with no file of its own is read by ``metrics/<base>.py``, one
    computation for each kind of cell whose end-to-end metric it moves."""
    d = root / "portbench" / "metrics"
    path = d / f"{metric}.py"
    if not path.exists() and "." in metric:
        path = d / f"{metric.rsplit('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location("portbench_metric_" + path.stem.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Context:
    """What a per-layer metric reads."""
    cell: dict
    cfg: dict
    dispatches: list          # dispatches that started and ended in the window
    all_dispatches: list
    requests: list            # dicts: due, start, finish (open loop)
    stats_start: object
    stats_end: object
    trace: dict = None


# ------------------------------------------------------------- the window

def closed_loop(st, texts, clients: int, seconds: float, tracer):
    """``clients`` callers, each sending its next text as its last returns;
    the window closes after ``seconds``, then what is queued is drained."""
    sched = st.sched
    it = iter(texts)
    reqs = []
    t0 = time.monotonic()
    end = t0 + seconds
    tracer.start(t0)
    for _ in range(clients):
        reqs.append(sched.submit(next(it)))
    while True:
        done = sched.poll()
        now = time.monotonic()
        tracer.maybe_stop(now)
        if now >= end:
            break
        for _ in done:
            reqs.append(sched.submit(next(it)))
        if not done:
            w = sched.next_wakeup()
            if w is not None and w > now:
                time.sleep(min(w - now, end - now))
    tracer.stop(time.monotonic())
    sched.flush()
    return t0, end, reqs


def open_loop(st, texts, due, seconds: float, tracer):
    """Requests sent at their due times whatever the system does; a
    request's latency runs from its due time to the end of its dispatch."""
    from repro_torch.serving.scheduler import QueueFull
    sched = st.sched
    reqs = []
    t0 = time.monotonic()
    end = t0 + seconds
    n_due = int(np.searchsorted(due, seconds))
    k = 0
    tracer.start(t0)
    while True:
        now = time.monotonic()
        while k < n_due and t0 + due[k] <= now:
            try:
                r = sched.submit(texts[k])
            except QueueFull:          # shed: counted as missing
                r = None
            reqs.append((t0 + due[k], r))
            k += 1
        sched.poll()
        now = time.monotonic()
        tracer.maybe_stop(now)
        if k >= n_due and sched.pending == 0:
            break
        nxt = [t0 + due[k]] if k < n_due else []
        w = sched.next_wakeup()
        if w is not None:
            nxt.append(w)
        if nxt and min(nxt) > now:
            time.sleep(min(nxt) - now)
    tracer.stop(time.monotonic())
    return t0, end, reqs


def _dispatch_of(ends, finish):
    """Index of the dispatch a completion came from: the last to end at or
    before it (the scheduler stamps ``finish`` right after the engine)."""
    return int(np.searchsorted(ends, finish, side="right")) - 1


def closed_metrics(ran, reqs, w0, w1) -> dict:
    """``req_per_s`` over whole dispatches: the requests served by the
    dispatches that started and ended inside [w0, w1], over the time from
    the first one's start to the last one's end; with ``attempted`` (sent
    before w1) and ``failed`` (never answered)."""
    ends = np.array([d["end"] for d in ran])
    inside = {i for i, d in enumerate(ran) if d["start"] >= w0 and d["end"] <= w1}
    out = {"attempted": 0, "failed": 0}
    n = 0
    for r in reqs:
        if r.arrival >= w1:
            continue
        out["attempted"] += 1
        if r.finish is None:
            out["failed"] += 1
        elif _dispatch_of(ends, r.finish) in inside:
            n += 1
    if inside:
        first, last = ran[min(inside)], ran[max(inside)]
        out["req_per_s"] = n / (last["end"] - first["start"])
    return out


def open_metrics(ran, reqs):
    """``lat_p95_ms`` and ``lat_p50_ms`` over every request due in the
    window, from its due time to the end of its dispatch; a request shed or
    never answered counts as missing every limit (infinite).  Also the
    rows (due, start of its dispatch, finish) the per-layer metrics read."""
    ends = np.array([d["end"] for d in ran])
    rows = []
    for due, r in reqs:
        if r is None or r.finish is None:
            rows.append({"due": due, "start": None, "finish": float("inf")})
        else:
            rows.append({"due": due, "start": ran[_dispatch_of(ends, r.finish)]["start"],
                         "finish": r.finish})
    out = {}
    if rows:
        lat = np.array([r["finish"] - r["due"] for r in rows]) * 1e3
        # nearest rank: a missing request (infinite) is a sample, not a NaN
        out["lat_p95_ms"] = float(np.percentile(lat, 95, method="inverted_cdf"))
        out["lat_p50_ms"] = float(np.percentile(lat, 50, method="inverted_cdf"))
    return out, rows


# ------------------------------------------------------------- one run

@torch.no_grad()
def run(root: Path, workload: str, seed: int, seconds: float, trace: bool, *,
        device="cuda", t_proc=None, control=False, rate=None, fault=None):
    """One run; returns (result dict, lines for standard error).

    ``control`` reads the check with the reference in the program's place
    at the next precision down; ``rate`` overrides an open loop's rate (the
    sweep); ``fault`` (tests only) breaks the timed path underneath."""
    t_proc = time.monotonic() if t_proc is None else t_proc
    spec = load_spec(root)
    cell, conf, cfg_file, traffic_spec, limits = resolve(root, spec, workload)
    if rate is not None:
        traffic_spec = dict(traffic_spec, rate_per_s=rate)
    err = []
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    st = stack_lib.build(cfg_file, seed, device)
    t = time.monotonic()
    traffic = Traffic(traffic_spec, seed, seconds)
    stack_lib.fill_bank(st, traffic.warm)
    stack_lib._sync(device)
    st.phases["bank_fill"] = time.monotonic() - t
    t = time.monotonic()
    stack_lib.warm_up(st, traffic.warmup, device)
    st.phases["warm_up"] = time.monotonic() - t
    if fault is not None:
        fault(st)
    tracer = trace_lib.Tracer(device if trace else None, TRACE_SECONDS)
    tracer.prepare()
    # what set-up made (the bank's text mirror, the warm set) stays out of the
    # collector's scans inside the window
    gc.collect()
    gc.freeze()
    stats0 = stack_lib.stats_copy(st.engine.stats)
    n_before = len(st.log.dispatches)
    if traffic.loop == "closed":
        w0, w1, reqs = closed_loop(st, traffic.stream, traffic_spec["clients"], seconds, tracer)
    else:
        w0, w1, reqs = open_loop(st, traffic.stream, traffic.due, seconds, tracer)
    stats1 = stack_lib.stats_copy(st.engine.stats)
    gc.unfreeze()
    setup_s = w0 - t_proc
    if cuda:
        torch.cuda.synchronize()
    mem_peak = torch.cuda.max_memory_allocated() if cuda else 0
    ran = st.log.dispatches[n_before:]
    if traffic.loop == "closed":
        e2e, rows = closed_metrics(ran, reqs, w0, w1), []
        attempted, failed = e2e.pop("attempted"), e2e.pop("failed")
    else:
        e2e, rows = open_metrics(ran, reqs)
        attempted, failed = len(reqs), sum(r["start"] is None for r in rows)
    inside = [d for d in ran if d["start"] >= w0 and d["end"] <= w1]
    e2e["setup_s"] = setup_s
    counts = {k: getattr(stats1, k) - getattr(stats0, k) for k in ("total", "exact", "tweak",
                                                                  "miss")}
    err.append("routes in the window: " + json.dumps(counts) + f" dispatches {len(inside)}"
               f" of {len(ran)}")
    err.append("set-up by phase (s): " + json.dumps({k: round(v, 3) for k, v in
                                                     st.phases.items()}))
    if traffic.loop == "open":
        late = [r.arrival - due for due, r in reqs if r is not None]
        err.append(f"generator lateness (ms): p50 {np.percentile(late, 50) * 1e3:.3f} "
                   f"p99 {np.percentile(late, 99) * 1e3:.3f} max {max(late) * 1e3:.3f} "
                   f"over {len(late)} sends at {traffic_spec['rate_per_s']} req/s")
        served = [r for r in rows if r["start"] is not None]
        waits = [r["start"] - r["due"] for r in served]
        half = len(waits) // 2
        if half:
            rate = len(served) / (max(r["finish"] for r in served) - w0)
            err.append(f"backlog: served {rate:.3f} req/s; queue wait p50 first half "
                       f"{np.median(waits[:half]) * 1e3:.1f} ms, second half "
                       f"{np.median(waits[half:]) * 1e3:.1f} ms")
    ctx = Context(cell, st.cfg, inside, ran, rows, stats0, stats1)
    result_metrics = {}
    breakdown = None
    if trace:
        ctx.trace = tracer.result(st.log)
        for m in metrics_of(spec, cell, True):
            v = reader(root, m["name"])(ctx)
            if v is not None:
                result_metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        breakdown = ctx.trace["breakdown"]
    else:
        for m in metrics_of(spec, cell, False):
            if m["name"] in e2e:
                result_metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    # the check, after the window, the peak read and the program's state freed
    window_ids = [d["index"] for d in inside]
    sample = check_lib.choose_sample(st.log, window_ids, seed)
    rows_read = check_lib.bank_rows(st.engine, st.log, sample)
    st.engine = st.entry = st.sched = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.monotonic()
    nums, det = check_lib.run_check(st, traffic, window_ids, sample, rows_read, seed, device,
                                    control=control)
    err.append(f"check: {json.dumps(det)} in {time.monotonic() - t:.1f} s over dispatches "
               f"{sample} (generation) and {len(window_ids)} (routes)")
    compared = {k: {"value": nums[k], "limit": limits.get(k)} for k in check_lib.NUMBERS}
    correct = failed == 0 and all(v["value"] <= v["limit"] for v in compared.values()
                                  if v["limit"] is not None)
    mods = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(mem_peak)}
    if trace:
        device_info.update(busy_s=ctx.trace["busy_s"], window_s=ctx.trace["window_s"])
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": result_metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checked"] = compared
    for k, v in compared.items():
        err.append(f"{k} {v['value']!r} limit {v['limit']!r}")
    return result, err, mods
