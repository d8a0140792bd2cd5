"""Per-layer readings of the program's spans (``repro_torch/serving/spans.py``).

``READERS`` maps each metric name to its reader.  A reader takes a
``harness.Context`` that also holds ``spans``, the records of one
``SpanRecorder`` attached to the scheduler and to the engine for the run,
and returns a number, or None when there is nothing to read.  The device
readings also need ``ctx.trace["launch_join"]``, the result of
``launch_join.join``.

Which calls each reading takes: counts (``program_counter``) the whole
window's dispatches; host-clock times (``program_span``) only the calls
that start after the profiled part has ended, since the profiler's host
cost slows the part it traces; device readings (``device_trace``) only the
calls inside the profiled part.  The harness's dispatch records name the
window; the program's ``dispatch`` span around each is found by time (it
opens before the harness's and closes after it).  A generate call is read
from the program's spans alone: it opens with its ``prefill``, and its
spans carry the model that made them (``lm``, ``small`` or ``big``).
"""
from __future__ import annotations

import numpy as np

GEN = ("prefill", "decode", "fetch")


def _roots(ctx, dispatches):
    """The program's ``dispatch`` span around each harness dispatch."""
    roots = sorted((s for s in ctx.spans if s.name == "dispatch"), key=lambda s: s.start)
    starts = np.array([s.start for s in roots])
    out = []
    for d in dispatches:
        k = int(np.searchsorted(starts, d["start"], side="right")) - 1
        if k >= 0 and roots[k].end >= d["end"]:
            out.append(roots[k])
    return out


def _calls(ctx, roots, lm):
    """The generate calls of ``lm`` (``small``, ``big``) in the dispatches
    ``roots``, each a dict of its spans by name."""
    ids = {r.sid for r in roots}
    out = []
    for s in ctx.spans:                   # in the order they opened
        if s.lm == lm and s.dispatch in ids and s.name in GEN:
            if s.name == "prefill":
                out.append({})
            out[-1][s.name] = s
    return out


def _window(ctx):
    return _roots(ctx, ctx.dispatches)


def _after_trace(ctx):
    """The window's dispatches that start after the profiled part."""
    t1 = ctx.trace["t1"] if ctx.trace else -np.inf
    return _roots(ctx, [d for d in ctx.dispatches if d["start"] >= t1])


def _in_trace(ctx):
    t = ctx.trace
    return _roots(ctx, [d for d in ctx.all_dispatches
                        if d["start"] >= t["t0"] and d["end"] <= t["t1"]])


def _joined(ctx):
    t = ctx.trace
    return None if t is None or "launch_join" not in t else t["launch_join"]


def tweak_calls(ctx):
    """Small-LM generate calls a dispatch that has TWEAK rows."""
    roots = {r.sid for r in _window(ctx)}
    per = [s.counts["calls"] for s in ctx.spans
           if s.name == "tweak_prompt" and s.dispatch in roots]
    return float(np.mean(per)) if per else None


def step_ms(ctx, lm):
    """(``decode`` + ``fetch``) wall ms over decode steps, ``lm``'s calls
    after the profiled part."""
    calls = [c for c in _calls(ctx, _after_trace(ctx), lm) if "decode" in c and "fetch" in c]
    steps = sum(c["decode"].counts["steps"] for c in calls)
    if not steps:
        return None
    return 1e3 * sum(c["decode"].seconds + c["fetch"].seconds for c in calls) / steps


def step_launches(ctx, lm):
    """Launches inside ``lm``'s ``decode`` spans over their steps, the
    calls inside the profiled part."""
    j = _joined(ctx)
    if j is None:
        return None
    dec = [c["decode"] for c in _calls(ctx, _in_trace(ctx), lm) if "decode" in c]
    steps = sum(s.counts["steps"] for s in dec)
    if not steps:
        return None
    at = np.sort([k[3] for k in j["kernels"]])
    n = sum(np.searchsorted(at, s.end, side="right") - np.searchsorted(at, s.start)
            for s in dec)
    return float(n) / steps


def prefill_real_share(ctx):
    """Prompt positions needed over positions computed, both LMs (%)."""
    pre = [c["prefill"] for lm in ("small", "big")
           for c in _calls(ctx, _window(ctx), lm) if "prefill" in c]
    computed = sum(s.counts["computed"] for s in pre)
    return 100.0 * sum(s.counts["needed"] for s in pre) / computed if computed else None


def decode_real_share(ctx):
    """Real generated tokens over rows × budget, both LMs (%)."""
    calls = [c for lm in ("small", "big") for c in _calls(ctx, _window(ctx), lm)
             if "decode" in c and "fetch" in c]
    slots = sum(c["decode"].counts["rows"] * c["decode"].counts["budget"] for c in calls)
    return 100.0 * sum(c["fetch"].counts["tokens"] for c in calls) / slots if slots else None


def prefill_device_ms(ctx):
    """Device ms of the kernels launched inside ``prefill`` spans, a
    dispatch of the profiled part that holds one."""
    j = _joined(ctx)
    if j is None:
        return None
    roots = _in_trace(ctx)
    pre = [c["prefill"] for lm in ("small", "big") for c in _calls(ctx, roots, lm)
           if "prefill" in c]
    if not pre:
        return None
    iv = np.array(sorted((s.start, s.end) for s in pre))
    at = np.array([k[3] for k in j["kernels"]])
    dur = np.array([k[2] - k[1] for k in j["kernels"]])
    k = np.searchsorted(iv[:, 0], at, side="right") - 1
    inside = (k >= 0) & (at <= iv[np.clip(k, 0, None), 1])
    n = len({s.dispatch for s in pre})
    return 1e3 * float(dur[inside].sum()) / n


def decode_idle(ctx):
    """Share of the ``decode`` + ``fetch`` span time, both LMs, the calls
    inside the profiled part, with no kernel on the card (%)."""
    j = _joined(ctx)
    if j is None:
        return None
    spans = [c[n] for lm in ("small", "big") for c in _calls(ctx, _in_trace(ctx), lm)
             for n in ("decode", "fetch") if n in c]
    total = sum(s.seconds for s in spans)
    if total <= 0:
        return None
    busy = _union([(k[1], k[2]) for k in j["kernels"]])
    covered = sum(_overlap(busy, s.start, s.end) for s in spans)
    return 100.0 * (1.0 - covered / total)


def _union(iv):
    """Sorted disjoint intervals covering ``iv``."""
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.array(out).reshape(-1, 2)


def _overlap(union, a, b):
    """Length of [a, b] that the disjoint sorted ``union`` covers."""
    seg = union[np.searchsorted(union[:, 1], a, side="right"):
                np.searchsorted(union[:, 0], b, side="left")]
    return float(np.clip(np.minimum(seg[:, 1], b) - np.maximum(seg[:, 0], a), 0, None).sum())


READERS = {
    "tweak_calls.closed": tweak_calls,
    "tweak_step_ms.closed": lambda ctx: step_ms(ctx, "small"),
    "tweak_step_launches.closed": lambda ctx: step_launches(ctx, "small"),
    "miss_step_ms.closed": lambda ctx: step_ms(ctx, "big"),
    "miss_step_ms.open": lambda ctx: step_ms(ctx, "big"),
    "miss_step_launches.closed": lambda ctx: step_launches(ctx, "big"),
    "miss_step_launches.open": lambda ctx: step_launches(ctx, "big"),
    "prefill_real_share.closed": prefill_real_share,
    "decode_real_share.closed": decode_real_share,
    "decode_real_share.open": decode_real_share,
    "prefill_device_ms.closed": prefill_device_ms,
    "decode_idle.closed": decode_idle,
    "decode_idle.open": decode_idle,
}
