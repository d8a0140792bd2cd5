"""The device trace of a ``--trace 1`` run joined to the program's spans
(``repro_torch/serving/spans.py``).

``trace.py`` puts each kernel on the host clock by its device start.  With
the kernels, Kineto returns the CUDA runtime's and driver's launch records
(``cudaLaunchKernel*``, ``cuLaunchKernel*``): each carries the host time of
a launch and the correlation id of the kernel it launched.  The copies and
sets on the card have theirs too (``cudaMemcpy*``, ``cudaMemset*``).
``join`` matches each kernel to its launch by that id, so a kernel is put
down to the program span open when the host launched it, not to the span
open when the card got to it: where the host runs ahead of the card, a
later one.  A trace with no
launch records falls back to each kernel's device start, which is right
only where the card waits on the host (a host-bound decode).

``attribute`` labels each idle gap of the card with the innermost harness
span around it (``record.py``'s) and, inside it, the innermost program
span: ``<harness span>/<program span>``, so ``small_gen/decode``.

``join``'s mapping of the device clock (the marker kernels, the window
filter) repeats ``trace.Tracer.result``'s, and ``harness_labels`` repeats
``trace._attribute``'s rule.  Wiring this module into the harness replaces
that mapping and ``_attribute`` with ``join`` and ``attribute``, so that
one implementation of each is left.
"""
from __future__ import annotations

import numpy as np

from .trace import INNER_FIRST, SPIN

LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpy", "cudaMemset")
ROOT = "dispatch"             # the program's root span, the harness's ``dispatch`` twin


def events(prof):
    """(kernels, launches) of a finished ``torch.profiler`` session:
    kernels ``(name, start ns, end ns, correlation id)`` as ``trace.py``
    reads them (every event on the card), launches ``{correlation id:
    host ns}``."""
    import torch
    kernels, launches = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            kernels.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                            e.correlation_id()))
        elif e.name().startswith(LAUNCHES):
            launches[e.correlation_id()] = e.start_ns()
    return kernels, launches


def join(kernels, launches, t0: float, t1: float) -> dict:
    """Each kernel of the traced part on the host clock with its launch.

    ``t0`` / ``t1`` are the host readings taken just before the opening
    and closing marker kernels (``trace.Tracer``); the device times map
    onto the host clock as ``trace.py`` maps them, by the opening marker's
    device start, and the launch times by the opening marker's own launch
    record where there is one.  Returns ``kernels`` ``[(name, start, end,
    launch)]`` (a kernel with no launch record gets its start),
    ``matched``, ``unmatched``, ``method`` (``launch`` or
    ``device_start``) and ``launch_lag_s`` (the opening marker's launch
    to its start)."""
    ev = sorted(kernels, key=lambda k: k[1])
    spins = [k for k in ev if SPIN in k[0]]
    work = [k for k in ev if SPIN not in k[0]]
    if len(spins) < 2:
        raise RuntimeError("the trace lost its marker kernels")
    first_work = work[0][1] if work else spins[-1][1]
    m0 = max((k for k in spins if k[1] < first_work), key=lambda k: k[1])
    off_dev = m0[1] / 1e9 - t0
    off_host = launches[m0[3]] / 1e9 - t0 if m0[3] in launches else off_dev
    out, matched = [], 0
    for name, s, e, corr in work:
        s, e = s / 1e9 - off_dev, e / 1e9 - off_dev
        if not (s < t1 and e > t0):
            continue
        at = launches.get(corr)
        matched += at is not None
        out.append((name, s, e, s if at is None else at / 1e9 - off_host))
    return {"kernels": out, "matched": matched, "unmatched": len(out) - matched,
            "method": "launch" if launches else "device_start",
            "launch_lag_s": off_dev - off_host}


def innermost(spans, times):
    """Index into ``spans`` ((name, start, end) intervals that nest, as
    the recorder's do) of the innermost one holding each of ``times``, or
    -1.  One sweep over the starts and ends (a span that ends closes
    before its sibling opens; an empty span holds no time), then a search
    a time."""
    held = [(i, s, e) for i, (_, s, e) in enumerate(spans) if e > s]
    edges = sorted([(s, 1, i) for i, s, _ in held] + [(e, 0, i) for i, _, e in held])
    at, top, stack = [], [], []
    for t, opening, i in edges:
        if opening:
            stack.append(i)
        elif i in stack:
            del stack[stack.index(i):]
        at.append(t)
        top.append(stack[-1] if stack else -1)
    if not at:
        return np.full(len(times), -1)
    k = np.searchsorted(np.array(at), np.asarray(times, dtype=float), side="right") - 1
    return np.where(k >= 0, np.array(top)[np.clip(k, 0, None)], -1)


def harness_labels(times, harness_spans):
    """The innermost harness span (``record.Log.spans``) around each time,
    ``harness`` outside every span: ``trace._attribute``'s rule."""
    label = np.full(len(times), "harness", dtype=object)
    todo = np.ones(len(times), dtype=bool)
    times = np.asarray(times, dtype=float)
    for name in INNER_FIRST:
        iv = np.array(sorted((s, e) for n, s, e, _ in harness_spans if n == name)).reshape(-1, 2)
        if not len(iv):
            continue
        k = np.searchsorted(iv[:, 0], times, side="right") - 1
        hit = todo & (k >= 0) & (times <= iv[np.clip(k, 0, None), 1])
        label[hit] = name
        todo &= ~hit
    return label


def labels(times, harness_spans, program_spans):
    """``<harness span>/<program span>`` at each time, the harness span
    alone where no program span but the root is open."""
    inner = [(s.name, s.start, s.end) for s in program_spans if s.name != ROOT]
    idx = innermost(inner, times)
    return [h if i < 0 else f"{h}/{inner[i][0]}"
            for h, i in zip(harness_labels(times, harness_spans), idx)]


def attribute(gaps, harness_spans, program_spans) -> dict:
    """Idle seconds by label, each gap put down at its midpoint."""
    out = {}
    if not gaps:
        return out
    g = np.array(gaps)
    for lab, d in zip(labels(g.mean(axis=1), harness_spans, program_spans), g[:, 1] - g[:, 0]):
        out[lab] = out.get(lab, 0.0) + float(d)
    return out
