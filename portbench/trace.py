"""The device trace of a ``--trace 1`` run: ``torch.profiler`` over the
first ``TRACE_SECONDS`` of the window, device activity only.

The profiler's timestamps are on another clock than the harness's spans,
so the traced part opens and closes with a marker kernel launched on an
idle card right after a host-clock reading; the marker's recorded start
gives the offset.  The session first waits and launches sentinel kernels,
since Kineto drops the first records of a session once the process has run
autograd on the card (the embedder's training).
"""
from __future__ import annotations

import time

import numpy as np
import torch

SPIN = "spin_kernel"              # torch.cuda._sleep's kernel
SENTINELS = 32
INNER_FIRST = ("lookup", "insert", "small_gen", "big_gen", "dispatch")


class Tracer:
    def __init__(self, device, seconds: float):
        self.on = device is not None and torch.device(device).type == "cuda"
        self.seconds = seconds
        self.prof = None
        self.t0 = self.t1 = None

    def prepare(self):
        if not self.on:
            return
        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.__enter__()
        time.sleep(0.1)
        for _ in range(SENTINELS):
            torch.cuda._sleep(20_000)
        torch.cuda.synchronize()
        time.sleep(0.01)

    def _mark(self):
        torch.cuda.synchronize()
        t = time.monotonic()
        torch.cuda._sleep(1_000)
        return t

    def start(self, t0):
        if self.on:
            self.t0 = self._mark()

    def maybe_stop(self, now):
        if self.on and self.t1 is None and now - self.t0 >= self.seconds:
            self.stop(now)

    def stop(self, now):
        if not self.on or self.t1 is not None:
            return
        self.t1 = self._mark()
        torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)

    def result(self, log):
        """busy_s, window_s, the kernels on the host clock, the breakdown."""
        ev = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in self.prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA]
        ev.sort(key=lambda e: e[1])
        spins = [e for e in ev if SPIN in e[0]]
        work = [e for e in ev if SPIN not in e[0]]
        if len(spins) < 2:
            raise RuntimeError("the trace lost its marker kernels")
        first_work = work[0][1] if work else spins[-1][1]
        m0 = max((e for e in spins if e[1] < first_work), key=lambda e: e[1])
        m1 = spins[-1]
        off0 = m0[1] / 1e9 - self.t0
        off1 = m1[1] / 1e9 - self.t1
        kernels = [(n, s / 1e9 - off0, e / 1e9 - off0) for n, s, e in work]
        kernels = [k for k in kernels if k[1] < self.t1 and k[2] > self.t0]
        busy, gaps = _busy(kernels, self.t0, self.t1)
        window = self.t1 - self.t0
        ops = {}
        for n, s, e in kernels:
            ops[n[:64]] = ops.get(n[:64], 0.0) + (e - s)
        idle = _attribute(gaps, log.spans)
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        return {"t0": self.t0, "t1": self.t1, "window_s": window, "busy_s": busy,
                "kernels": kernels, "clock_drift_s": off1 - off0,
                "breakdown": {"device_ops": top(ops), "idle_gaps": top(idle)}}


def _busy(kernels, t0, t1):
    """Length of the union of the kernels' intervals within [t0, t1], and
    the idle gaps between them."""
    busy, gaps = 0.0, []
    cur_s = cur_e = None
    for _, s, e in sorted(kernels, key=lambda k: k[1]):
        s, e = max(s, t0), min(e, t1)
        if cur_e is None:
            if s > t0:
                gaps.append((t0, s))
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
        if cur_e < t1:
            gaps.append((cur_e, t1))
    else:
        gaps.append((t0, t1))
    return busy, gaps


def _attribute(gaps, spans):
    """Idle seconds by what the host was doing: the innermost harness span
    around each gap's midpoint, ``harness`` outside every span."""
    if not gaps:
        return {}
    g = np.array(gaps)
    mid = g.mean(axis=1)
    length = g[:, 1] - g[:, 0]
    label = np.full(len(g), "harness", dtype=object)
    todo = np.ones(len(g), dtype=bool)
    for name in INNER_FIRST:
        iv = np.array(sorted((s, e) for n, s, e, _ in spans if n == name)).reshape(-1, 2)
        if not len(iv):
            continue
        k = np.searchsorted(iv[:, 0], mid, side="right") - 1
        hit = todo & (k >= 0) & (mid <= iv[np.clip(k, 0, None), 1])
        label[hit] = name
        todo &= ~hit
    out = {}
    for n, d in zip(label, length):
        out[n] = out.get(n, 0.0) + float(d)
    return out
