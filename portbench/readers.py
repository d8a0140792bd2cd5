"""What the per-layer metrics share.  Each metric is a file
``portbench/metrics/<name>.py`` (or ``<base>.py`` for a name
``<base>.<variant>``) whose ``read(ctx)`` returns a number, or None when
there is nothing to read (the harness then leaves the metric out).
``ctx`` is ``harness.Context``: the window's dispatches, spans, requests
and counters, and in a traced run the device trace.
"""
from __future__ import annotations

import numpy as np


def gen_ms(ctx, kind: str):
    """Mean wall ms of a model's generate calls per dispatch that has any."""
    per = [sum(c["end"] - c["start"] for c in d[kind]) for d in ctx.dispatches if d[kind]]
    return float(np.mean(per) * 1e3) if per else None


def traced_calls(ctx, kind: str):
    """Generate calls of ``kind`` that lie inside the traced window."""
    t = ctx.trace
    return [c for d in ctx.all_dispatches for c in d[kind]
            if c["start"] >= t["t0"] and c["end"] <= t["t1"]]


def real_rows(call):
    """(rows, prompt lengths): a padded call repeats row 0 in its padding
    rows, and no real prompt holds the pad id 0."""
    tok = np.asarray(call["tokens"])
    n = tok.shape[0]
    while n > 1 and np.array_equal(tok[n - 1], tok[0]) and np.array_equal(
            call["out"][n - 1], call["out"][0]):
        n -= 1
    lens = (tok[:n] != 0).sum(axis=1) + len(call["prefix"])
    return n, lens


def kernel_seconds(ctx, names):
    """Device seconds of the traced kernels whose names hold any of ``names``."""
    t = ctx.trace
    return sum(e - s for n, s, e in t["kernels"] if any(k in n for k in names))
