"""95th percentile of the wait from a request's due time to the start of its
dispatch (ms), from the dispatch spans."""
import numpy as np


def read(ctx):
    w = [r["start"] - r["due"] for r in ctx.requests if r.get("start") is not None]
    return float(np.percentile(w, 95) * 1e3) if w else None
