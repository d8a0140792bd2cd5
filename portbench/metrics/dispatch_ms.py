"""Mean wall ms of a handle_batch_result call, from the span around it."""
import numpy as np


def read(ctx):
    if not ctx.dispatches:
        return None
    return float(np.mean([d["end"] - d["start"] for d in ctx.dispatches]) * 1e3)
