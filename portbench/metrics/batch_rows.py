"""Mean unique rows a dispatch, from the dispatch spans."""
import numpy as np


def read(ctx):
    return float(np.mean([len(d["texts"]) for d in ctx.dispatches])) if ctx.dispatches else None
