"""Least time of the flat scans over the scan kernel's device time (%).

The least time reads the rows the bank held at each lookup, not its
capacity: the kernel scans every slot behind a validity mask, and a slot
that no entry has reached is work that no lookup needs."""
from portbench import readers, yardstick as ys

SCAN_KERNELS = ("cosine_topk",)


def read(ctx):
    if ctx.trace is None:
        return None
    t = ctx.trace
    dim = ctx.cfg["embedder"]["d_model"]
    need = sum(ys.scan_bytes(d["route"]["bank_rows"], dim, d["route"]["rows"])
               for d in ctx.all_dispatches
               if d["route"] and d["route"]["start"] >= t["t0"] and d["route"]["end"] <= t["t1"])
    dev = readers.kernel_seconds(ctx, SCAN_KERNELS)
    return 100.0 * need / ys.HBM_BYTES_PER_S / dev if dev > 0 and need else None
