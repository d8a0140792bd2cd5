"""Model FLOPs of the tokens both LMs served in the traced window (the prompt
positions computed and the decode steps) over the window at the bf16 peak (%)."""
from portbench import readers, yardstick as ys


def read(ctx):
    if ctx.trace is None:
        return None
    flops = 0
    for kind in ("small", "big"):
        cfg = ctx.cfg[kind]
        for c in readers.traced_calls(ctx, kind):
            n, lens = readers.real_rows(c)
            flops += sum(ys.row_flops(cfg, int(p), len(c["prefix"]), int(g))
                         for p, g in zip(lens, c["lengths"][:n]))
    w = ctx.trace["window_s"]
    return 100.0 * flops / (w * ys.BF16_FLOPS) if flops and w > 0 else None
