"""Least time of the decode steps' K/V reads (bytes / 3.35 TB/s) over the
decode-attention kernels' device time (%)."""
from portbench import readers, yardstick as ys

DECODE_KERNELS = ("panel_mma_kernel", "decode_split_kernel", "decode_merge_kernel")


def read(ctx):
    if ctx.trace is None:
        return None
    need = 0
    for kind in ("small", "big"):
        cfg = ctx.cfg[kind]
        for c in readers.traced_calls(ctx, kind):
            n, lens = readers.real_rows(c)
            need += sum(ys.decode_kv_bytes(cfg, int(p), int(g))
                        for p, g in zip(lens, c["lengths"][:n]))
    dev = readers.kernel_seconds(ctx, DECODE_KERNELS)
    return 100.0 * need / ys.HBM_BYTES_PER_S / dev if dev > 0 and need else None
