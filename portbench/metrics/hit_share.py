"""(EXACT + TWEAK) / rows routed over the window (%), from EngineStats."""


def read(ctx):
    a, b = ctx.stats_start, ctx.stats_end
    total = b.total - a.total
    if not total:
        return None
    return 100.0 * ((b.exact - a.exact) + (b.tweak - a.tweak)) / total
