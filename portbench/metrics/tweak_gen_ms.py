"""Wall ms of the small model's generate calls a dispatch that has TWEAK rows."""
from portbench import readers


def read(ctx):
    return readers.gen_ms(ctx, "small")
