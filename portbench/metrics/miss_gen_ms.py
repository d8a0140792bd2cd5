"""Wall ms of the big model's generate calls a dispatch that has MISS rows."""
from portbench import readers


def read(ctx):
    return readers.gen_ms(ctx, "big")
