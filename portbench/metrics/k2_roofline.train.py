"""K2 (row scatter-add) in the training step: its least time over its
device time."""
from portbench.harness import readers


def read(ctx):
    return readers.roofline_pct(ctx, "k2")
