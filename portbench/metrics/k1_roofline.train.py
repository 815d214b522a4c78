"""K1 (row gather) in the training step: its least time over its device
time."""
from portbench.harness import readers


def read(ctx):
    return readers.roofline_pct(ctx, "k1")
