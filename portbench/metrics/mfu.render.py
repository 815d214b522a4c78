"""The eval's or relighting's model operations against the H100's float32
peak."""
from portbench.harness import readers


def read(ctx):
    return readers.mfu_pct(ctx)
