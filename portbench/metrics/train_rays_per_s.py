"""Camera rays trained per second over the whole window."""
from portbench.harness import readers


def read(ctx):
    return readers.window_rate(ctx)
