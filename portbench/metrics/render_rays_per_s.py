"""Camera rays rendered per second over the whole window (a relit ray
counts once every held-out light is done)."""
from portbench.harness import readers


def read(ctx):
    return readers.window_rate(ctx)
