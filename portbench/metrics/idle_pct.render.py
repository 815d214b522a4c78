"""Share of the traced span of chunks in which no operation ran on the
device."""
from portbench.harness import readers


def read(ctx):
    return readers.idle_pct(ctx)
