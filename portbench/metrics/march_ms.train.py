"""Device ms per step of the kernels in the secondary_march range (forward
only: the backward runs outside the ranges)."""
from portbench.harness import readers


def read(ctx):
    return readers.range_ms(ctx, ("secondary_march",), per_krays=False)
