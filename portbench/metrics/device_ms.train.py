"""Device-busy ms per training step in the traced span: a steadier
reading of the device's share of the step than the host-clock rate."""
from portbench.harness import readers


def read(ctx):
    return readers.busy_ms(ctx, per_krays=False)
