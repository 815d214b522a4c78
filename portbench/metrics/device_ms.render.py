"""Device-busy ms per 1,000 camera rays rendered in the traced span: a
steadier reading of the device's share than the host-clock rate."""
from portbench.harness import readers


def read(ctx):
    return readers.busy_ms(ctx, per_krays=True)
