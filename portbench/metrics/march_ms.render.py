"""Device ms per 1,000 camera rays of the kernels in the visibility
(relighting) or secondary_march (eval) range."""
from portbench.harness import readers


def read(ctx):
    return readers.range_ms(ctx, ("visibility", "secondary_march"),
                            per_krays=True)
