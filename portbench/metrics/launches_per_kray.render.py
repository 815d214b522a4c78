"""Kernels launched per 1,000 camera rays rendered."""
from portbench.harness import readers


def read(ctx):
    return readers.launches(ctx, per_krays=True)
