"""Kernels launched per training step."""
from portbench.harness import readers


def read(ctx):
    return readers.launches(ctx, per_krays=False)
