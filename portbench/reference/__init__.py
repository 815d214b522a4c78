"""The plain reference of the benchmark: a frozen copy, in plain PyTorch,
of the modules of the port that the measured paths run, with its two row
kernels replaced by ``table[idx]`` (``kernels.py``). It imports nothing of
the port, of JAX or of the JAX package, and is run on the benchmark's own
inputs after the program's state is freed."""
