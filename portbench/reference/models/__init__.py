"""Frozen copy (plain PyTorch) of the port's modules of the same name."""
