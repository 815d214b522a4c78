"""Hand-written CUDA kernels of the port and their plain PyTorch versions."""
from tensoir_tpu_torch.kernels.rows import (  # noqa: F401
    LAUNCHES, RowGather, RowScatterAdd, gather_rows, reset_launch_counts,
    row_gather, row_gather_plain, row_scatter_add, row_scatter_add_plain)
