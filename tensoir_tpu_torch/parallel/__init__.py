"""Data-parallel training over several GPUs, one process per GPU (port of
tensoir_tpu.parallel)."""
from tensoir_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    shard_batch,
    replicate,
)
