"""Multi-process execution (port of tensoir_tpu.parallel.multihost): one
process per GPU under ``torch.distributed``.

A run is launched by PyTorch's own launcher, which sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK`` and the rendezvous address in each
process's environment:

    python -m torch.distributed.run --nproc_per_node N \\
        -m tensoir_tpu_torch.train_tensoir --config ...

    from tensoir_tpu_torch.parallel import multihost
    multihost.initialize()                  # no-op without a launcher
    rays, _, _ = multihost.host_shard(all_rays)   # this rank's rays
    mesh = make_mesh()                      # every rank of the group

The group's collectives on tensors are ``all_reduce`` (the step) and
``broadcast`` (``mesh.replicate``): PyTorch's gloo backend runs both on
CUDA tensors as well as on CPU ones, so one code path serves NCCL and gloo
on either device. Every function here is an
identity (or a no-op) when no process group is initialised.

Only rank 0 evaluates and writes checkpoints, and an eval of a few 800²
views can take longer than a collective may wait (NCCL's watchdog: 10
minutes by default). So the other ranks wait for rank 0 in ``barrier``,
which runs on a gloo group of its own whose timeout is ``WAIT_TIMEOUT``;
no collective of the step's group is pending meanwhile.
"""
from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tensoir_tpu_torch.device import resolve_device

# how long ``barrier`` waits for the slowest rank: rank 0's work between
# two steps (an eval of N_vis views, a checkpoint write) may take hours
WAIT_TIMEOUT = timedelta(days=7)
_wait_group = None


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               backend: Optional[str] = None,
               device: Optional[torch.device] = None) -> bool:
    """Join the process group; True if this call created it.

    A no-op (False) without a launcher's environment and without
    arguments, or when a group already exists. ``backend`` defaults to
    ``nccl`` on CUDA and ``gloo`` on the CPU (``device``: the rank's
    device; default the launcher's ``cuda:LOCAL_RANK``, and without CUDA
    it raises). A caller may name ``gloo`` for CUDA tensors. A failure
    raises: the backend is never swapped for another.
    """
    if dist.is_initialized():
        return False
    launched = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if (init_method is None and world_size is None and rank is None
            and not launched):
        return False
    # no device: the launcher's card (resolve_device raises without CUDA;
    # a rank is never moved to the CPU behind the caller's back)
    device = resolve_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend=backend,
                            init_method=init_method or "env://",
                            world_size=-1 if world_size is None
                            else world_size,
                            rank=-1 if rank is None else rank)
    return True


def shutdown() -> None:
    """Destroy the process group, if there is one."""
    global _wait_group
    if dist.is_initialized():
        dist.destroy_process_group()
    _wait_group = None


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def host_shard(arr: np.ndarray, axis: int = 0, rank: Optional[int] = None,
               world: Optional[int] = None
               ) -> Tuple[np.ndarray, int, int]:
    """This rank's contiguous slice of a global array: ``ceil(n / world)``
    rows per rank, the last ranks' slices short or empty. Returns (slice,
    start, stop)."""
    rank = process_index() if rank is None else rank
    world = process_count() if world is None else world
    n = arr.shape[axis]
    per = -(-n // world)
    start = min(rank * per, n)
    stop = min(start + per, n)
    return np.take(arr, np.arange(start, stop), axis=axis), start, stop


def host_key(seed: int) -> int:
    """The seed of this rank's ``torch.Generator``: ``seed`` itself without
    a group, else a seed mixed from (seed, rank), so that ranks draw
    different jitter (JAX folds the shard index into its key)."""
    if not dist.is_initialized():
        return int(seed)
    mixed = np.random.SeedSequence([int(seed), process_index()])
    return int(mixed.generate_state(1, np.uint64)[0] >> np.uint64(1))


def agree(flag: bool) -> bool:
    """Rank 0's value of a rank-local predicate, on every rank (e.g. a stop
    file that only rank 0 looks at). Collective under a group: every rank
    must call it at the same point. Sent on ``barrier``'s gloo group, as
    a host value."""
    if not dist.is_initialized():
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32)
    dist.broadcast(t, src=0, group=_waits())
    return bool(t.item())


def _waits():
    """The gloo group of ``barrier`` and ``agree``, made on first use (a
    collective: every rank makes it at the same call)."""
    global _wait_group
    if _wait_group is None:
        _wait_group = dist.new_group(backend="gloo", timeout=WAIT_TIMEOUT)
    return _wait_group


def barrier(name: str = "barrier") -> None:
    """Block until every rank reaches this point (``name`` documents the
    call site), for up to ``WAIT_TIMEOUT``. No-op without a group."""
    del name
    if dist.is_initialized():
        dist.barrier(group=_waits())
