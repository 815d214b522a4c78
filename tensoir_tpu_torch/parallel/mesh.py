"""The data-parallel group and its sharding helpers (port of
tensoir_tpu.parallel.mesh).

The JAX package shards the ray batch over a 1-D ``data`` mesh of devices
and replicates everything else. The port runs one process per GPU under
``torch.distributed`` (see ``multihost``): a ``Mesh`` describes the group
of those processes, each rank trains on its rows of the global batch, the
step averages the gradients over the group with one ``all_reduce``, and
the same Adam update then runs on every rank. There is no mode that drives
several devices from one process.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

LAUNCH_HINT = ("launch one process per GPU with python -m "
               "torch.distributed.run --nproc_per_node N ...")


@dataclass(frozen=True)
class Mesh:
    """The data-parallel group as this rank sees it. ``group`` is the
    process group (None in a single process, where every collective is an
    identity)."""
    group: Optional[object]
    rank: int
    world: int


def make_mesh(n_data: Optional[int] = None) -> Mesh:
    """The group of every launched rank. ``n_data``, when given, must be
    the launched world size; without a group only 1 is possible, and more
    raises a ``ValueError`` that names the launcher."""
    if not dist.is_initialized():
        if n_data is not None and n_data > 1:
            raise ValueError(
                f"mesh_data={n_data} needs {n_data} processes, and this is "
                f"one process with no process group: {LAUNCH_HINT}")
        return Mesh(group=None, rank=0, world=1)
    world = dist.get_world_size()
    if n_data is not None and n_data != world:
        raise ValueError(
            f"mesh_data={n_data} differs from the {world} launched ranks")
    return Mesh(group=dist.group.WORLD, rank=dist.get_rank(), world=world)


def _rows(mesh: Mesh, n: int) -> slice:
    if n % mesh.world:
        raise ValueError(f"global batch {n} does not divide over "
                         f"{mesh.world} ranks")
    per = n // mesh.world
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_batch(mesh: Mesh, batch: Dict) -> Dict:
    """This rank's contiguous rows of a global batch (tensors or arrays),
    JAX's ``P("data")`` layout: rank r gets rows [r B / w, (r + 1) B / w)."""
    return {k: v[_rows(mesh, len(v))] for k, v in batch.items()}


def replicate(mesh: Mesh, tree):
    """Rank 0's values of every tensor of ``tree`` (params, scene, Adam
    state; nested dicts), broadcast in place to every rank; other leaves
    (Adam's counts) are left as they are. Returns ``tree``."""
    if mesh.group is None:
        return tree
    for k, v in tree.items():
        if isinstance(v, dict):
            replicate(mesh, v)
        elif isinstance(v, torch.Tensor):
            if not v.is_contiguous():
                raise ValueError(f"replicate: {k} is not contiguous")
            # as bytes, so that every dtype (bf16, uint8) goes through
            dist.broadcast(v.reshape(-1).view(torch.uint8), src=0,
                           group=mesh.group)
    return tree


def all_reduce_mean(mesh: Mesh, means: List[torch.Tensor],
                    sums: List[torch.Tensor] = ()) -> tuple:
    """The group's mean of each tensor of ``means`` (``pmean``) and sum of
    each of ``sums`` (``psum``), from ONE ``all_reduce`` of a flat float32
    bucket of all of them. Returns (means, sums): tensors of the inputs'
    shapes and dtypes, the float32 ones views into the bucket."""
    tensors = [*means, *sums]
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=mesh.group)
    n_mean = sum(t.numel() for t in means)
    flat[:n_mean].div_(mesh.world)
    out = [piece.view(t.shape).to(t.dtype) for piece, t in
           zip(flat.split([t.numel() for t in tensors]), tensors)]
    return out[:len(means)], out[len(means):]


def pad_to_multiple(arr: np.ndarray, multiple: int, axis: int = 0):
    """Zero-pad ``axis`` of ``arr`` up to a multiple of ``multiple``;
    returns (padded, the unpadded length)."""
    n = arr.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return arr, n
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, rem)
    return np.pad(arr, pad), n
