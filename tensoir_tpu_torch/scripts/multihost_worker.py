"""One process of a data-parallel training-step run (the counterpart of the
JAX package's ``scripts/multihost_worker.py`` and of its multi-chip dry
run): join the group, load a field, take this rank's share of a global
batch, run the step under the group, report.

    python -m tensoir_tpu_torch.scripts.multihost_worker \\
        --init-method file:///tmp/rdzv --world 2 --rank R \\
        --params-npz spec.npz --out rank_R.npz [--relight] [--lifecycle]
    python -m torch.distributed.run --nproc_per_node N \\
        -m tensoir_tpu_torch.scripts.multihost_worker \\
        --params-npz spec.npz --out 'rank_{rank}.npz'

Launch it once per rank (each with its ``--rank``), or under the launcher,
which gives each process its rank, the world and the rendezvous (and its
card, ``cuda:LOCAL_RANK``); every rank must get the same spec. ``{rank}``
in ``--out`` becomes the rank. The spec (``write_spec``)
holds the field's config and arrays, the step's static knobs and loss
weights for the radiance and the relight phase, the optimizer's rates and
the global batch. Each rank steps on its contiguous rows of the batch
(``shard_batch``) and writes to ``--out``: each step's loss, the
gradients of the first step (rank 0; Adam's first moment over 1 - b1),
a digest of every final parameter (bit-equal replicas have equal
digests), with ``--save-params`` the parameters themselves, and a JSON
``meta`` entry (rank, world, backend, device, step seconds, kernel
launches, peak memory, ``all_reduce`` times). ``--relight-ray-cap`` runs
one case per value, each from the spec's field. ``--lifecycle`` then runs
an alpha-mask update, shrink and upsample under the group, and one more
step on the new grid.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from tensoir_tpu_torch.device import resolve_device
from tensoir_tpu_torch.kernels import LAUNCHES, reset_launch_counts
from tensoir_tpu_torch.models import lifecycle as LC
from tensoir_tpu_torch.models.field import FieldConfig, grid_size_of
from tensoir_tpu_torch.parallel import multihost
from tensoir_tpu_torch.parallel.mesh import (Mesh, make_mesh, replicate,
                                             shard_batch)
from tensoir_tpu_torch.train.optim import B1, flatten, make_optimizer
from tensoir_tpu_torch.train.step import (LossWeights, StepStatic,
                                          make_train_step)
from tensoir_tpu_torch.weights import params_from_numpy

_SPEC = "__spec__"
_BF16 = "@bf16"


def _host(v) -> np.ndarray:
    """A tensor or array as numpy; bf16 as its 16-bit pattern."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            return v.view(torch.int16).numpy().view(np.uint16)
        return v.numpy()
    v = np.asarray(v)
    return v.view(np.uint16) if v.dtype.name == "bfloat16" else v


def _is_bf16(v) -> bool:
    return (v.dtype == torch.bfloat16 if isinstance(v, torch.Tensor)
            else np.asarray(v).dtype.name == "bfloat16")


def write_spec(path: str, fcfg: Dict, params: Dict, scene: Dict,
               batch: Dict, phases: Dict, lr: Dict, lifecycle: Dict = None,
               seed: int = 1) -> None:
    """Write a run's spec: ``fcfg`` the FieldConfig's fields; ``params``
    and ``scene`` (tensors or arrays, JAX's or the port's); ``batch`` the
    global batch (rays, rgbs, light_idx); ``phases`` {"radiance"/"relight":
    {"static": StepStatic fields, "weights": LossWeights fields, "step":
    iteration}}; ``lr`` make_optimizer's rates (lr_init, lr_basis,
    lr_decay_factor, lr_light); ``lifecycle`` {"mask_reso", "voxels"}."""
    arrays = {}
    for prefix, tree in (("params", flatten(params)), ("scene", scene),
                         ("batch", batch)):
        for k, v in tree.items():
            arrays[f"{prefix}/{k}{_BF16 if _is_bf16(v) else ''}"] = _host(v)
    meta = {"field": fcfg, "phases": phases, "lr": lr,
            "lifecycle": lifecycle or {}, "seed": seed}
    arrays[_SPEC] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez(path, **arrays)


def load_spec(path: str, device) -> Dict:
    """The spec as {"fcfg", "params", "scene", "batch", "phases", "lr",
    "lifecycle", "seed"}, tensors on ``device`` (the batch on the CPU)."""
    with np.load(path) as z:
        files = {k: z[k] for k in z.files}
    meta = json.loads(bytes(files.pop(_SPEC)).decode())
    trees = {"params": {}, "scene": {}, "batch": {}}
    bf16 = {}
    for key, arr in files.items():
        prefix, name = key.split("/", 1)
        if name.endswith(_BF16):
            bf16[(prefix, name[:-len(_BF16)])] = arr
            continue
        node = trees[prefix]
        *heads, last = name.split("/") if prefix == "params" else [name]
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = arr
    params, scene = params_from_numpy(trees["params"], trees["scene"],
                                      device=device)
    for (prefix, name), arr in bf16.items():
        scene[name] = torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    field = dict(meta["field"])
    for k in ("density_n_comp", "app_n_comp", "light_rotations", "near_far"):
        if isinstance(field.get(k), list):
            field[k] = tuple(field[k])
    return {"fcfg": FieldConfig(**field), "params": params, "scene": scene,
            "batch": {k: torch.from_numpy(v) for k, v in
                      trees["batch"].items()},
            "phases": meta["phases"], "lr": meta["lr"],
            "lifecycle": meta["lifecycle"], "seed": meta["seed"]}


def build_step(spec: Dict, phase: str, device, mesh: Optional[Mesh],
               **static):
    """(optimizer, step_fn, iteration) of ``phase``; ``static`` overrides
    StepStatic fields."""
    ph = spec["phases"][phase]
    st = StepStatic(**{**ph["static"], **static})
    w = LossWeights(**ph["weights"])
    opt = make_optimizer(None, **spec["lr"])
    return opt, make_train_step(spec["fcfg"], opt, st, w, device=device,
                                mesh=mesh), int(ph["step"])


def _clone(tree: Dict) -> Dict:
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(_host(t).tobytes()).hexdigest()[:16]


def run_case(spec: Dict, phase: str, steps: int, device, mesh: Optional[Mesh],
             lifecycle: bool = False, **static) -> Dict:
    """``steps`` steps of ``phase`` from a copy of the spec's field, on this
    rank's rows of the global batch (all of it without a group). Returns
    losses, metrics of the last step, first-step gradients, the final
    params, kernel launches and step seconds."""
    params, scene = _clone(spec["params"]), _clone(spec["scene"])
    batch = spec["batch"]
    if mesh is not None:
        batch = shard_batch(mesh, batch)
        replicate(mesh, params)
        replicate(mesh, scene)
    batch = {k: v.to(device) for k, v in batch.items()}
    opt, step_fn, it0 = build_step(spec, phase, device, mesh, **static)
    state = opt.init(params)
    key = torch.Generator(device=device).manual_seed(
        multihost.host_key(spec["seed"]))
    reset_launch_counts()
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: 0)
    losses, n_acc, grads, step_s = [], [], None, []
    for i in range(steps):
        sync()
        t0 = time.perf_counter()
        params, state, m = step_fn(params, state, scene, batch, key, it0 + i)
        sync()
        step_s.append(time.perf_counter() - t0)
        if i == 0:
            grads = {k: v / (1 - B1) for k, v in state["mu"].items()}
        losses.append(float(m["total_loss"]))
        if "n_acc_masked" in m:
            n_acc.append(float(m["n_acc_masked"]))
    out = {"losses": losses, "n_acc_masked": n_acc, "grads": grads,
           "params": flatten(params), "launches": dict(LAUNCHES),
           "step_s": step_s, "steps": steps}
    if lifecycle:
        # on a copy: the event keeps some tensors, which its step updates
        out["lifecycle"] = _lifecycle(spec, _clone(params), _clone(scene),
                                      batch, device, mesh, it0 + steps,
                                      **static)
    return out


def _lifecycle(spec, params, scene, batch, device, mesh, it, **static):
    """An alpha-mask update, shrink and upsample of the stepped field under
    the group, a fresh Adam, and one more relight step on the new grid."""
    fcfg, lc = spec["fcfg"], spec["lifecycle"]
    scene, new_aabb = LC.update_alpha_mask(fcfg, params, scene,
                                           tuple(lc["mask_reso"]))
    params, scene = LC.shrink(fcfg, params, scene, new_aabb)
    reso = LC.n_to_reso(int(lc["voxels"]), scene["aabb"].cpu().numpy())
    params = LC.upsample(params, reso)
    if mesh is not None:
        replicate(mesh, params)
        replicate(mesh, scene)
    opt, step_fn, _ = build_step(spec, "relight", device, mesh, **static)
    state = opt.init(params)
    key = torch.Generator(device=device).manual_seed(
        multihost.host_key(spec["seed"] + 1))
    params, state, m = step_fn(params, state, scene, batch, key, it)
    return {"grid": list(grid_size_of(params)),
            "loss": float(m["total_loss"]),
            "digests": {k: digest(v) for k, v in flatten(params).items()}}


def time_all_reduce(mesh: Mesh, numel: int, device, reps: int) -> Dict:
    """Seconds of one ``all_reduce`` of a float32 bucket of ``numel``
    elements on ``device`` (CUDA events on a card), mean of ``reps``."""
    import torch.distributed as dist
    buf = torch.ones(numel, device=device)
    for _ in range(2):
        dist.all_reduce(buf, group=mesh.group)
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        for _ in range(reps):
            dist.all_reduce(buf, group=mesh.group)
        end.record()
        torch.cuda.synchronize(device)
        ms = start.elapsed_time(end) / reps
    else:
        t0 = time.perf_counter()
        for _ in range(reps):
            dist.all_reduce(buf, group=mesh.group)
        ms = (time.perf_counter() - t0) / reps * 1e3
    return {"bytes": numel * 4, "ms": ms, "reps": reps}


def parse_args(argv: List[str]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--init-method", default=None,
                    help="rendezvous of the group, e.g. file:///tmp/rdzv "
                         "(default: the launcher's)")
    ap.add_argument("--world", type=int, default=None)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="default: the card (cuda:LOCAL_RANK under a "
                         "launcher)")
    ap.add_argument("--backend", default=None,
                    help="default: nccl on CUDA, gloo on the CPU")
    ap.add_argument("--params-npz", required=True,
                    help="the run's spec (write_spec)")
    ap.add_argument("--out", required=True,
                    help="results (.npz); {rank} becomes the rank")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--relight", action="store_true",
                    help="the relight phase's step (default: radiance)")
    ap.add_argument("--lifecycle", action="store_true",
                    help="then mask, shrink, upsample and one more step")
    ap.add_argument("--relight-ray-cap", type=int, nargs="*", default=[],
                    help="one case per value (default: the spec's cap)")
    ap.add_argument("--save-params", action="store_true")
    ap.add_argument("--time-all-reduce", type=int, default=0, metavar="REPS",
                    help="time an all_reduce of the gradients' size")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    dev = resolve_device(args.device)
    multihost.initialize(init_method=args.init_method,
                         world_size=args.world, rank=args.rank,
                         backend=args.backend, device=dev)
    try:
        return _run(args, dev)
    finally:
        multihost.shutdown()


def _run(args, dev) -> Dict:
    import torch.distributed as dist
    mesh = make_mesh(args.world)
    spec = load_spec(args.params_npz, dev)
    phase = "relight" if args.relight else "radiance"
    caps = args.relight_ray_cap or [None]
    arrays, cases = {}, []
    for i, cap in enumerate(caps):
        static = {} if cap is None else {"relight_ray_cap": cap}
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        res = run_case(spec, phase, args.steps, dev, mesh,
                       lifecycle=args.lifecycle, **static)
        multihost.barrier("case done")
        case = {"relight_ray_cap": cap, "losses": res["losses"],
                "n_acc_masked": res["n_acc_masked"],
                "launches": res["launches"], "step_s": res["step_s"],
                "seconds": time.perf_counter() - t0,
                "digests": {k: digest(v) for k, v in res["params"].items()},
                "lifecycle": res.get("lifecycle")}
        if dev.type == "cuda":
            case["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 2**30
        cases.append(case)
        if mesh.rank == 0:
            for k, g in res["grads"].items():
                arrays[f"case{i}/grad/{k}"] = _host(g)
        if args.save_params:
            for k, p in res["params"].items():
                arrays[f"case{i}/params/{k}"] = _host(p)
        numel = sum(g.numel() for g in res["grads"].values())
    meta = {"rank": mesh.rank, "world": mesh.world,
            "backend": dist.get_backend(), "device": str(dev),
            "phase": phase, "cases": cases}
    if args.time_all_reduce:
        meta["all_reduce"] = time_all_reduce(mesh, numel, dev,
                                             args.time_all_reduce)
    arrays["meta"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez(args.out.format(rank=mesh.rank), **arrays)
    print(json.dumps({"rank": mesh.rank, "world": mesh.world,
                      "losses": [c["losses"] for c in cases]}), flush=True)
    return meta


def read_out(path: str) -> Dict:
    """A worker's ``--out`` file: {"meta", "grads": [per case {name:
    array}], "params": [...]} (params empty without --save-params)."""
    with np.load(path) as z:
        files = {k: z[k] for k in z.files}
    meta = json.loads(bytes(files.pop("meta")).decode())
    n = len(meta["cases"])
    grads = [{} for _ in range(n)]
    params = [{} for _ in range(n)]
    for key, arr in files.items():
        case, kind, name = key.split("/", 2)
        (grads if kind == "grad" else params)[int(case[4:])][name] = arr
    return {"meta": meta, "grads": grads, "params": params}


if __name__ == "__main__":
    main()
