"""Checkpoint save/load in the JAX package's npz layout (port of
tensoir_tpu.utils.ckpt), so that either package reads the other's files.

One ``.npz`` holds:

* ``params/<key>[/<sub>]`` and ``scene/<key>``: the field's tensors as
  numpy arrays (``alpha_volume_packed`` is derived and rebuilt on load);
* ``alpha/packed`` and ``alpha/shape``: ``np.packbits`` of
  ``alpha_volume > 0.5`` and its shape;
* ``opt/NNNNN``: the per-group Adam state in optax's leaf order, which is
  ``multi_transform``'s groups by name (light, network, spatial) and, in
  each, the Adam count, ``mu`` and ``nu`` over the group's parameters in
  sorted-key order, then the schedule count;
* ``train/torch_rng_state`` and ``train/sampler_state``: the step
  generator's state and the ray sampler's (JSON), so that a resumed run
  goes on with the same draws. JAX's loader skips both keys; JAX's own
  ``train/rng_key`` cannot seed a ``torch.Generator`` and is ignored here;
* ``train/rank_<r>/torch_rng_state`` and ``train/rank_<r>/sampler_state``:
  in a checkpoint of a data-parallel run, each rank's two states (rank 0
  writes them all), which a resume of that run hands back to each rank; a
  one-device load ignores them;
* ``__tensoir_header__``: JSON of the ``FieldConfig`` and ``extra``.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from tensoir_tpu_torch.device import DeviceLike, resolve_device
from tensoir_tpu_torch.models.field import FieldConfig, pack_corner_volume
from tensoir_tpu_torch.train.optim import GROUPS, param_group
from tensoir_tpu_torch.weights import params_from_numpy

_HEADER_KEY = "__tensoir_header__"
RNG_KEY = "train/torch_rng_state"
SAMPLER_KEY = "train/sampler_state"
_JAX_RNG_KEY = "train/rng_key"
_RANK_PREFIX = "train/rank_"


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.numpy()
    return np.asarray(v)


def _json_bytes(obj) -> np.ndarray:
    return np.frombuffer(json.dumps(obj).encode(), dtype=np.uint8)


def _flatten(tree: Dict, prefix: str, out: Dict[str, np.ndarray]):
    for k, v in tree.items():
        key = f"{prefix}/{k}"
        if isinstance(v, dict):
            _flatten(v, key, out)
        else:
            out[key] = _np(v)


def _sorted_paths(tree: Dict, prefix: str = "") -> Iterator[str]:
    """The "a/b" paths of a nested dict's leaves in JAX's flatten order:
    keys sorted at every level."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _sorted_paths(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}"


def _optax_layout(params: Dict) -> List[Tuple[str, str, Optional[str]]]:
    """(group, field, parameter path) of each optax leaf, in order; the
    path is None for the two counts."""
    paths = list(_sorted_paths(params))
    layout = []
    for grp in sorted(GROUPS):
        mine = [p for p in paths if param_group(p.split("/", 1)[0]) == grp]
        layout.append((grp, "count", None))
        layout += [(grp, "mu", p) for p in mine]
        layout += [(grp, "nu", p) for p in mine]
        layout.append((grp, "schedule_count", None))
    return layout


def opt_state_leaves(opt_state: Dict, params: Dict) -> List[np.ndarray]:
    """``GroupAdam`` state as optax's leaves, in optax's order."""
    leaves = []
    for grp, field, path in _optax_layout(params):
        if path is None:
            leaves.append(np.asarray(opt_state["count"][grp], np.int32))
        else:
            leaves.append(_np(opt_state[field][path]))
    return leaves


def restore_opt_state(template_opt_state: Dict, leaves, params: Dict) -> Dict:
    """A ``GroupAdam`` state rebuilt from saved optax leaves.
    ``template_opt_state`` is a fresh ``init(params)``; it is returned
    unchanged when the leaf count differs (another optimizer layout)."""
    layout = _optax_layout(params)
    if len(layout) != len(leaves):
        return template_opt_state
    state = {"count": dict(template_opt_state["count"]),
             "mu": dict(template_opt_state["mu"]),
             "nu": dict(template_opt_state["nu"])}
    for (grp, field, path), leaf in zip(layout, leaves):
        if field == "count":
            state["count"][grp] = int(np.asarray(leaf))
        elif path is not None:
            like = template_opt_state[field][path]
            state[field][path] = torch.as_tensor(
                np.asarray(leaf), dtype=like.dtype).to(like.device)
    return state


def save_checkpoint(path: str, cfg: FieldConfig, params: Dict, scene: Dict,
                    extra: Optional[Dict[str, Any]] = None,
                    opt_state: Optional[Dict] = None,
                    rng_state: Optional[torch.Tensor] = None,
                    sampler_state: Optional[Dict] = None,
                    rank_states: Optional[List[Tuple]] = None):
    """Write the field (tensors or arrays), and optionally the ``GroupAdam``
    state, the step generator's state (``Generator.get_state()``) and the
    ray sampler's (``SimpleSampler.state()``); ``rank_states`` holds each
    rank's (generator state, sampler state) of a data-parallel run."""
    arrays: Dict[str, np.ndarray] = {}
    _flatten(params, "params", arrays)
    if opt_state is not None:
        for i, leaf in enumerate(opt_state_leaves(opt_state, params)):
            arrays[f"opt/{i:05d}"] = leaf
    if rng_state is not None:
        arrays[RNG_KEY] = _np(rng_state)
    if sampler_state is not None:
        arrays[SAMPLER_KEY] = _json_bytes(sampler_state)
    for r, (rng, sampler) in enumerate(rank_states or ()):
        arrays[f"{_RANK_PREFIX}{r}/torch_rng_state"] = _np(rng)
        arrays[f"{_RANK_PREFIX}{r}/sampler_state"] = _json_bytes(sampler)

    scene_np = {k: _np(v) for k, v in scene.items()
                if k != "alpha_volume_packed"}  # derived; rebuilt on load
    alpha_bool = scene_np.pop("alpha_volume") > 0.5
    arrays["alpha/packed"] = np.packbits(alpha_bool.reshape(-1))
    arrays["alpha/shape"] = np.asarray(alpha_bool.shape, np.int64)
    for k, v in scene_np.items():
        arrays[f"scene/{k}"] = v

    header = {"config": dataclasses.asdict(cfg), "extra": extra or {},
              "version": 1}
    arrays[_HEADER_KEY] = _json_bytes(header)
    np.savez_compressed(path, **arrays)


def load_checkpoint(path: str, device: DeviceLike = None
                    ) -> Tuple[FieldConfig, Dict, Dict, Dict]:
    """(cfg, params, scene, extra), tensors on ``device``. ``extra`` holds
    the header's extra, plus ``opt_leaves`` (optax order),
    ``torch_rng_state`` and ``sampler_state`` when the file has them, and
    ``rank_states`` ({rank: {"torch_rng_state", "sampler_state"}}) when it
    comes from a data-parallel run."""
    dev = resolve_device(device)
    with np.load(path if path.endswith(".npz") else path + ".npz",
                 allow_pickle=False) as data:
        files = {k: data[k] for k in data.files}
    header = json.loads(bytes(files.pop(_HEADER_KEY)).decode())
    cfg_d = header["config"]
    for key in ("density_n_comp", "app_n_comp", "light_rotations", "near_far"):
        if isinstance(cfg_d.get(key), list):
            cfg_d[key] = tuple(cfg_d[key])
    cfg = FieldConfig(**cfg_d)

    params: Dict = {}
    scene_np: Dict = {}
    opt_leaves: Dict[int, np.ndarray] = {}
    for key, arr in files.items():
        parts = key.split("/")
        if parts[0] == "params":
            node = params
            for p in parts[1:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = arr
        elif parts[0] == "scene":
            scene_np[parts[1]] = arr
        elif parts[0] == "opt":
            opt_leaves[int(parts[1])] = arr

    shape = tuple(int(s) for s in files["alpha/shape"])
    n = int(np.prod(shape))
    alpha = np.unpackbits(files["alpha/packed"])[:n].reshape(shape)
    scene_np["alpha_volume"] = alpha.astype(np.float32)
    params, scene = params_from_numpy(params, scene_np, device=dev)
    scene["alpha_volume_packed"] = pack_corner_volume(scene["alpha_volume"])

    extra = dict(header["extra"])
    if opt_leaves:
        extra["opt_leaves"] = [opt_leaves[i] for i in sorted(opt_leaves)]
    if RNG_KEY in files:
        extra["torch_rng_state"] = torch.from_numpy(files[RNG_KEY])
    if SAMPLER_KEY in files:
        extra["sampler_state"] = json.loads(bytes(files[SAMPLER_KEY]).decode())
    elif _JAX_RNG_KEY in files:
        print(f"[ckpt] {path}: ignoring the JAX package's {_JAX_RNG_KEY} "
              "(it cannot seed a torch.Generator); a resumed run draws "
              "from its seeded generator", flush=True)
    for key, arr in files.items():
        if key.startswith(_RANK_PREFIX):
            rank, name = key[len(_RANK_PREFIX):].split("/")
            entry = extra.setdefault("rank_states", {}).setdefault(
                int(rank), {})
            entry[name] = (torch.from_numpy(arr) if name == "torch_rng_state"
                           else json.loads(bytes(arr).decode()))
    return cfg, params, scene, extra
