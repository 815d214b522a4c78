"""The TensoIR radiance field, VM decomposition (port of
tensoir_tpu.models.field: config, init, and the queries the radiance step
and the alpha mask need).

Parameters and scene are flat dicts of tensors keyed exactly like the JAX
pytrees (``density_plane_{i}`` [H, W, R], ``density_line_{i}`` [D, R],
``app_*``, ``light_line``, ``basis_mat``, MLP dicts, ``lgt_sgs``), so a
JAX-initialized field carries over with ``weights.params_from_numpy``.
Every VM plane lookup goes through the corner-packed row gather K1.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as Fn

from tensoir_tpu_torch.device import DeviceLike, resolve_device
from tensoir_tpu_torch.models import lighting, mlps
from tensoir_tpu_torch.ops.interp import (bilerp_plane_packed,
                                          lerp_line_matmul, trilerp_volume)

MAT_MODE = ((0, 1), (0, 2), (1, 2))
VEC_MODE = (2, 1, 0)


@dataclass(frozen=True)
class FieldConfig:
    density_n_comp: Tuple[int, int, int] = (16, 16, 16)
    app_n_comp: Tuple[int, int, int] = (48, 48, 48)
    app_dim: int = 27
    decomp: str = "vm"  # 'vm' only in the port so far
    shading_mode: str = "MLP_Fea"
    normals_kind: str = "derived_plus_predicted"
    light_kind: str = "sg"
    per_light_sg: bool = False
    light_num: int = 1
    light_rotations: Tuple[int, ...] = (0,)
    num_sgs: int = 128
    envmap_h: int = 16
    envmap_w: int = 32
    fea2dense: str = "softplus"
    density_shift: float = -10.0
    distance_scale: float = 25.0
    raymarch_weight_thres: float = 1e-4
    alpha_mask_thres: float = 1e-4
    step_ratio: float = 0.5
    pos_pe: int = 2
    view_pe: int = 2
    fea_pe: int = 2
    feature_c: int = 128
    fixed_fresnel: float = 0.04
    near_far: Tuple[float, float] = (2.0, 6.0)
    compute_dtype: str = "float32"


def _require_vm(cfg: FieldConfig) -> None:
    if cfg.decomp != "vm":
        raise NotImplementedError(
            f"decomp={cfg.decomp!r}: the port has only 'vm' so far")


def grid_size_of(params: Dict) -> Tuple[int, int, int]:
    """(X, Y, Z) grid resolution from the line shapes."""
    return (params["density_line_2"].shape[0],
            params["density_line_1"].shape[0],
            params["density_line_0"].shape[0])


def init_field_params(gen: torch.Generator, cfg: FieldConfig, grid_size,
                      aabb, device: DeviceLike = None):
    """(params, scene) dicts on ``device``, drawn from ``gen`` on the CPU.

    Same keys, shapes and distributions as the JAX package's
    ``init_field_params`` (VM factors 0.1 * randn, light_line randn, basis
    U(+-1/sqrt(sum Ra)), MLPs, SG lights); the numbers differ, because the
    generators do. The scene starts with the permissive 2^3 alpha mask.
    """
    _require_vm(cfg)
    dev = resolve_device(device)
    params: Dict = {}
    for name, ncomp in (("density", cfg.density_n_comp),
                        ("app", cfg.app_n_comp)):
        for i in range(3):
            m0, m1 = MAT_MODE[i]
            params[f"{name}_plane_{i}"] = 0.1 * torch.randn(
                (grid_size[m1], grid_size[m0], ncomp[i]), generator=gen)
            params[f"{name}_line_{i}"] = 0.1 * torch.randn(
                (grid_size[VEC_MODE[i]], ncomp[i]), generator=gen)
    sum_ra = sum(cfg.app_n_comp)
    bound = 1.0 / np.sqrt(sum_ra)
    params["basis_mat"] = (torch.rand((sum_ra, cfg.app_dim), generator=gen)
                           * 2.0 - 1.0) * bound
    params["light_line"] = torch.randn((cfg.light_num, sum_ra), generator=gen)
    if cfg.shading_mode != "MLP_Fea":
        raise NotImplementedError(
            f"shading_mode={cfg.shading_mode!r}: the port has only MLP_Fea")
    params["render_mlp"] = mlps.init_mlp(
        gen, mlps.render_fea_in_dim(cfg.app_dim, cfg.view_pe, cfg.fea_pe),
        cfg.feature_c, 3)
    brdf_in = mlps.brdf_pe_fea_in_dim(cfg.app_dim, cfg.pos_pe, cfg.fea_pe)
    params["brdf_mlp"] = mlps.init_mlp(gen, brdf_in, cfg.feature_c, 4)
    if cfg.normals_kind in ("purely_predicted", "derived_plus_predicted"):
        params["normal_mlp"] = mlps.init_mlp(gen, brdf_in, cfg.feature_c, 3)
    elif cfg.normals_kind == "residue_prediction":
        raise NotImplementedError("normals_kind='residue_prediction'")
    if cfg.light_kind == "sg":
        if cfg.per_light_sg:
            params["lgt_sgs"] = torch.stack(
                [lighting.init_sg_params(gen, cfg.num_sgs)
                 for _ in range(cfg.light_num)])
        else:
            params["lgt_sgs"] = lighting.init_sg_params(gen, cfg.num_sgs)
    elif cfg.light_kind == "pixel":
        params["light_pixel"] = torch.rand(
            (cfg.envmap_h * cfg.envmap_w, 3), generator=gen) * 3.0
    params = _tree_to(params, dev)
    aabb_t = torch.as_tensor(np.asarray(aabb, np.float32).reshape(2, 3))
    scene = {
        "aabb": aabb_t.clone(),
        "alpha_volume": torch.ones((2, 2, 2)),
        "alpha_volume_dilated": torch.ones((2, 2, 2), dtype=torch.uint8),
        "alpha_volume_packed": torch.ones((1, 1, 1, 8), dtype=torch.bfloat16),
        "alpha_aabb": aabb_t.clone(),
        "has_alpha_mask": torch.tensor(0.0),
    }
    return params, _tree_to(scene, dev)


def _tree_to(tree: Dict, dev: torch.device) -> Dict:
    return {k: _tree_to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


# ------------------------------------------------------------------ geometry

def normalize_coord(aabb, xyz):
    """World -> [-1, 1]."""
    return (xyz - aabb[0]) * (2.0 / (aabb[1] - aabb[0])) - 1.0


def step_size(aabb, grid_size: Tuple[int, int, int], step_ratio: float):
    """mean(voxel units) * step_ratio, a 0-d tensor."""
    grid = torch.as_tensor(grid_size, dtype=torch.float32, device=aabb.device)
    return ((aabb[1] - aabb[0]) / (grid - 1.0)).mean() * step_ratio


# ------------------------------------------------------------------- queries

def density_factors(cfg: FieldConfig, params: Dict, i: int):
    return params[f"density_plane_{i}"], params[f"density_line_{i}"]


def app_factors(cfg: FieldConfig, params: Dict, i: int):
    return params[f"app_plane_{i}"], params[f"app_line_{i}"]


def density_feature(cfg: FieldConfig, params: Dict, coords):
    """sigma feature = sum_i <plane_i(c), line_i(c)>, coords [..., 3]."""
    _require_vm(cfg)
    total = coords.new_zeros(coords.shape[:-1])
    for i in range(3):
        m0, m1 = MAT_MODE[i]
        plane, line = density_factors(cfg, params, i)
        lf = lerp_line_matmul(line, coords[..., VEC_MODE[i]])
        pf = bilerp_plane_packed(plane, coords[..., m0], coords[..., m1])
        total = total + (pf * lf).sum(-1)
    return total


def _app_raw_feature(cfg: FieldConfig, params: Dict, coords):
    """Concatenated per-axis appearance features [..., sum(Ra)]."""
    _require_vm(cfg)
    feats = []
    for i in range(3):
        m0, m1 = MAT_MODE[i]
        plane, line = app_factors(cfg, params, i)
        lf = lerp_line_matmul(line, coords[..., VEC_MODE[i]])
        pf = bilerp_plane_packed(plane, coords[..., m0], coords[..., m1])
        feats.append(pf * lf)
    return torch.cat(feats, -1)


def light_rows(light_line: torch.Tensor, light_idx) -> torch.Tensor:
    """``light_line[light_idx]`` as a one-hot product, equal to the lookup
    value for value. Its gradient is a dense ``onehot^T @ g``: a handful of
    lights shared by every sample would make a gather's backward pile all
    the samples' adds onto a few rows."""
    onehot = Fn.one_hot(light_idx.long(), light_line.shape[0])
    return torch.matmul(onehot.to(light_line.dtype), light_line)


def _require_f32(cfg: FieldConfig) -> None:
    if cfg.compute_dtype != "float32":
        raise NotImplementedError(
            f"compute_dtype={cfg.compute_dtype!r}: the port computes in f32")


def both_features(cfg: FieldConfig, params: Dict, coords, light_idx):
    """(radiance_feat, intrinsic_feat): basis(pl * light_line[light_idx])
    and basis(pl * mean_l light_line[l])."""
    _require_f32(cfg)
    pl = _app_raw_feature(cfg, params, coords)
    lc = light_rows(params["light_line"], light_idx)
    mean_lc = params["light_line"].mean(0)
    basis = params["basis_mat"]
    return torch.matmul(pl * lc, basis), torch.matmul(pl * mean_lc, basis)


def app_feature(cfg: FieldConfig, params: Dict, coords, light_idx):
    """Radiance feature only."""
    _require_f32(cfg)
    pl = _app_raw_feature(cfg, params, coords)
    return torch.matmul(pl * light_rows(params["light_line"], light_idx),
                        params["basis_mat"])


def intrin_feature(cfg: FieldConfig, params: Dict, coords):
    """Intrinsic (light-averaged) feature only."""
    _require_f32(cfg)
    pl = _app_raw_feature(cfg, params, coords)
    return torch.matmul(pl * params["light_line"].mean(0),
                        params["basis_mat"])


def feature2density(cfg: FieldConfig, feat):
    """softplus(feat + shift) or relu(feat)."""
    if cfg.fea2dense == "softplus":
        return Fn.softplus(feat + cfg.density_shift)
    return torch.relu(feat)


# ---------------------------------------------------------------- alpha mask

def density_feature_packed(packed: torch.Tensor, coords) -> torch.Tensor:
    """Trilinear lookup of a corner-packed grid [Zc, Yc, Xc, 8] (corner
    order 4*dz + 2*dy + dx, any dtype, read as f32) at coords [..., 3]."""
    Zc, Yc, Xc, _ = packed.shape
    x, y, z = coords[..., 0], coords[..., 1], coords[..., 2]
    fx = ((x + 1.0) * 0.5 * Xc).clamp(0.0, Xc)
    fy = ((y + 1.0) * 0.5 * Yc).clamp(0.0, Yc)
    fz = ((z + 1.0) * 0.5 * Zc).clamp(0.0, Zc)
    ix = torch.floor(fx).clamp(0, Xc - 1)
    iy = torch.floor(fy).clamp(0, Yc - 1)
    iz = torch.floor(fz).clamp(0, Zc - 1)
    wx, wy, wz = fx - ix, fy - iy, fz - iz
    idx = (iz.long() * Yc + iy.long()) * Xc + ix.long()
    rows = packed.reshape(Zc * Yc * Xc, 8)[idx].float()
    w0x, w1x = 1.0 - wx, wx
    w0y, w1y = 1.0 - wy, wy
    w0z, w1z = 1.0 - wz, wz
    weights = torch.stack([
        w0z * w0y * w0x, w0z * w0y * w1x, w0z * w1y * w0x, w0z * w1y * w1x,
        w1z * w0y * w0x, w1z * w0y * w1x, w1z * w1y * w0x, w1z * w1y * w1x,
    ], -1)
    return (rows * weights).sum(-1)


def sample_alpha_mask(scene: Dict, xyz):
    """Trilinear alpha-mask value at world points; all ones until the scene
    has a mask (``has_alpha_mask`` 0)."""
    aabb = scene["alpha_aabb"]
    norm = (xyz - aabb[0]) * (2.0 / (aabb[1] - aabb[0])) - 1.0
    if "alpha_volume_packed" in scene:
        vals = density_feature_packed(scene["alpha_volume_packed"], norm)
    else:
        vals = trilerp_volume(scene["alpha_volume"], norm)
    return torch.where(scene["has_alpha_mask"] > 0, vals,
                       torch.ones_like(vals))


def sample_alpha_mask_nearest(scene: Dict, xyz):
    """Nearest-voxel test on the extra-dilated mask; bool [...]."""
    aabb = scene["alpha_aabb"]
    vol = scene["alpha_volume_dilated"]
    D, H, W = vol.shape
    norm = (xyz - aabb[0]) / (aabb[1] - aabb[0])
    fx = torch.round(norm[..., 0] * (W - 1)).clamp(0, W - 1)
    fy = torch.round(norm[..., 1] * (H - 1)).clamp(0, H - 1)
    fz = torch.round(norm[..., 2] * (D - 1)).clamp(0, D - 1)
    idx = (fz.long() * H + fy.long()) * W + fx.long()
    vals = vol.reshape(-1)[idx]
    return torch.where(scene["has_alpha_mask"] > 0, vals > 0,
                       torch.ones_like(vals, dtype=torch.bool))
