"""The TensoIR radiance field, VM decomposition (port of
tensoir_tpu.models.field: config, init, the queries of the training step,
derived normals, the alpha mask, the baked sigma grid (optionally on
factors resized to a coarser grid) with its coarse occupancy, and the baked
per-light appearance grid).

Parameters and scene are flat dicts of tensors keyed exactly like the JAX
pytrees (``density_plane_{i}`` [H, W, R], ``density_line_{i}`` [D, R],
``app_*``, ``light_line``, ``basis_mat``, MLP dicts, ``lgt_sgs``), so a
JAX-initialized field carries over with ``weights.params_from_numpy``.
Every VM plane lookup goes through the corner-packed row gather K1 on f32
rows; the corner-packed trilinear lookups (alpha mask, baked sigma grid,
baked appearance grid) go through K1 on bf16 rows.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as Fn

from tensoir_tpu_torch.device import DeviceLike, resolve_device
from tensoir_tpu_torch.kernels import row_gather
from tensoir_tpu_torch.models import lighting, mlps
from tensoir_tpu_torch.ops.interp import (bilerp_plane_packed,
                                          lerp_line_matmul,
                                          resize_bilinear_align_corners,
                                          resize_line_align_corners,
                                          trilerp_volume)
from tensoir_tpu_torch.ops.rays import linspace, safe_l2_normalize

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
                      aabb, device: DeviceLike = None, gt_envmap=None):
    """(params, scene) dicts on ``device``, drawn from ``gen`` on the CPU.

    Same keys, shapes and distributions as the JAX package's
    ``init_field_params`` (VM factors 0.1 * randn, light_line randn, basis
    U(+-1/sqrt(sum Ra)), MLPs, SG lights); the numbers differ, because the
    generators do. The scene starts with the permissive 2^3 alpha mask,
    and holds ``gt_envmap`` [H, W, 3], the dataset's probe, when given (the
    light of ``light_kind='gt'``).
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
    if gt_envmap is not None:
        scene["gt_envmap"] = torch.as_tensor(np.asarray(gt_envmap,
                                                        np.float32))
    return params, _tree_to(scene, dev)


def _tree_to(tree: Dict, dev: torch.device) -> Dict:
    return {k: _tree_to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


# ------------------------------------------------------------------ geometry

def normalize_coord(aabb, xyz):
    """World -> [-1, 1]."""
    return (xyz - aabb[0]) * (2.0 / (aabb[1] - aabb[0])) - 1.0


def step_size(aabb, grid_size: Tuple[int, int, int], step_ratio: float):
    """mean(voxel units) * step_ratio, a 0-d tensor.

    The mean is the sum times 1/3, as XLA computes ``jnp.mean``, on every
    device (``Tensor.mean`` divides on the CPU and multiplies on CUDA). The
    samples sit on the voxel grid's half steps, so an ulp of the step moves
    some of them across the nearest-voxel test's rounding ties."""
    grid = torch.as_tensor(grid_size, dtype=torch.float32, device=aabb.device)
    units = (aabb[1] - aabb[0]) / (grid - 1.0)
    return (units[0] + units[1] + units[2]) * (1.0 / 3.0) * step_ratio


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


def density(cfg: FieldConfig, params: Dict, coords):
    return feature2density(cfg, density_feature(cfg, params, coords))


def derived_normals(cfg: FieldConfig, params: Dict, coords):
    """n = -normalize(d sigma / d coords) at coords [P, 3].

    The gradient is taken with ``create_graph`` whenever grad mode is on,
    so the normals stay differentiable in the parameters: the loss's
    gradient then runs a double backward through the line products and
    through K1/K2, each of which is the other's backward."""
    create_graph = torch.is_grad_enabled()
    with torch.enable_grad():
        c = coords.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(density(cfg, params, c).sum(), c,
                                   create_graph=create_graph)
    return -safe_l2_normalize(g)


# ------------------------------------------------------------- baked density

def bake_sigma_feature_grid(cfg: FieldConfig, params: Dict) -> torch.Tensor:
    """The VM sigma feature on its own grid nodes, [Z, Y, X]: per axis an
    outer product of a plane and a line, summed over components."""
    _require_vm(cfg)
    p0, l0 = density_factors(cfg, params, 0)  # [Y, X, R], [Z, R]
    p1, l1 = density_factors(cfg, params, 1)  # [Z, X, R], [Y, R]
    p2, l2 = density_factors(cfg, params, 2)  # [Z, Y, R], [X, R]
    out = torch.einsum("yxr,zr->zyx", p0, l0)
    out = out + torch.einsum("zxr,yr->zyx", p1, l1)
    return out + torch.einsum("zyr,xr->zyx", p2, l2)


def _mask_at_grid_nodes(scene: Dict, grid_xyz: Tuple[int, int, int]):
    """The alpha mask resampled onto the factor grid's nodes, [Z, Y, X], by
    three 1-D linear-interpolation matrices (the mask lives on
    ``alpha_aabb``, the grid on ``aabb``); all ones before a mask exists."""
    X, Y, Z = grid_xyz
    vol = scene["alpha_volume"].float()                         # [D, H, W]
    D, H, W = vol.shape
    aabb, a_aabb = scene["aabb"], scene["alpha_aabb"]
    dev = vol.device

    def axis_matrix(n_out, n_in, axis):
        world = aabb[0, axis] + (aabb[1, axis] - aabb[0, axis]) * linspace(
            0.0, 1.0, n_out, device=dev)
        t = (world - a_aabb[0, axis]) / (a_aabb[1, axis] - a_aabb[0, axis])
        pos = t.clamp(0.0, 1.0)[:, None] * (n_in - 1)
        j = torch.arange(n_in, dtype=torch.float32, device=dev)[None, :]
        return (1.0 - (pos - j).abs()).clamp_min(0.0)           # [n_out, n_in]

    out = torch.einsum("zd,dhw->zhw", axis_matrix(Z, D, 2), vol)
    out = torch.einsum("yh,zhw->zyw", axis_matrix(Y, H, 1), out)
    out = torch.einsum("xw,zyw->zyx", axis_matrix(X, W, 0), out)
    return torch.where(scene["has_alpha_mask"] > 0, out,
                       torch.ones_like(out))


def _resized_factors(plane: torch.Tensor, line: torch.Tensor, max_reso: int):
    """A plane [H, W, R] and a line [D, R] resized to at most ``max_reso``
    nodes per axis (``align_corners``: the resized factors are the field's
    exact VM factors at the coarser nodes)."""
    H, W, _ = plane.shape
    nh, nw = min(H, max_reso), min(W, max_reso)
    if (nh, nw) != (H, W):
        plane = resize_bilinear_align_corners(plane, (nh, nw))
    if line.shape[0] > max_reso:
        line = resize_line_align_corners(line, max_reso)
    return plane, line


def _bake_masked_dense(cfg: FieldConfig, params: Dict, scene: Dict,
                       max_reso: int = 0) -> torch.Tensor:
    """Dense sigma-feature grid [Z, Y, X] with the alpha mask folded in
    (masked nodes -> -1e4, whose softplus is 0), on the factors resized to
    at most ``max_reso`` nodes per axis when it is > 0."""
    if max_reso > 0:
        params = dict(params)
        for i in range(3):
            params[f"density_plane_{i}"], params[f"density_line_{i}"] = \
                _resized_factors(*density_factors(cfg, params, i), max_reso)
    baked = bake_sigma_feature_grid(cfg, params)
    Z, Y, X = baked.shape
    mask = _mask_at_grid_nodes(scene, (X, Y, Z))
    return torch.where(mask > 0, baked, torch.full_like(baked, -1e4))


@torch.no_grad()
def bake_packed_sigma_grid(cfg: FieldConfig, params: Dict, scene: Dict,
                           dtype=torch.bfloat16,
                           max_reso: int = 0) -> torch.Tensor:
    """Corner-packed baked sigma-feature grid [Z-1, Y-1, X-1, 8] (bf16 by
    default): one row per cell, so a secondary-ray sample is one K1 row.
    Not differentiable: the secondary pass that reads it runs without
    gradients."""
    return pack_corner_volume(_bake_masked_dense(cfg, params, scene, max_reso),
                              dtype)


@torch.no_grad()
def bake_coarse_occupancy(packed: torch.Tensor, reso: int = 48,
                          feat_thres: float = 0.0,
                          dilate: int = 2) -> torch.Tensor:
    """Conservative coarse occupancy, bool [reso, reso, reso], of a
    corner-packed baked grid: a coarse cell is marked when any fine cell in
    its block (the fine grid zero-padded to ``reso`` blocks per axis) has a
    corner feature above ``feat_thres``, then dilated by ``dilate`` coarse
    cells. Half the window march's prepass spacing must stay within the
    dilation margin (``check_march_contract``)."""
    occ = packed.float().amax(-1) > feat_thres
    Zc, Yc, Xc = occ.shape
    bz, by, bx = -(-Zc // reso), -(-Yc // reso), -(-Xc // reso)
    occ = Fn.pad(occ, (0, bx * reso - Xc, 0, by * reso - Yc,
                       0, bz * reso - Zc))
    coarse = occ.reshape(reso, bz, reso, by, reso, bx).any(5).any(3).any(1)
    if dilate > 0:
        # max over the (2 dilate + 1)^3 neighbourhood; the pooling pads with
        # -inf, as the reference's "SAME" max window does
        coarse = Fn.max_pool3d(coarse.float()[None, None], 2 * dilate + 1,
                               stride=1, padding=dilate)[0, 0] > 0.0
    return coarse


def check_march_contract(aabb_np, *, prepass_n: int, dilate: int = 2,
                         coarse_reso: int = 48, vis_near: float = 0.05,
                         vis_far: float = 1.5) -> float:
    """The window march's conservativeness contract, on the host: half the
    prepass spacing must not exceed the dilation margin (``dilate`` coarse
    cells of the smallest AABB extent), or the prepass can step over an
    occupied cell. Raises ValueError when it is broken; returns the margin
    over the half spacing (>= 1 is safe)."""
    aabb_np = np.asarray(aabb_np, np.float64).reshape(2, 3)
    extent = float(np.min(aabb_np[1] - aabb_np[0]))
    margin = dilate * extent / coarse_reso
    half_spacing = 0.5 * (vis_far - vis_near) / max(prepass_n - 1, 1)
    if half_spacing > margin:
        raise ValueError(
            f"interval-culled march contract violated: half prepass "
            f"spacing {half_spacing:.4f} > dilation margin {margin:.4f} "
            f"(prepass_n={prepass_n}, dilate={dilate}, "
            f"coarse_reso={coarse_reso}, min aabb extent {extent:.3f}) — "
            f"raise prepass_n or dilate, or lower coarse_reso")
    return margin / half_spacing


def coarse_occupancy_lookup(coarse: torch.Tensor, packed_shape, coords):
    """Nearest-cell coarse occupancy at normalized coords [..., 3]; bool.
    ``packed_shape`` is the fine corner-packed grid's, whose cells the
    coarse grid blocks together."""
    Rc = coarse.shape[0]
    Zc, Yc, Xc = packed_shape[0], packed_shape[1], packed_shape[2]
    bz, by, bx = -(-Zc // Rc), -(-Yc // Rc), -(-Xc // Rc)
    i64 = torch.int64
    cx = torch.floor((coords[..., 0] + 1.0) * 0.5 * Xc).clamp(0, Xc - 1)
    cy = torch.floor((coords[..., 1] + 1.0) * 0.5 * Yc).clamp(0, Yc - 1)
    cz = torch.floor((coords[..., 2] + 1.0) * 0.5 * Zc).clamp(0, Zc - 1)
    idx = ((cz.to(i64) // bz * Rc + cy.to(i64) // by) * Rc
           + cx.to(i64) // bx)
    return coarse.reshape(-1)[idx]


@torch.no_grad()
def bake_app_feature_grid(cfg: FieldConfig, params: Dict,
                          dtype=torch.bfloat16,
                          max_reso: int = 0) -> torch.Tensor:
    """Corner-packed per-light radiance-feature grids [L, Zc*Yc*Xc, 8*A]
    (corner order 4*dz + 2*dy + dx, then the A features), on the factors
    resized to at most ``max_reso`` nodes per axis when it is > 0.

    The radiance feature basis^T (raw_app(x) * light_line[l]) of the VM
    factors at their own nodes is, per axis i, sum_r plane_i * line_i *
    (light_line[l] * basis)_i[r, a]: the product of the plane and line is
    made per node as [Z*Y*X, R] (at 64^3 nodes and R 48 a 50 MB f32
    temporary) and contracted with the [R, A] light-basis product."""
    _require_vm(cfg)
    lc = params["light_line"]                           # [L, sum R]
    basis = params["basis_mat"]                         # [sum R, A]
    spatial = ("yxr,zr->zyxr", "zxr,yr->zyxr", "zyr,xr->zyxr")
    grid, r0 = None, 0
    for i in range(3):
        plane, line = app_factors(cfg, params, i)
        if max_reso > 0:
            plane, line = _resized_factors(plane, line, max_reso)
        R = plane.shape[-1]
        nodes = torch.einsum(spatial[i], plane, line)           # [Z, Y, X, R]
        lb = lc[:, r0:r0 + R, None] * basis[None, r0:r0 + R]    # [L, R, A]
        term = torch.matmul(nodes.reshape(-1, R), lb)           # [L, ZYX, A]
        term = term.reshape(lc.shape[0], *nodes.shape[:3], -1)
        grid = term if grid is None else grid + term
        r0 += R
    L, Z, Y, X, A = grid.shape
    packed = torch.stack([grid[:, dz:Z - 1 + dz, dy:Y - 1 + dy,
                               dx:X - 1 + dx].to(dtype)
                          for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)],
                         -2)                          # [L, Zc, Yc, Xc, 8, A]
    return packed.reshape(L, (Z - 1) * (Y - 1) * (X - 1), 8 * A)


def app_bake_cells(cfg: FieldConfig, params: Dict, max_reso: int):
    """(Zc, Yc, Xc): the cell counts of ``bake_app_feature_grid`` at
    ``max_reso`` > 0, from the factor shapes (axis 0's plane is [Y, X], its
    line Z)."""
    plane, line = app_factors(cfg, params, 0)
    return (min(line.shape[0], max_reso) - 1,
            min(plane.shape[0], max_reso) - 1,
            min(plane.shape[1], max_reso) - 1)


def app_feature_baked(app_baked: torch.Tensor, grid_cells, coords,
                      light_idx) -> torch.Tensor:
    """Trilinear radiance feature [..., A] from the per-light app bake
    [L, Zc*Yc*Xc, 8*A] at normalized coords [..., 3] and light indices
    [...]: one K1 row of 8 corners x A bf16 features per point."""
    Zc, Yc, Xc = grid_cells
    L, cells, A8 = app_baked.shape
    x, y, z = coords[..., 0], coords[..., 1], coords[..., 2]
    fx = ((x + 1.0) * 0.5 * Xc).clamp(0.0, Xc)
    fy = ((y + 1.0) * 0.5 * Yc).clamp(0.0, Yc)
    fz = ((z + 1.0) * 0.5 * Zc).clamp(0.0, Zc)
    ix = torch.floor(fx).clamp(0, Xc - 1)
    iy = torch.floor(fy).clamp(0, Yc - 1)
    iz = torch.floor(fz).clamp(0, Zc - 1)
    wx, wy, wz = fx - ix, fy - iy, fz - iz
    i32 = torch.int32
    idx = (light_idx.to(i32) * cells
           + (iz.to(i32) * Yc + iy.to(i32)) * Xc + ix.to(i32))
    rows = row_gather(app_baked.reshape(L * cells, A8), idx.reshape(-1))
    rows = rows.float().reshape(*idx.shape, 8, A8 // 8)
    return (rows * _corner_weights(wx, wy, wz)[..., None]).sum(-2)


def _corner_weights(wx, wy, wz) -> torch.Tensor:
    """The 8 trilinear corner weights [..., 8] in corner order
    4*dz + 2*dy + dx."""
    w0x, w1x = 1.0 - wx, wx
    w0y, w1y = 1.0 - wy, wy
    w0z, w1z = 1.0 - wz, wz
    return torch.stack([
        w0z * w0y * w0x, w0z * w0y * w1x, w0z * w1y * w0x, w0z * w1y * w1x,
        w1z * w0y * w0x, w1z * w0y * w1x, w1z * w1y * w0x, w1z * w1y * w1x,
    ], -1)


# ---------------------------------------------------------------- alpha mask

def pack_corner_volume(vol: torch.Tensor,
                       dtype=torch.bfloat16) -> torch.Tensor:
    """Corner-pack a [D, H, W] volume into [D-1, H-1, W-1, 8] rows, the
    layout ``density_feature_packed`` reads: each cell's 8 corner values in
    channel order 4*dz + 2*dy + dx."""
    D, H, W = vol.shape
    return torch.stack([vol[dz:D - 1 + dz, dy:H - 1 + dy, dx:W - 1 + dx]
                        for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)],
                       -1).to(dtype)


def density_feature_packed(packed: torch.Tensor, coords) -> torch.Tensor:
    """Trilinear lookup of a corner-packed grid [Zc, Yc, Xc, 8] (corner
    order 4*dz + 2*dy + dx, f32 or bf16, read as f32) at coords [..., 3]:
    one K1 row per point. Not differentiable in ``packed``."""
    Zc, Yc, Xc, _ = packed.shape
    x, y, z = coords[..., 0], coords[..., 1], coords[..., 2]
    fx = ((x + 1.0) * 0.5 * Xc).clamp(0.0, Xc)
    fy = ((y + 1.0) * 0.5 * Yc).clamp(0.0, Yc)
    fz = ((z + 1.0) * 0.5 * Zc).clamp(0.0, Zc)
    ix = torch.floor(fx).clamp(0, Xc - 1)
    iy = torch.floor(fy).clamp(0, Yc - 1)
    iz = torch.floor(fz).clamp(0, Zc - 1)
    wx, wy, wz = fx - ix, fy - iy, fz - iz
    i32 = torch.int32
    idx = (iz.to(i32) * Yc + iy.to(i32)) * Xc + ix.to(i32)
    rows = row_gather(packed.reshape(Zc * Yc * Xc, 8),
                      idx.reshape(-1)).float().reshape(*idx.shape, 8)
    return (rows * _corner_weights(wx, wy, wz)).sum(-1)


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


def compute_alpha_grid(cfg: FieldConfig, params: Dict, scene: Dict, grid,
                       step):
    """alpha = 1 - exp(-sigma * step) at world points [..., 3], zero where
    the current alpha mask is."""
    mask = sample_alpha_mask(scene, grid) > 0
    coords = normalize_coord(scene["aabb"], grid)
    sigma = torch.where(mask, density(cfg, params, coords),
                        torch.zeros_like(mask, dtype=grid.dtype))
    return 1.0 - torch.exp(-sigma * step)
