"""The TensoIR radiance field (port of tensoir_tpu.models.field: config,
init, the queries of the training step, derived normals, the alpha mask,
the baked sigma grid (optionally on factors resized to a coarser grid) with
its coarse occupancy, the 27-corner pack of the grouped secondary march,
and the baked per-light appearance grid).

Three decompositions, as in the JAX package:
* ``vm``: per axis a plane [H, W, R] and a line [D, R], for density and
  for appearance (``density_plane_{i}``, ``density_line_{i}``, ``app_*``);
* ``cp``: lines only, the feature the product of the three axes' line
  lookups (``density_line_{i}``, ``app_line_{i}``);
* ``vm_stacked``: the legacy TensorVM, one plane and one line per axis
  holding both fields, channels [app (A) | density (D)]
  (``stack_plane_{i}``, ``stack_line_{i}``), read through slices.
Parameters and scene are flat dicts of tensors keyed exactly like the JAX
pytrees (also ``light_line``, ``basis_mat``, MLP dicts, ``lgt_sgs``), so a
JAX-initialized field carries over with ``weights.params_from_numpy``.
Every plane lookup goes through the corner-packed row gather K1 on f32
rows (a stacked slice is packed into a contiguous table first); line
lookups are products with a two-tap matrix wherever a gradient can flow
through them, and two taps read by the line-taps kernel elsewhere
(``ops.interp.line_product``); the corner-packed trilinear
lookups (alpha mask, baked sigma grid, baked appearance grid) go through
K1 on bf16 rows. The grouped lookups read one row per group of nearby
points: a 16-corner f32 block row of a plane (primary march) or a
27-corner bf16 block row of the baked grid (secondary march).
``compute_dtype`` ``bfloat16`` rounds the operands of the
basis and MLP products to bf16 and keeps their results in f32.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as Fn

from tensoir_tpu_torch.device import DeviceLike, resolve_device
from tensoir_tpu_torch.kernels import row_gather
from tensoir_tpu_torch.models import lighting, mlps
from tensoir_tpu_torch.models.mlps import dot
from tensoir_tpu_torch.ops.interp import (bilerp_plane_group_packed,
                                          bilerp_plane_packed,
                                          device_constant, line_product,
                                          resize_bilinear_align_corners,
                                          resize_line_align_corners,
                                          trilerp_volume)
from tensoir_tpu_torch.ops.rays import linspace, safe_l2_normalize
from tensoir_tpu_torch.profiling import span

MAT_MODE = ((0, 1), (0, 2), (1, 2))
VEC_MODE = (2, 1, 0)


@dataclass(frozen=True)
class FieldConfig:
    density_n_comp: Tuple[int, int, int] = (16, 16, 16)
    app_n_comp: Tuple[int, int, int] = (48, 48, 48)
    app_dim: int = 27
    decomp: str = "vm"  # 'vm' | 'cp' | 'vm_stacked' (legacy TensorVM)
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


def grid_size_of(params: Dict) -> Tuple[int, int, int]:
    """(X, Y, Z) grid resolution from the line shapes."""
    pre = "stack" if "stack_line_0" in params else "density"
    return (params[f"{pre}_line_2"].shape[0],
            params[f"{pre}_line_1"].shape[0],
            params[f"{pre}_line_0"].shape[0])


def init_field_params(gen: torch.Generator, cfg: FieldConfig, grid_size,
                      aabb, device: DeviceLike = None, gt_envmap=None):
    """(params, scene) dicts on ``device``, drawn from ``gen`` on the CPU.

    Same keys, shapes and distributions as the JAX package's
    ``init_field_params`` (VM factors and stacked planes and lines 0.1 *
    randn, CP lines 0.2 * randn; light_line randn, or ones for
    ``vm_stacked``, whose legacy model has no light factor; basis
    U(+-1/sqrt(n)) with n = sum Ra, or Ra[0] for CP, whose feature is one
    product; the MLPs of the shading mode and normals kind; SG lights); the
    numbers differ, because the generators do. The scene starts with the
    permissive 2^3 alpha mask, and holds ``gt_envmap`` [H, W, 3], the
    dataset's probe, when given (the light of ``light_kind='gt'``).
    """
    if cfg.decomp not in ("vm", "cp", "vm_stacked"):
        raise ValueError(f"unknown decomp {cfg.decomp!r}")
    dev = resolve_device(device)
    params: Dict = {}
    if cfg.decomp == "vm_stacked":
        for i in range(3):
            m0, m1 = MAT_MODE[i]
            c = cfg.app_n_comp[i] + cfg.density_n_comp[i]
            params[f"stack_plane_{i}"] = 0.1 * torch.randn(
                (grid_size[m1], grid_size[m0], c), generator=gen)
            params[f"stack_line_{i}"] = 0.1 * torch.randn(
                (grid_size[VEC_MODE[i]], c), generator=gen)
    else:
        scale = 0.1 if cfg.decomp == "vm" else 0.2
        for name, ncomp in (("density", cfg.density_n_comp),
                            ("app", cfg.app_n_comp)):
            for i in range(3):
                m0, m1 = MAT_MODE[i]
                if cfg.decomp == "vm":
                    params[f"{name}_plane_{i}"] = 0.1 * torch.randn(
                        (grid_size[m1], grid_size[m0], ncomp[i]),
                        generator=gen)
                params[f"{name}_line_{i}"] = scale * torch.randn(
                    (grid_size[VEC_MODE[i]], ncomp[i]), generator=gen)
    sum_ra = (cfg.app_n_comp[0] if cfg.decomp == "cp"
              else sum(cfg.app_n_comp))
    bound = 1.0 / np.sqrt(sum_ra)
    params["basis_mat"] = (torch.rand((sum_ra, cfg.app_dim), generator=gen)
                           * 2.0 - 1.0) * bound
    if cfg.decomp == "vm_stacked":
        params["light_line"] = torch.ones((cfg.light_num, sum_ra))
    else:
        params["light_line"] = torch.randn((cfg.light_num, sum_ra),
                                           generator=gen)
    if cfg.shading_mode == "MLP_Fea":
        in_dim = mlps.render_fea_in_dim(cfg.app_dim, cfg.view_pe, cfg.fea_pe)
    elif cfg.shading_mode == "MLP_PE":
        in_dim = mlps.render_pe_in_dim(cfg.app_dim, cfg.view_pe, cfg.pos_pe)
    elif cfg.shading_mode == "MLP":
        in_dim = mlps.render_plain_in_dim(cfg.app_dim, cfg.view_pe)
    else:   # SH and RGB shade the features themselves
        in_dim = 0
    if in_dim:
        params["render_mlp"] = mlps.init_mlp(gen, in_dim, cfg.feature_c, 3)
    brdf_in = mlps.brdf_pe_fea_in_dim(cfg.app_dim, cfg.pos_pe, cfg.fea_pe)
    params["brdf_mlp"] = mlps.init_mlp(gen, brdf_in, cfg.feature_c, 4)
    if cfg.normals_kind in ("purely_predicted", "derived_plus_predicted"):
        params["normal_mlp"] = mlps.init_mlp(gen, brdf_in, cfg.feature_c, 3)
    elif cfg.normals_kind == "residue_prediction":
        params["normal_mlp"] = mlps.init_mlp(
            gen, mlps.normal_residue_in_dim(cfg.app_dim, cfg.pos_pe,
                                            cfg.fea_pe), cfg.feature_c, 3)
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
    some of them across the nearest-voxel test's rounding ties. The grid's
    sizes are a kept device constant (``device_constant``)."""
    grid = device_constant(grid_size, torch.float32, aabb.device)
    units = (aabb[1] - aabb[0]) / (grid - 1.0)
    return (units[0] + units[1] + units[2]) * (1.0 / 3.0) * step_ratio


def num_samples_for(aabb_np, grid_size, step_ratio: float) -> int:
    """Static sample count on the host: diag / step + 1, in float64."""
    aabb_np = np.asarray(aabb_np).reshape(2, 3)
    size = aabb_np[1] - aabb_np[0]
    units = size / (np.asarray(grid_size, np.float64) - 1.0)
    step = float(np.mean(units) * step_ratio)
    return int(float(np.linalg.norm(size)) / step) + 1


# ------------------------------------------------------------------- queries

def density_factors(cfg: FieldConfig, params: Dict, i: int):
    """(plane [H, W, D] or None for CP, line [R, D]) density factors of
    axis i; ``vm_stacked`` reads the last D channels of the shared
    tensors (views, not copies)."""
    if cfg.decomp == "vm_stacked":
        a = cfg.app_n_comp[i]
        return (params[f"stack_plane_{i}"][..., a:],
                params[f"stack_line_{i}"][..., a:])
    return params.get(f"density_plane_{i}"), params[f"density_line_{i}"]


def app_factors(cfg: FieldConfig, params: Dict, i: int):
    """(plane [H, W, A] or None for CP, line [R, A]) appearance factors of
    axis i; ``vm_stacked`` reads the first A channels."""
    if cfg.decomp == "vm_stacked":
        a = cfg.app_n_comp[i]
        return (params[f"stack_plane_{i}"][..., :a],
                params[f"stack_line_{i}"][..., :a])
    return params.get(f"app_plane_{i}"), params[f"app_line_{i}"]


def _cp_product(params: Dict, name: str, coords) -> torch.Tensor:
    """CP's feature [..., R]: the product of the three line lookups, each
    with the taps of the JAX package's gathering ``lerp_line`` (its value
    and gradients, the linear extension below the first node included),
    in the product form wherever a gradient can flow (``line_product``)."""
    return line_product(tuple(params[f"{name}_line_{i}"] for i in range(3)),
                        coords, VEC_MODE, extrapolate=True)


def density_feature(cfg: FieldConfig, params: Dict, coords):
    """sigma feature at normalized coords [..., 3]: sum_i <plane_i(c),
    line_i(c)> (VM), or the sum over components of the product of the
    three line lookups (CP)."""
    with span("field"):
        if cfg.decomp == "cp":
            return _cp_product(params, "density", coords).sum(-1)
        total = coords.new_zeros(coords.shape[:-1])
        for i in range(3):
            m0, m1 = MAT_MODE[i]
            plane, line = density_factors(cfg, params, i)
            lf = line_product((line,), coords, (VEC_MODE[i],))
            pf = bilerp_plane_packed(plane, coords[..., m0], coords[..., m1])
            total = total + (pf * lf).sum(-1)
        return total


def density_feature_grouped(cfg: FieldConfig, params: Dict, coords_g):
    """``density_feature`` for groups of depth-adjacent samples, coords_g
    [..., g, 3] -> [..., g]: the lines as products, the planes through one
    16-corner block row per group (``bilerp_plane_group_packed``); equal
    to the per-sample feature up to the order of the sums while each
    group stays inside its 3 x 3-cell block. VM and ``vm_stacked`` only."""
    with span("field"):
        if cfg.decomp not in ("vm", "vm_stacked"):
            raise ValueError(f"no grouped density for decomp {cfg.decomp!r}")
        total = coords_g.new_zeros(coords_g.shape[:-1])
        for i in range(3):
            m0, m1 = MAT_MODE[i]
            plane, line = density_factors(cfg, params, i)
            lf = line_product((line,), coords_g, (VEC_MODE[i],))
            pf = bilerp_plane_group_packed(plane, coords_g[..., m0],
                                           coords_g[..., m1])
            total = total + (pf * lf).sum(-1)
        return total


def _app_raw_feature(cfg: FieldConfig, params: Dict, coords):
    """Concatenated per-axis appearance features [..., sum(Ra)] (VM), or
    the product of the three line lookups [..., Ra] (CP)."""
    with span("field"):
        if cfg.decomp == "cp":
            return _cp_product(params, "app", coords)
        feats = []
        for i in range(3):
            m0, m1 = MAT_MODE[i]
            plane, line = app_factors(cfg, params, i)
            lf = line_product((line,), coords, (VEC_MODE[i],))
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


def both_features(cfg: FieldConfig, params: Dict, coords, light_idx):
    """(radiance_feat, intrinsic_feat): basis(pl * light_line[light_idx])
    and basis(pl * mean_l light_line[l]), the products in
    ``cfg.compute_dtype``."""
    pl = _app_raw_feature(cfg, params, coords)
    lc = light_rows(params["light_line"], light_idx)
    mean_lc = params["light_line"].mean(0)
    basis, dt = params["basis_mat"], cfg.compute_dtype
    return dot(pl * lc, basis, dt), dot(pl * mean_lc, basis, dt)


def app_feature(cfg: FieldConfig, params: Dict, coords, light_idx):
    """Radiance feature only."""
    pl = _app_raw_feature(cfg, params, coords)
    return dot(pl * light_rows(params["light_line"], light_idx),
               params["basis_mat"], cfg.compute_dtype)


def intrin_feature(cfg: FieldConfig, params: Dict, coords):
    """Intrinsic (light-averaged) feature only."""
    pl = _app_raw_feature(cfg, params, coords)
    return dot(pl * params["light_line"].mean(0), params["basis_mat"],
               cfg.compute_dtype)


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
    """The sigma feature on the factors' own grid nodes, [Z, Y, X]: per
    axis an outer product of a plane and a line, summed over components
    (VM), or the three lines' outer product (CP)."""
    if cfg.decomp == "cp":
        return torch.einsum("zr,yr,xr->zyx", params["density_line_0"],
                            params["density_line_1"],
                            params["density_line_2"])
    p0, l0 = density_factors(cfg, params, 0)  # [Y, X, R], [Z, R]
    p1, l1 = density_factors(cfg, params, 1)  # [Z, X, R], [Y, R]
    p2, l2 = density_factors(cfg, params, 2)  # [Z, Y, R], [X, R]
    out = torch.einsum("yxr,zr->zyx", p0, l0)
    out = out + torch.einsum("zxr,yr->zyx", p1, l1)
    return out + torch.einsum("zyr,xr->zyx", p2, l2)


def density_feature_baked(baked: torch.Tensor, aabb, xyz) -> torch.Tensor:
    """Trilinear lookup of a dense baked sigma-feature grid [Z, Y, X] at
    world points [..., 3]."""
    return trilerp_volume(baked, normalize_coord(aabb, xyz))


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


def _resized_factors(plane, line: torch.Tensor, max_reso: int):
    """A plane [H, W, R] (None for CP) and a line [D, R] resized to at most
    ``max_reso`` nodes per axis (``align_corners``: the resized factors are
    the field's exact factors at the coarser nodes)."""
    if plane is not None:
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
    at most ``max_reso`` nodes per axis when it is > 0. The density
    factors are re-keyed under the split names first (``vm_stacked``'s
    slices become ``vm`` factors; CP keeps its lines only)."""
    dense: Dict = {}
    for i in range(3):
        plane, line = density_factors(cfg, params, i)
        if max_reso > 0:
            plane, line = _resized_factors(plane, line, max_reso)
        if plane is not None:
            dense[f"density_plane_{i}"] = plane
        dense[f"density_line_{i}"] = line
    if cfg.decomp == "vm_stacked":
        cfg = dataclasses.replace(cfg, decomp="vm")
    baked = bake_sigma_feature_grid(cfg, dense)
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


# the 27-corner rows of the grouped march are stored this wide: 27 bf16
# corners and 5 zero channels, 64 bytes, a row K1 copies in four 16-byte
# pieces per thread. A 54-byte row is not a multiple of 16 and takes its
# element-per-thread route: on an H100 (chip_smoke.py's kernels phase) 25 %
# slower on the 2M-row table of a 128 bake, 9 % faster on the 238k rows of
# a 64 bake, which fit the L2
PAIR_ROW = 32


@torch.no_grad()
def bake_pair_packed_sigma_grid(cfg: FieldConfig, params: Dict, scene: Dict,
                                dtype=torch.bfloat16,
                                max_reso: int = 0) -> torch.Tensor:
    """27-corner (2 x 2 x 2-cell block) pack of the masked dense bake, for
    the grouped secondary march: one row serves a group of adjacent window
    samples. The same dense grid as ``bake_packed_sigma_grid``, another
    packing."""
    return pack_corner27_grid(
        _bake_masked_dense(cfg, params, scene, max_reso), dtype)


def pack_corner27_grid(masked_dense: torch.Tensor,
                       dtype=torch.bfloat16) -> torch.Tensor:
    """Block-pack a dense grid [Z, Y, X] into [Z-2, Y-2, X-2, PAIR_ROW]
    rows holding the 3 x 3 x 3 nodes of each 2 x 2 x 2-cell block in
    channel order 9*dz + 3*dy + dx, then zero channels. Each slice is
    converted to ``dtype`` on its own, so no [.., 27] f32 temporary is
    made."""
    Z, Y, X = masked_dense.shape
    out = masked_dense.new_zeros((Z - 2, Y - 2, X - 2, PAIR_ROW),
                                 dtype=dtype)
    c = 0
    for dz in (0, 1, 2):
        for dy in (0, 1, 2):
            for dx in (0, 1, 2):
                out[..., c] = masked_dense[dz:Z - 2 + dz, dy:Y - 2 + dy,
                                           dx:X - 2 + dx]
                c += 1
    return out


def density_feature_group_packed(packed27: torch.Tensor,
                                 coords: torch.Tensor) -> torch.Tensor:
    """Trilinear sigma features of groups of nearby points, coords
    [..., g, 3] normalized on the unpacked grid -> [..., g]: ONE K1 row of
    the 27-corner pack per group (read as f32; the pad channels are cut off
    after the gather). The block starts at the group's smallest cell,
    clamped to the grid; each point's offset in it is clamped to [0, 1], so
    a group wider than one cell per axis (a broken ``check_pair_contract``)
    reads clamped cells, not another block. Equal to
    ``density_feature_packed`` on each point, up to the order of the
    sums, within the contract."""
    with span("field"):
        Zb, Yb, Xb, K = packed27.shape
        Zc, Yc, Xc = Zb + 1, Yb + 1, Xb + 1   # cell counts of the fine grid
        x, y, z = coords[..., 0], coords[..., 1], coords[..., 2]
        fx = ((x + 1.0) * 0.5 * Xc).clamp(0.0, Xc)
        fy = ((y + 1.0) * 0.5 * Yc).clamp(0.0, Yc)
        fz = ((z + 1.0) * 0.5 * Zc).clamp(0.0, Zc)
        ix = torch.floor(fx).clamp(0, Xc - 1)
        iy = torch.floor(fy).clamp(0, Yc - 1)
        iz = torch.floor(fz).clamp(0, Zc - 1)
        wx, wy, wz = fx - ix, fy - iy, fz - iz
        bx = ix.amin(-1).clamp(0, Xc - 2)
        by = iy.amin(-1).clamp(0, Yc - 2)
        bz = iz.amin(-1).clamp(0, Zc - 2)
        ox = (ix - bx[..., None]).clamp(0.0, 1.0)
        oy = (iy - by[..., None]).clamp(0.0, 1.0)
        oz = (iz - bz[..., None]).clamp(0.0, 1.0)

        def axis_weights(off, w):
            # the point's cell starts at block node `off`: node off gets 1 - w,
            # node off + 1 gets w
            at0 = off == 0.0
            zero = w.new_zeros(())
            return torch.stack([torch.where(at0, 1.0 - w, zero),
                                torch.where(at0, w, 1.0 - w),
                                torch.where(at0, zero, w)], -1)  # [..., g, 3]

        uz, uy, ux = axis_weights(oz, wz), axis_weights(oy, wy), \
            axis_weights(ox, wx)
        w27 = (uz[..., :, None, None] * uy[..., None, :, None]
               * ux[..., None, None, :]).reshape(*uz.shape[:-1], 27)
        i32 = torch.int32
        idx = (bz.to(i32) * Yb + by.to(i32)) * Xb + bx.to(i32)
        rows = row_gather(packed27.reshape(Zb * Yb * Xb, K), idx.reshape(-1))
        rows = rows[:, :27].float().reshape(*idx.shape, 1, 27)
        return (rows * w27).sum(-1)


def check_pair_contract(aabb_np, packed_shape, *, n_sample: int, group: int,
                        vis_near: float = 0.05,
                        vis_far: float = 1.5) -> float:
    """The grouped march's contract, on the host: a group of ``group``
    consecutive window samples spans (group - 1) fine steps, which must not
    exceed the smallest bake cell, so that every sample's cell is at most
    one from the group's smallest and one 2 x 2 x 2-cell block holds them
    all. ``packed_shape`` is the 27-corner pack's (cell counts - 1).
    Raises ValueError when it is broken; returns cell / span (>= 1 is
    safe)."""
    aabb_np = np.asarray(aabb_np, np.float64).reshape(2, 3)
    extents = aabb_np[1] - aabb_np[0]
    cells = np.asarray(packed_shape[:3], np.float64)[::-1] + 1.0  # X, Y, Z
    cell = float(np.min(extents / cells))
    span = (group - 1) * (vis_far - vis_near) / max(n_sample - 1, 1)
    if span > cell:
        raise ValueError(
            f"grouped-march contract violated: group span {span:.5f} > min "
            f"bake cell {cell:.5f} (n_sample={n_sample}, group={group}, "
            f"cells={cells}, extents={extents}) — lower second_march_group "
            f"or the pair-bake reso")
    return cell / span


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
    temporary) and contracted with the [R, A] light-basis product. VM
    and ``vm_stacked`` only: CP keeps the exact appearance path."""
    if cfg.decomp not in ("vm", "vm_stacked"):
        raise ValueError(f"no appearance bake for decomp {cfg.decomp!r}")
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
    with span("field"):
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
    with span("field"):
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
