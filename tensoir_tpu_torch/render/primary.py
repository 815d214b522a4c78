"""Primary ray rendering (port of tensoir_tpu.render.primary.render_rays).

A fixed-step march (or with ``ndc_ray`` the forward-facing NDC march:
uniform z in [near, far]), or with ``march_cap`` the first ``march_cap``
samples per ray that the dilated alpha mask marks occupied (with
``march_group`` g, the first march_cap / g groups of g consecutive samples
with any member occupied, whose density reads one 16-corner block row per
group); density on every kept sample (zero outside the AABB and the alpha
mask), compositing, then appearance and the shader (MLP_Fea, MLP_PE, MLP,
SH or RGB) on a fixed per-ray top-k of samples by weight (``app_cap``).
With
``is_relight`` the same top-k samples also get the BRDF MLP, its jittered
copy for the smoothness losses, and normals (derived from the density's
gradient, predicted by the normal MLP from the BRDF inputs or, as a
residue, from the derived normal too, both, or zeros that the training
renderer replaces by the dataset's normals). Randomness comes from a
``torch.Generator`` passed as ``key``; ``key=None`` is the deterministic
eval path.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from tensoir_tpu_torch.models import field as F
from tensoir_tpu_torch.models import mlps
from tensoir_tpu_torch.ops.color import linear2srgb
from tensoir_tpu_torch.ops.compositing import raw2alpha
from tensoir_tpu_torch.ops.interp import clip, device_constant
from tensoir_tpu_torch.ops.rays import (safe_l2_normalize, sample_ray,
                                        sample_ray_ndc, z_to_dists)
from tensoir_tpu_torch.ops.sh import eval_sh_bases
from tensoir_tpu_torch.profiling import span


def shade_radiance(cfg: F.FieldConfig, params, pts, viewdirs, features):
    """RGB of the shading mode at normalized points ``pts`` [..., 3] seen
    along ``viewdirs`` from radiance ``features``: an MLP (sigmoid) on
    MLP_Fea's, MLP_PE's or MLP's inputs, degree-2 SH coefficients (9 per
    channel, relu(sum + 0.5)), or the features themselves (RGB)."""
    mode = cfg.shading_mode
    if mode in ("MLP_Fea", "MLP_PE", "MLP"):
        if mode == "MLP_Fea":
            x = mlps.render_fea_inputs(features, viewdirs, cfg.view_pe,
                                       cfg.fea_pe)
        elif mode == "MLP_PE":
            x = mlps.render_pe_inputs(pts, features, viewdirs, cfg.view_pe,
                                      cfg.pos_pe)
        else:
            x = mlps.render_plain_inputs(features, viewdirs, cfg.view_pe)
        return torch.sigmoid(mlps.apply_mlp(params["render_mlp"], x,
                                            cfg.compute_dtype))
    if mode == "SH":
        sh_mult = eval_sh_bases(2, viewdirs)[..., None, :]
        rgb_sh = features.reshape(*features.shape[:-1], 3, 9)
        return torch.relu((sh_mult * rgb_sh).sum(-1) + 0.5)
    if mode == "RGB":
        return features
    raise ValueError(f"unknown shading mode {mode}")


def select_occupied_samples(valid: torch.Tensor, cap: int):
    """Indices of the first ``cap`` occupied samples of each ray, in depth
    order, by a top-k on a depth score: (idx [B, cap], sel_valid [B, cap]).
    Exact whenever a ray has at most ``cap`` occupied samples."""
    B, S = valid.shape
    iota = torch.arange(S, device=valid.device).expand(B, S)
    score = torch.where(valid, (S - iota).float(),
                        torch.full((B, S), -1.0, device=valid.device))
    top, idx = torch.topk(score, cap, dim=1)
    return idx, top > 0.0


def select_occupied_samples_scatter(valid: torch.Tensor, cap: int):
    """Same result as ``select_occupied_samples`` by a cumsum and one
    scatter. Samples past the cap go to a dump slot ``cap``, the only slot
    that receives more than one write, and it is cut off."""
    B, S = valid.shape
    pos = torch.cumsum(valid.to(torch.int64), 1) - 1
    pos = torch.where(valid & (pos < cap), pos, torch.full_like(pos, cap))
    iota = torch.arange(S, device=valid.device).expand(B, S)
    idx = torch.full((B, cap + 1), S - 1, dtype=torch.int64,
                     device=valid.device)
    idx = idx.scatter(1, pos, iota)[:, :cap]
    count = valid.sum(1)
    sel_valid = torch.arange(cap, device=valid.device)[None, :] < count[:, None]
    return idx, sel_valid


def compact_nonzero(score: torch.Tensor, cap: int):
    """Indices of the first ``cap`` entries with score > 0, by a cumsum and
    one scatter: (idx [cap], valid [cap]). Unfilled slots hold the
    out-of-range marker N, so a caller clips gathers through them and
    drops scatters through them."""
    (N,) = score.shape
    nz = score > 0
    pos = torch.cumsum(nz.to(torch.int64), 0) - 1
    pos = torch.where(nz & (pos < cap), pos, torch.full_like(pos, cap))
    idx = torch.full((cap + 1,), N, dtype=torch.int64, device=score.device)
    idx = idx.scatter(0, pos, torch.arange(N, device=score.device))
    count = nz.sum()
    valid = torch.arange(cap, device=score.device) < torch.clamp(count,
                                                                 max=cap)
    return idx[:cap], valid


def _relative_smoothness(values, values_jitter):
    """sum(((v - vj) / max(v, vj))^2) over the last axis."""
    base = clip(torch.maximum(values, values_jitter), 1e-6, None)
    return (((values - values_jitter) / base) ** 2).sum(-1, keepdim=True)


def take_samples(x, idx):
    """x [B, S] or [B, S, C] at per-ray sample indices idx [B, k]."""
    if x.dim() == 2:
        return torch.gather(x, 1, idx)
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def _select_groups(cfg: F.FieldConfig, valid_occ: torch.Tensor, select,
                   march_cap: int, g: int, ndc_ray: bool):
    """The grouped march's selection: the first march_cap / g groups of g
    consecutive samples with any member occupied, expanded to their
    members, (midx [B, march_cap], ray_valid [B, march_cap], overflow [B]).
    A superset of the per-sample selection (a member that is not occupied
    stays invalid), so the result is the per-sample march's on every ray
    that does not overflow (more than march_cap / g occupied groups); the
    members stay depth-adjacent, so that one block row serves a group.

    The 16-corner block holds a group while its span (g - 1) * step is at
    most 2 cells per axis: checked here as (g - 1) * step_ratio <= 2 for
    near-isotropic cells, and against the live AABB's worst axis at each
    phase rebuild by ``train.loop.resolve_primary_march_group``."""
    if ndc_ray:
        raise ValueError(
            "march_group > 1 is not supported with ndc_ray=True: the "
            "NDC march's sample spacing is not step_ratio-based, so the "
            "3x3-cell block contract cannot be checked statically")
    if march_cap % g:
        raise ValueError(f"march_group={g} must divide "
                         f"march_cap={march_cap}")
    if (g - 1) * cfg.step_ratio > 2.0:
        raise ValueError(
            f"march_group={g} at step_ratio={cfg.step_ratio} "
            f"violates the 16-corner block contract "
            f"((g-1)*step_ratio = {(g - 1) * cfg.step_ratio:.2f} "
            f"> 2 cells)")
    B, S = valid_occ.shape
    n_groups = -(-S // g)
    vpad = torch.cat([valid_occ, valid_occ.new_zeros((B, n_groups * g - S))],
                     1)
    gvalid = vpad.reshape(B, n_groups, g).any(2)
    gidx, gsel = select(gvalid, march_cap // g)
    midx_raw = (gidx[..., None] * g + torch.arange(
        g, device=gidx.device)).reshape(B, march_cap)
    midx = midx_raw.clamp(max=S - 1)
    ray_valid = (gsel.repeat_interleave(g, 1) & (midx_raw < S)
                 & take_samples(valid_occ, midx))
    return midx, ray_valid, gvalid.sum(1) > march_cap // g


def render_rays(
    cfg: F.FieldConfig,
    params: Dict,
    scene: Dict,
    rays: torch.Tensor,        # [B, 6]
    light_idx: torch.Tensor,   # [B] int
    *,
    n_samples: int,
    key: Optional[torch.Generator] = None,
    is_train: bool = False,
    is_relight: bool = True,
    white_bg: bool = True,
    app_cap: int = 32,
    march_cap: int = 0,
    march_select: str = "scatter",
    march_group: int = 0,
    ndc_ray: bool = False,
) -> Dict[str, torch.Tensor]:
    """The primary pass's maps of the rays [B, 6] under lights
    ``light_idx`` [B]. With ``cfg.normals_kind`` ``gt_normals`` the normals
    are zeros: ``render_train_batch`` puts the dataset's in their place."""
    B = rays.shape[0]
    rays_o, viewdirs = rays[:, :3], rays[:, 3:6]
    aabb = scene["aabb"]
    step = F.step_size(aabb, F.grid_size_of(params), cfg.step_ratio)
    near, far = cfg.near_far

    jitter = None
    if ndc_ray:
        # uniform z in [near, far], each sample jittered within its bin at
        # train time; dists scaled by the ray's norm, the view directions
        # normalized afterwards
        if key is not None and is_train:
            jitter = torch.rand((B, n_samples), generator=key,
                                device=rays.device, dtype=rays.dtype)
        xyz, z_vals, ray_valid = sample_ray_ndc(rays_o, viewdirs, aabb, near,
                                                far, n_samples, jitter=jitter)
        rays_norm = torch.linalg.vector_norm(viewdirs, dim=-1, keepdim=True)
        dists = z_to_dists(z_vals) * rays_norm
        viewdirs = viewdirs / rays_norm.clamp_min(1e-12)
    else:
        if key is not None and is_train:
            jitter = torch.rand((B, 1), generator=key, device=rays.device,
                                dtype=rays.dtype)
        xyz, z_vals, ray_valid = sample_ray(rays_o, viewdirs, aabb, near,
                                            far, step, n_samples,
                                            jitter=jitter)
        dists = z_to_dists(z_vals)
    coords = F.normalize_coord(aabb, xyz)                      # [B, S, 3]

    out = {}
    if 0 < march_cap < n_samples:
        # the nearest-voxel test on the extra-dilated mask keeps a superset
        # of the samples the trilinear mask keeps; the trilinear mask then
        # gates the kept ones, so the result is the dense march's whenever
        # no ray has more than march_cap occupied samples
        if march_select not in ("scatter", "topk"):
            raise ValueError(f"unknown march_select {march_select!r} "
                             "(expected 'scatter' or 'topk')")
        select = (select_occupied_samples_scatter if march_select == "scatter"
                  else select_occupied_samples)
        valid_occ = ray_valid & F.sample_alpha_mask_nearest(scene, xyz)
        if march_group > 1:
            midx, ray_valid, overflow = _select_groups(
                cfg, valid_occ, select, march_cap, march_group, ndc_ray)
        else:
            overflow = valid_occ.sum(1) > march_cap
            midx, ray_valid = select(valid_occ, march_cap)
        # rays that keep fewer occupied samples than they have: the culled
        # march is exact only on the others
        out["march_overflow_frac"] = overflow.float().mean()
        coords = take_samples(coords, midx)
        z_vals = take_samples(z_vals, midx)
        dists = take_samples(dists, midx)
        xyz = take_samples(xyz, midx)
    ray_valid = ray_valid & (F.sample_alpha_mask(scene, xyz) > 0)

    if (march_group > 1 and 0 < march_cap < n_samples
            and cfg.decomp in ("vm", "vm_stacked")):
        # one 16-corner block row per group of march_group samples; CP has
        # no plane and keeps the per-sample density on the group selection
        sigma_feat = F.density_feature_grouped(
            cfg, params,
            coords.reshape(B, march_cap // march_group, march_group, 3)
        ).reshape(B, march_cap)
    else:
        sigma_feat = F.density_feature(cfg, params, coords)
    sigma = torch.where(ray_valid, F.feature2density(cfg, sigma_feat),
                        torch.zeros_like(sigma_feat))
    _, weight, _ = raw2alpha(sigma, dists * cfg.distance_scale)
    acc_map = weight.sum(-1)
    depth_map = (weight * z_vals).sum(-1)

    # appearance on a fixed top-k of samples by weight; slots past the
    # samples above the threshold carry weight 0
    S = weight.shape[1]
    k = app_cap if 0 < app_cap < S else S
    if k < S:
        masked_w = torch.where(weight > cfg.raymarch_weight_thres, weight,
                               torch.full_like(weight, -1.0))
        top_w, top_idx = torch.topk(masked_w, k, dim=1)
        sel_mask = top_w > 0.0
    else:
        top_idx = torch.arange(S, device=rays.device).expand(B, S)
        top_w = weight
        sel_mask = weight > cfg.raymarch_weight_thres
    pts_sel = take_samples(coords, top_idx)
    w_sel = top_w * sel_mask
    vdirs_sel = viewdirs[:, None, :].expand(pts_sel.shape)
    lidx_sel = light_idx[:, None].expand(B, pts_sel.shape[1])

    if is_relight:
        rad_feat, intr_feat = F.both_features(cfg, params, pts_sel, lidx_sel)
    else:
        rad_feat = F.app_feature(cfg, params, pts_sel, lidx_sel)
    rgb = shade_radiance(cfg, params, pts_sel, vdirs_sel,
                         rad_feat)                             # [B, k, 3]
    rgb_map = (w_sel[..., None] * rgb).sum(-2)

    # white background, or a coin flip per batch at train time
    if white_bg:
        bgw = 1.0
    elif is_train and key is not None:
        bgw = (torch.rand((), generator=key, device=rays.device)
               < 0.5).to(rgb_map.dtype)
    else:
        bgw = 0.0
    depth_map = depth_map + bgw * (1.0 - acc_map) * rays[:, -1]
    out.update(acc_map=acc_map, depth_map=depth_map)
    if not is_relight:
        out["rgb_map"] = rgb_map + bgw * (1.0 - acc_map[..., None])
        return out

    # ---- relight branch: BRDF and normals on the selected samples ----
    brdf_in = mlps.brdf_pe_fea_inputs(pts_sel, intr_feat, cfg.pos_pe,
                                      cfg.fea_pe)
    cdt = cfg.compute_dtype
    brdf = torch.sigmoid(mlps.apply_mlp(params["brdf_mlp"], brdf_in, cdt))
    albedo = brdf[..., :3]
    roughness = brdf[..., 3:4] * 0.9 + 0.09

    # the BRDF at jittered points, for the smoothness losses
    if key is not None:
        noise = torch.randn(pts_sel.shape, generator=key, device=rays.device,
                            dtype=pts_sel.dtype) * 0.01
    else:
        noise = torch.zeros_like(pts_sel)
    pts_jit = pts_sel + noise
    intr_jit = F.intrin_feature(cfg, params, pts_jit)
    brdf_jit = torch.sigmoid(mlps.apply_mlp(
        params["brdf_mlp"],
        mlps.brdf_pe_fea_inputs(pts_jit, intr_jit, cfg.pos_pe, cfg.fea_pe),
        cdt))
    sel = sel_mask[..., None]
    albedo_sm = _relative_smoothness(albedo, brdf_jit[..., :3]) * sel
    roughness_sm = _relative_smoothness(
        roughness, brdf_jit[..., 3:4] * 0.9 + 0.09) * sel

    normals_diff = torch.zeros_like(albedo_sm)
    normals_ori = torch.zeros_like(albedo_sm)
    kind = cfg.normals_kind
    if kind in ("purely_derived", "derived_plus_predicted",
                "residue_prediction"):
        with span("derived_normals"):
            derived = F.derived_normals(
                cfg, params, pts_sel.reshape(-1, 3)).reshape(pts_sel.shape)
    if kind == "purely_derived":
        normals = derived
    elif kind == "gt_normals":
        normals = torch.zeros_like(pts_sel)
    elif kind in ("purely_predicted", "derived_plus_predicted",
                  "residue_prediction"):
        # the normal MLP reads the BRDF MLP's inputs, or as a residue the
        # derived normal as well
        nrm_in = (mlps.normal_residue_inputs(pts_sel, derived, intr_feat,
                                             cfg.pos_pe, cfg.fea_pe)
                  if kind == "residue_prediction" else brdf_in)
        normals = torch.tanh(mlps.apply_mlp(params["normal_mlp"], nrm_in,
                                            cdt))
        if kind != "purely_predicted":
            normals_diff = ((normals - derived) ** 2).sum(
                -1, keepdim=True) * sel
            normals_ori = clip((vdirs_sel * normals).sum(-1, keepdim=True),
                               0.0, None) * sel
    else:
        raise ValueError(kind)

    w1 = w_sel[..., None]
    acc1 = (1.0 - acc_map[..., None]) * bgw
    normal_map = (w1 * normals).sum(-2) + acc1 * device_constant(
        (0.0, 0.0, 1.0), normals.dtype, normals.device)
    albedo_map = (w1 * albedo).sum(-2) + acc1
    roughness_map = (w1 * roughness).sum(-2) + acc1
    fresnel_map = torch.full_like(albedo_map, cfg.fixed_fresnel) + acc1
    out.update({
        "rgb_map": linear2srgb(clip(rgb_map + acc1, 0.0, 1.0)),
        "normal_map": safe_l2_normalize(normal_map),
        "albedo_map": clip(albedo_map, 0.0, 1.0),
        "roughness_map": clip(roughness_map, 0.0, 1.0),
        "fresnel_map": clip(fresnel_map, 0.0, 1.0),
        "normals_diff_map": (w1 * normals_diff).sum(-2),
        "normals_orientation_loss_map": (w1 * normals_ori).sum(-2),
        "albedo_smoothness_loss": (w1 * albedo_sm).sum(-2).mean(),
        "roughness_smoothness_loss": (w1 * roughness_sm).sum(-2).mean(),
        "acc_mask": acc_map > 0.5,
    })
    return out
