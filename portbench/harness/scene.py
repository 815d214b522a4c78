"""What the benchmark makes from ``--seed`` and hands to both sides: the
raw field (random VM factors and networks plus the solid blob), the cameras
and their rays; and, from a traffic's fixed key, the held-out environment
maps. Everything is made on the run's device from one ``torch.Generator``
there, in a few large calls.

``derive_field`` then takes the raw field through the training run's
events (alpha mask, shrink, upsample) with the lifecycle module it is
given: the program's for the timed path, the reference's for the check.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.harness.knobs import AABB
from portbench.reference.models import lighting as ref_lighting
from portbench.reference.models import mlps as ref_mlps

MAT_MODE = ((0, 1), (0, 2), (1, 2))
VEC_MODE = (2, 1, 0)
# solid blob of utils/bench_scene.py: amplitude and sharpness
BLOB_AMP, BLOB_SHARP = 8.0, 0.10
# the streams of ``generator``: one per purpose
WEIGHTS, POOL_ORDER, STEP_DRAWS, LIGHT_DRAWS, MAPS = 1, 2, 3, 4, 5


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one purpose (``stream``) of a run, so
    that the weights, the rays and the draws of a step do not depend on
    each other's sizes. Seeds of any size are folded into 63 bits."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1000003 + stream) % (2 ** 63 - 1))


def _bump(n: int, device) -> torch.Tensor:
    z = torch.linspace(-1.0, 1.0, n, device=device, dtype=torch.float64)
    return torch.exp(-(z ** 2) / BLOB_SHARP).float()


def raw_field(fk: dict, reso, seed: int, device) -> dict:
    """The VM field's parameters at the grid ``reso`` (X, Y, Z), with the
    keys, shapes and distributions of ``init_field_params`` (factors 0.1 *
    randn, basis U(+-1/sqrt(sum of app components)), light factor randn,
    the MLPs' uniform fan-in init, the SG mixture), drawn on ``device``,
    and the solid blob added to component 0 of every density plane and
    line."""
    if fk["decomp"] != "vm":
        raise ValueError("the benchmark's configurations are TensorVMSplit")
    g = generator(seed, WEIGHTS, device)
    dev = device
    p = {}
    for name, ncomp in (("density", fk["density_n_comp"]),
                        ("app", fk["app_n_comp"])):
        for i in range(3):
            m0, m1 = MAT_MODE[i]
            p[f"{name}_plane_{i}"] = 0.1 * torch.randn(
                (reso[m1], reso[m0], ncomp[i]), generator=g, device=dev)
            p[f"{name}_line_{i}"] = 0.1 * torch.randn(
                (reso[VEC_MODE[i]], ncomp[i]), generator=g, device=dev)
    sum_ra = sum(fk["app_n_comp"])
    p["basis_mat"] = (torch.rand((sum_ra, fk["app_dim"]), generator=g,
                                 device=dev) * 2.0 - 1.0) / np.sqrt(sum_ra)
    p["light_line"] = torch.randn((1, sum_ra), generator=g, device=dev)
    render_in = ref_mlps.render_fea_in_dim(fk["app_dim"], fk["view_pe"],
                                           fk["fea_pe"])
    brdf_in = ref_mlps.brdf_pe_fea_in_dim(fk["app_dim"], fk["pos_pe"],
                                          fk["fea_pe"])
    h = fk["feature_c"]
    p["render_mlp"] = _mlp(g, render_in, h, 3, dev)
    p["brdf_mlp"] = _mlp(g, brdf_in, h, 4, dev)
    p["normal_mlp"] = _mlp(g, brdf_in, h, 3, dev)
    p["lgt_sgs"] = _sgs(g, fk["num_sgs"], dev)
    with torch.no_grad():
        for i in range(3):
            pl = p[f"density_plane_{i}"]
            bump2 = torch.outer(_bump(pl.shape[0], dev), _bump(pl.shape[1],
                                                                dev))
            pl[..., 0] += BLOB_AMP * bump2
            ln = p[f"density_line_{i}"]
            ln[:, 0] += _bump(ln.shape[0], dev)
    return p


def _mlp(g, fi0: int, h: int, out: int, dev) -> dict:
    """``mlps.init_mlp``: three layers, U(+-1/sqrt(fan in)), last bias 0."""
    m = {}

    def uniform(shape, bound):
        return (torch.rand(shape, generator=g, device=dev) * 2 - 1) * bound

    for i, (fi, fo) in enumerate(((fi0, h), (h, h), (h, out)), start=1):
        b = 1.0 / fi ** 0.5
        m[f"w{i}"] = uniform((fi, fo), b)
        m[f"b{i}"] = (torch.zeros(fo, device=dev) if i == 3
                      else uniform((fo,), b))
    return m


def _sgs(g, m: int, dev) -> torch.Tensor:
    """``lighting.init_sg_params``: Fibonacci lobes (both halves), lambda in
    [10, inf), mu scaled to a total energy of 2 pi 0.8."""
    sgs = torch.randn((m, 7), generator=g, device=dev)
    sgs[:, -2:] = sgs[:, -3:-2].expand(m, 2)
    sgs[:, 3:4] = 10.0 + (sgs[:, 3:4] * 20.0).abs()
    energy = ref_lighting.sg_energy(sgs)
    sgs[:, 4:] = (sgs[:, 4:].abs() / energy.sum(0, keepdim=True)
                  * 2.0 * np.pi * 0.8)
    lobes = torch.from_numpy(ref_lighting.fibonacci_sphere(m // 2)).to(dev)
    sgs[: m // 2, :3] = lobes
    sgs[m // 2:, :3] = lobes
    return sgs


def empty_scene(device) -> dict:
    """``init_field_params``' scene: the permissive 2^3 alpha mask."""
    aabb = torch.as_tensor(AABB, device=device)
    return {"aabb": aabb.clone(),
            "alpha_volume": torch.ones((2, 2, 2), device=device),
            "alpha_volume_dilated": torch.ones((2, 2, 2), dtype=torch.uint8,
                                               device=device),
            "alpha_volume_packed": torch.ones((1, 1, 1, 8),
                                              dtype=torch.bfloat16,
                                              device=device),
            "alpha_aabb": aabb.clone(),
            "has_alpha_mask": torch.tensor(0.0, device=device)}


def derive_field(lc, fcfg, fk: dict, c: dict, recipe: dict, seed: int,
                 device):
    """(params, scene, n_samples) of the configuration's ``scene`` recipe,
    through the lifecycle module ``lc`` (``update_alpha_mask``, ``shrink``,
    ``upsample``, ``n_to_reso``, ``cal_n_samples``), as ``train/loop.py``
    runs them: the raw field at ``init_voxels`` on the scene box; the alpha
    mask at ``first_mask_reso`` (0: the grid, at most 256 a side); with
    ``shrink`` the box cut to the mask; with ``final_voxels`` the upsample
    to that count and the mask again at the new grid."""
    reso = lc.n_to_reso(recipe["init_voxels"], AABB)
    params = raw_field(fk, reso, seed, device)
    scene = empty_scene(device)
    mask = recipe.get("first_mask_reso") or 0
    mask_reso = (mask,) * 3 if mask else tuple(min(r, 256) for r in reso)
    scene, box = lc.update_alpha_mask(fcfg, params, scene, mask_reso)
    if recipe.get("shrink"):
        params, scene = lc.shrink(fcfg, params, scene, box)
    if recipe.get("final_voxels"):
        reso = lc.n_to_reso(recipe["final_voxels"],
                            scene["aabb"].cpu().numpy())
        params = lc.upsample(params, reso)
        scene, _ = lc.update_alpha_mask(fcfg, params, scene,
                                        tuple(min(r, 256) for r in reso))
    n_samples = recipe.get("n_samples") or min(
        c["nSamples"], lc.cal_n_samples(reso, c["step_ratio"]))
    return params, scene, int(n_samples)


def _look_at(dirs: torch.Tensor, radius: float) -> tuple:
    """(origins [V, 3], camera-to-world rotations [V, 3, 3]) of cameras at
    ``radius`` along ``dirs`` looking at the origin, z up (Blender's
    camera: it looks down its own -z)."""
    o = dirs * radius
    back = dirs / dirs.norm(dim=-1, keepdim=True)            # camera +z
    up = torch.tensor([0.0, 0.0, 1.0], device=dirs.device).expand_as(back)
    right = torch.linalg.cross(up, back)
    right = right / right.norm(dim=-1, keepdim=True)
    cam_up = torch.linalg.cross(back, right)
    return o, torch.stack([right, cam_up, back], -1)


def camera_dirs(n: int, elev_min: float, device) -> torch.Tensor:
    """``n`` fixed directions on the sphere's cap above elevation
    ``elev_min`` (radians), in a Fibonacci spiral: the same poses for
    every seed."""
    k = torch.arange(n, device=device, dtype=torch.float64) + 0.5
    zmin = np.sin(elev_min)
    z = zmin + (1.0 - zmin) * k / n
    phi = k * np.pi * (3.0 - np.sqrt(5.0))
    r = torch.sqrt(1.0 - z ** 2)
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1).float()


def view_rays(dirs: torch.Tensor, wh: int, radius: float, angle_x: float
              ) -> torch.Tensor:
    """[V * wh * wh, 6] rays (origin, unit direction) through the pixel
    centres of each camera, rows in image order, as data/ray_utils.py
    makes them for the synthetic scenes."""
    dev = dirs.device
    focal = 0.5 * wh / np.tan(0.5 * angle_x)
    j, i = torch.meshgrid(torch.arange(wh, device=dev, dtype=torch.float32),
                          torch.arange(wh, device=dev, dtype=torch.float32),
                          indexing="ij")
    cam = torch.stack([(i + 0.5 - 0.5 * wh) / focal,
                       -(j + 0.5 - 0.5 * wh) / focal,
                       -torch.ones_like(i)], -1).reshape(-1, 3)
    o, rot = _look_at(dirs, radius)
    d = torch.einsum("vab,nb->vna", rot, cam)
    d = d / d.norm(dim=-1, keepdim=True)
    o = o[:, None, :].expand_as(d)
    return torch.cat([o, d], -1).reshape(-1, 6)


def ray_colours(rays: torch.Tensor) -> torch.Tensor:
    """A smooth target colour per ray, from its direction."""
    return (0.5 + 0.35 * torch.sin(3.0 * rays[:, 3:6] + 1.0)).clamp(0, 1)


def env_maps(n: int, h: int, w: int, key: int, device) -> list:
    """``n`` HDR lat-long maps [h, w, 3] (numpy float32): a sky gradient
    of a random tint and a few sharp random suns on a floor of light,
    drawn from ``key`` alone (a traffic's ``work_key``, not a run's seed)."""
    g = generator(key, MAPS, device)
    theta = torch.linspace(0, np.pi, h, device=device)[:, None, None]
    phi = torch.linspace(-np.pi, np.pi, w, device=device)[None, :, None]
    dirs = torch.cat([torch.sin(theta) * torch.cos(phi),
                      torch.sin(theta) * torch.sin(phi),
                      torch.cos(theta).expand(h, w, 1)], -1)
    out = []
    for _ in range(n):
        tint = 0.3 + 0.7 * torch.rand((3,), generator=g, device=device)
        sky = 0.05 + 0.6 * tint * (0.5 + 0.5 * dirs[..., 2:3])
        suns = torch.randn((3, 3), generator=g, device=device)
        suns = suns / suns.norm(dim=-1, keepdim=True)
        power = 20.0 + 80.0 * torch.rand((3, 1), generator=g, device=device)
        cos = torch.einsum("hwc,sc->hws", dirs, suns)
        sky = sky + (torch.exp(200.0 * (cos - 1.0))[..., None]
                     * power[None, None, :, :]).sum(2) * tint
        out.append(sky.float().cpu().numpy())
    return out
