"""The CP field of the ``armadillo_cp`` configuration, made from ``--seed``
as ``scene.py`` makes the VM field: the lines at ``init_field_params``' CP
distribution (0.2 randn), the basis U(+-1/sqrt(Ra)) over the Ra components
of one product, the light factor randn, the networks and the SG mixture as
``scene.py`` draws them, and a separable bump on component 0 of every
density line, whose product over the three axes is the solid blob.

``derive_field`` is ``scene.derive_field`` with this raw field: the
training run's events (alpha mask, shrink, upsample, mask) through the
lifecycle module it is given, the program's or the reference's.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.harness import scene
from portbench.harness.knobs import AABB
from portbench.reference.models import mlps as ref_mlps

# the lines' scale in init_field_params' CP branch
CP_SCALE = 0.2
# the bump added to component 0 of each density line: its product over the
# three axes peaks at BLOB_LINE_AMP ** 3 (22), with scene.py's sharpness per
# axis: the test view's surface share then reads 0.30-0.31 on the CPU at
# 128^3, where armadillo's reads 0.31
BLOB_LINE_AMP = 2.8


def raw_field(fk: dict, reso, seed: int, device) -> dict:
    """The CP field's parameters at the grid ``reso`` (X, Y, Z), with the
    keys and shapes of ``init_field_params``, drawn on ``device`` from the
    seed's weight stream."""
    if fk["decomp"] != "cp":
        raise ValueError("scene_cp makes TensorCP fields")
    g = scene.generator(seed, scene.WEIGHTS, device)
    dev = device
    p = {}
    for name, ncomp in (("density", fk["density_n_comp"]),
                        ("app", fk["app_n_comp"])):
        for i in range(3):
            p[f"{name}_line_{i}"] = CP_SCALE * torch.randn(
                (reso[scene.VEC_MODE[i]], ncomp[i]), generator=g, device=dev)
    ra = fk["app_n_comp"][0]
    p["basis_mat"] = (torch.rand((ra, fk["app_dim"]), generator=g,
                                 device=dev) * 2.0 - 1.0) / np.sqrt(ra)
    p["light_line"] = torch.randn((1, ra), generator=g, device=dev)
    render_in = ref_mlps.render_fea_in_dim(fk["app_dim"], fk["view_pe"],
                                           fk["fea_pe"])
    brdf_in = ref_mlps.brdf_pe_fea_in_dim(fk["app_dim"], fk["pos_pe"],
                                          fk["fea_pe"])
    h = fk["feature_c"]
    p["render_mlp"] = scene._mlp(g, render_in, h, 3, dev)
    p["brdf_mlp"] = scene._mlp(g, brdf_in, h, 4, dev)
    p["normal_mlp"] = scene._mlp(g, brdf_in, h, 3, dev)
    p["lgt_sgs"] = scene._sgs(g, fk["num_sgs"], dev)
    with torch.no_grad():
        for i in range(3):
            ln = p[f"density_line_{i}"]
            ln[:, 0] += BLOB_LINE_AMP * scene._bump(ln.shape[0], dev)
    return p


def derive_field(lc, fcfg, fk: dict, c: dict, recipe: dict, seed: int,
                 device):
    """(params, scene, n_samples) of the configuration's ``scene`` recipe,
    as ``scene.derive_field`` derives them, from the CP raw field."""
    reso = lc.n_to_reso(recipe["init_voxels"], AABB)
    params = raw_field(fk, reso, seed, device)
    scn = scene.empty_scene(device)
    mask = recipe.get("first_mask_reso") or 0
    mask_reso = (mask,) * 3 if mask else tuple(min(r, 256) for r in reso)
    scn, box = lc.update_alpha_mask(fcfg, params, scn, mask_reso)
    if recipe.get("shrink"):
        params, scn = lc.shrink(fcfg, params, scn, box)
    if recipe.get("final_voxels"):
        reso = lc.n_to_reso(recipe["final_voxels"],
                            scn["aabb"].cpu().numpy())
        params = lc.upsample(params, reso)
        scn, _ = lc.update_alpha_mask(fcfg, params, scn,
                                      tuple(min(r, 256) for r in reso))
    n_samples = recipe.get("n_samples") or min(
        c["nSamples"], lc.cal_n_samples(reso, c["step_ratio"]))
    return params, scn, int(n_samples)
