"""The model's arithmetic per step or chunk, from the configuration's widths
and the work the inputs need, as far as the harness sees it in the
outputs: the surface rays (acc over 0.5) of each step or chunk, and of
them the rays relit (at most ``relight_ray_cap`` in a step). Only surface
rays count towards the light directions, the BRDF and the secondary march;
the primary march still counts at its caps (``march_cap`` samples a ray,
``app_cap`` of them shaded), and the secondary colour at ``second_app_cap``
samples a pair, since the program reports no kept-sample counts. Index work
(gathers, selections, sorts) is not counted. A forward with gradients counts
three times (the backward as twice the forward); the secondary pass, the
eval and relighting run without gradients and count once.

Per point, with R the components of a VM factor set and Ra the app ones:
- density: 3 planes x (bilinear 4 corners + linear 2 corners + product and
  sum) = 14 sum(R) operations;
- appearance: 14 sum(Ra) + the basis matmul 2 sum(Ra) app_dim;
- an MLP of widths (in, h, h, out): 2 (in h + h h + h out);
- derived normals: the density's gradient, twice the density;
- a baked sigma lookup: 8 bf16 corners, 16; a baked app lookup: 8 corners
  of app_dim, 16 app_dim.
Per (surface point, light direction) pair: the SG light, 13 per lobe; the
GGX specular and the rendering sum, 60.
"""
from __future__ import annotations

from portbench.reference.models import mlps as ref_mlps

BRDF_PER_PAIR = 60
SG_PER_LOBE = 13


def _mlp(fi: int, h: int, fo: int) -> int:
    return 2 * (fi * h + h * h + h * fo)


def widths(fk: dict) -> dict:
    dens = 14 * sum(fk["density_n_comp"])
    ra = sum(fk["app_n_comp"])
    h = fk["feature_c"]
    render_in = ref_mlps.render_fea_in_dim(fk["app_dim"], fk["view_pe"],
                                           fk["fea_pe"])
    brdf_in = ref_mlps.brdf_pe_fea_in_dim(fk["app_dim"], fk["pos_pe"],
                                          fk["fea_pe"])
    return {"density": dens,
            "app": 14 * ra + 2 * ra * fk["app_dim"],
            "app_baked": 16 * fk["app_dim"],
            "render_mlp": _mlp(render_in, h, 3),
            "brdf_mlp": _mlp(brdf_in, h, 4),
            "normal_mlp": _mlp(brdf_in, h, 3),
            "sg_light": SG_PER_LOBE * fk["num_sgs"]}


def primary(w: dict, rays: int, march_cap: int, app_cap: int) -> float:
    """Density at ``march_cap`` samples a ray; appearance, the three MLPs
    and the derived normals at its ``app_cap`` top samples."""
    per_app = (w["app"] + w["render_mlp"] + w["brdf_mlp"] + w["normal_mlp"]
               + 2 * w["density"])
    return rays * (march_cap * w["density"] + app_cap * per_app)


def secondary(w: dict, *, marched: int, samples: int, exact: bool,
              app_points: int, app_baked: bool) -> float:
    """``marched`` secondary rays of ``samples`` lookups each (exact VM
    density or the baked grid), and the radiance field's colour at
    ``app_points`` selected samples."""
    look = w["density"] if exact else 16
    app = (w["app_baked"] if app_baked else w["app"]) + w["render_mlp"]
    return marched * samples * look + app_points * app


def relight_step(fk: dict, c: dict, batch: int, relit: int) -> float:
    """One training step of the relight phase that relit ``relit`` rays
    under every light direction."""
    w = widths(fk)
    pairs = relit * c["envmap_h"] * c["envmap_w"]
    window = c["second_window"]
    samples = (window if 0 < window < c["second_nSample"]
               else c["second_nSample"])
    grad = (primary(w, batch, c["march_cap_primary"], c["app_cap_per_ray"])
            + pairs * (w["sg_light"] + BRDF_PER_PAIR))
    return 3 * grad + secondary(
        w, marched=pairs, samples=samples,
        exact=not c["secondary_use_baked"],
        app_points=pairs * c["second_app_cap"],
        app_baked=c["app_bake_reso"] > 0)


def eval_chunk(fk: dict, rays: int, hits: int, *, march_cap: int,
               app_cap: int, light_dirs: int, second_n_sample: int,
               second_app_cap: int) -> float:
    """One eval chunk of ``rays`` rays, ``hits`` of them on the surface,
    each relit under the fixed light directions by the full baked secondary
    march."""
    w = widths(fk)
    pairs = hits * light_dirs
    return (primary(w, rays, march_cap, app_cap)
            + pairs * (w["sg_light"] + BRDF_PER_PAIR)
            + secondary(w, marched=pairs, samples=second_n_sample,
                        exact=False, app_points=pairs * second_app_cap,
                        app_baked=False))


def relight_chunk(fk: dict, rays: int, hits: int, *, march_cap: int,
                  app_cap: int, light_samples: int, vis_march_cap: int
                  ) -> float:
    """One relight chunk of ``rays`` rays under one light: the primary pass,
    and for each of the ``hits`` surface rays the exact visibility march of
    every light sample on ``vis_march_cap`` samples, the BRDF and the
    sum."""
    w = widths(fk)
    pairs = hits * light_samples
    return (primary(w, rays, march_cap, app_cap) + pairs * BRDF_PER_PAIR
            + secondary(w, marched=pairs, samples=vis_march_cap, exact=True,
                        app_points=0, app_baked=False))
