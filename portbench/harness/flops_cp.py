"""The CP field's arithmetic per point, in ``flops.py``'s conventions (a
multiply or an add is one operation; index work is not counted), and the
eval chunk's count built on it.

A CP factor set has R components, each the product of one value of each of
three lines. Per point and component:
- a line lookup, two taps: 2 multiplies, 1 add and the weight's complement,
  4 operations, on each of the three lines: 12;
- the three-way product: 2;
- density: the sum over the components, 1, so 15 R;
- appearance: the light factor's multiply, 1, so 15 Ra, and the basis
  product 2 Ra app_dim.
This is the model's work. The port makes each lookup a product of a dense
two-tap matrix [N, D] with the line (2 N D R operations, counted by
``LINE_MATRIX``), about D / 2 times these 12 R a point: ``mfu.render``
shows that waste.
"""
from __future__ import annotations

from portbench.harness import flops

LOOKUP = 4          # one two-tap line lookup of one component
PRODUCT = 2         # the product of the three axes' values


def widths(fk: dict) -> dict:
    """``flops.widths`` with the CP field's density and appearance."""
    r, ra = fk["density_n_comp"][0], fk["app_n_comp"][0]
    w = flops.widths(fk)
    w["density"] = (3 * LOOKUP + PRODUCT + 1) * r
    w["app"] = (3 * LOOKUP + PRODUCT + 1) * ra + 2 * ra * fk["app_dim"]
    return w


def eval_chunk(fk: dict, rays: int, hits: int, *, march_cap: int,
               app_cap: int, light_dirs: int, second_n_sample: int,
               second_app_cap: int) -> float:
    """``flops.eval_chunk`` of the CP field: the primary pass at its caps,
    the ``hits`` surface rays relit under the fixed light directions, the
    full baked secondary march, and the exact CP colour at
    ``second_app_cap`` samples a pair."""
    w = widths(fk)
    pairs = hits * light_dirs
    return (flops.primary(w, rays, march_cap, app_cap)
            + pairs * (w["sg_light"] + flops.BRDF_PER_PAIR)
            + flops.secondary(w, marched=pairs, samples=second_n_sample,
                              exact=False, app_points=pairs * second_app_cap,
                              app_baked=False))
