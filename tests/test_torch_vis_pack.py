"""The relight chunk marches only its kept (point, light sample) pairs,
packed into full visibility tiles: on the CPU at tiny widths, its eight
outputs equal bit for bit those of the benchmark's frozen dense chunk
(``portbench/reference/render/chunks.py``), which marches every pair and
multiplies by the mask, on the same raw field, map and draws, on the exact
and the ``fast_vis`` routes: a mixed chunk, an all-background chunk (no
tile marched), and kept counts of exactly one tile and of one tile plus
one. The packing step alone with every pair kept, and the counters
``VIS_PACK`` and ``MARCHED``.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.harness import knobs  # noqa: E402
from portbench.harness import scene as bscene  # noqa: E402
from portbench.paths import eval_chunk, relight_chunk  # noqa: E402
from portbench.tests import tiny  # noqa: E402
from tensoir_tpu_torch.render import relight_pipeline as TRP  # noqa: E402
from tensoir_tpu_torch.render import secondary as TSec  # noqa: E402

FAST = TSec.FAST_MARCH_KNOBS

SEED = 2 ** 31 + 11
B, L, SEC_N, TILE = 32, 16, 96, 64
LIGHT = "held_out_0"
ROUTES = [False, True]


@pytest.fixture(scope="module")
def sides():
    """The program's and the reference's relight pieces on the benchmark's
    tiny armadillo field: modules, field config, params, scene, samples a
    ray, environment light and the fast route's bakes."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    _, conf, traffic = tiny.cell("armadillo.relight_view")
    c = conf["config"]
    fk = knobs.field_kwargs(c)
    out = {}
    for ref in (False, True):
        field, lc, rp, env_cls = relight_chunk._mods(ref)
        fcfg = field.FieldConfig(**fk)
        params, scn, n = bscene.derive_field(lc, fcfg, fk, c, conf["scene"],
                                             SEED, "cpu")
        env = env_cls(device="cpu") if ref else env_cls(None, device="cpu")
        h, w = traffic["env_hw"]
        env.add_light(LIGHT, bscene.env_maps(1, h, w, SEED, "cpu")[0])
        with torch.no_grad():
            baked = field.bake_packed_sigma_grid(
                fcfg, params, scn, max_reso=FAST["secondary_bake_reso"])
            bakes = (baked, field.bake_coarse_occupancy(
                baked, dilate=FAST["coarse_dilate"]))
        out[ref] = dict(rp=rp, cfg=fcfg, params=params, scene=scn, n=n,
                        env=env, bakes=bakes)
    out["rays"] = eval_chunk.test_view_rays(traffic, "cpu")
    yield out
    torch.set_num_threads(n_threads)


def _draws(seed=3):
    return np.random.default_rng(seed).random((B, L), dtype=np.float32)


def _mixed_rays(s):
    """B rays across the middle of the view: some hit the object, some
    miss it."""
    rays = s["rays"]
    start = (rays.shape[0] - B) // 2
    return rays[start:start + B]


def _background_rays(s):
    """B rays from the camera pointing away from the object."""
    rays = _mixed_rays(s).clone()
    rays[:, 3:6] = -rays[:, 3:6]
    return rays


def _chunk(s, ref, rays, fast_vis, vis_tile, draws):
    side = s[ref]
    fn = side["rp"].make_relight_chunk_fn(
        side["cfg"], side["env"], LIGHT, n_samples=side["n"],
        n_light_samples=L, second_n_sample=SEC_N, vis_tile=vis_tile,
        fast_vis=fast_vis)
    return fn(side["params"], side["scene"], rays, None,
              torch.ones((3,)), draws=draws,
              vis_bakes=side["bakes"] if fast_vis else None)


def _kept(s, outs, draws):
    """Pairs on the surface (acc > 0.5) and above its horizon (cosine >
    1e-6), counted from the chunk's acc and normal and the draws'
    directions."""
    acc, normal = outs[2], outs[5]
    surf2l, _, _ = s[False]["env"].sample_light(LIGHT, B, L, draws=draws)
    cosine = torch.einsum("plk,pk->pl", surf2l, normal).clamp_min(0.0)
    return int(((cosine > 1e-6) & (acc > 0.5)[:, None]).sum())


def _assert_equal(got, want):
    assert len(got) == len(want) == 8
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and a.dtype == b.dtype, i
        assert torch.equal(a, b), (i, (a - b).abs().max().item())


@pytest.mark.parametrize("case", ["mixed", "background", "kept_is_tile",
                                  "kept_is_tile_plus_one"])
@pytest.mark.parametrize("fast_vis", ROUTES, ids=["exact", "fast"])
def test_chunk_equals_the_dense_reference(sides, fast_vis, case):
    s, draws = sides, _draws()
    rays = _background_rays(s) if case == "background" else _mixed_rays(s)
    vis_tile = TILE
    if case.startswith("kept_is_tile"):
        kept = _kept(s, _chunk(s, True, rays, fast_vis, TILE, draws), draws)
        vis_tile = kept if case == "kept_is_tile" else kept - 1
    want = _chunk(s, True, rays, fast_vis, vis_tile, draws)
    TSec.reset_march_counts()
    TRP.reset_vis_pack_counts()
    got = _chunk(s, False, rays, fast_vis, vis_tile, draws)
    _assert_equal(got, want)
    kept = _kept(s, want, draws)
    assert TRP.VIS_PACK == {"offered": B * L, "kept": kept}
    assert TSec.MARCHED == {"pairs": kept, "tiles": -(-kept // vis_tile),
                            "skipped": 0}
    acc = want[2]
    if case == "background":
        assert kept == 0 and (acc <= 0.5).all()
    else:
        assert 0 < kept < B * L and (acc > 0.5).any() and (acc <= 0.5).any()
        assert (want[0][acc > 0.5] < 0.99).any()   # a relit surface
    if case == "kept_is_tile":
        assert TSec.MARCHED["tiles"] == 1
    if case == "kept_is_tile_plus_one":
        assert TSec.MARCHED["tiles"] == 2


@pytest.mark.parametrize("fast_vis", ROUTES, ids=["exact", "fast"])
def test_every_pair_kept_packs_the_dense_tiles(sides, fast_vis):
    """With every pair kept, the packing step gives each pair the
    transmittance the reference's dense tile loop gives it."""
    s = sides
    g = torch.Generator().manual_seed(7)
    n_pts, n_dirs = 20, 13        # 260 pairs: 4 full tiles and a padded one
    rays = _mixed_rays(s)[:n_pts]
    pts = rays[:, :3] + 4.0 * rays[:, 3:6]
    dirs = torch.nn.functional.normalize(
        torch.randn((n_pts, n_dirs, 3), generator=g), dim=-1)
    keep = torch.ones((n_pts, n_dirs), dtype=torch.bool)

    def marcher(ref):
        side = s[ref]
        baked, coarse = side["bakes"] if fast_vis else (None, None)
        sec = side["rp"].secondary

        def march(p, d):
            return sec.compute_transmittance(
                side["cfg"], side["params"], side["scene"], p, d,
                n_sample=SEC_N, vis_near=0.05, vis_far=1.5, march_cap=48,
                baked=baked, coarse=coarse,
                window=FAST["second_window"] if fast_vis else 0,
                window_back=FAST["second_window_back"],
                prepass_n=FAST["second_prepass_n"])[0]
        return march

    # the reference's loop: every pair in index order, the last tile padded
    n = n_pts * n_dirs
    n_tiles = -(-n // TILE)
    pad = n_tiles * TILE - n
    flat_p = torch.cat([pts[:, None, :].expand(n_pts, n_dirs, 3)
                        .reshape(-1, 3), torch.zeros((pad, 3))])
    flat_d = torch.cat([dirs.reshape(-1, 3), torch.ones((pad, 3))])
    ref_march = marcher(True)
    want = torch.cat([ref_march(flat_p[t:t + TILE], flat_d[t:t + TILE])
                      for t in range(0, n_tiles * TILE, TILE)])[:n]
    TSec.reset_march_counts()
    TRP.reset_vis_pack_counts()
    got = TRP.visibility_of_kept_pairs(marcher(False), pts, dirs, keep,
                                       TILE)
    assert got.shape == (n_pts, n_dirs)
    assert torch.equal(got.reshape(-1), want)
    assert TRP.VIS_PACK == {"offered": n, "kept": n}
    assert TSec.MARCHED == {"pairs": n, "tiles": n_tiles, "skipped": 0}
    assert (want < 0.5).any() and (want > 0.5).any()   # some occluded


def test_counts_add_up_over_calls(sides):
    """``VIS_PACK`` and ``MARCHED`` sum over chunk calls (a mixed chunk and
    a background one) and reset to zero."""
    s, draws = sides, _draws(5)
    TSec.reset_march_counts()
    TRP.reset_vis_pack_counts()
    outs = _chunk(s, False, _mixed_rays(s), False, TILE, draws)
    _chunk(s, False, _background_rays(s), False, TILE, draws)
    kept = _kept(s, outs, draws)
    assert TRP.VIS_PACK == {"offered": 2 * B * L, "kept": kept}
    assert TSec.MARCHED == {"pairs": kept, "tiles": -(-kept // TILE),
                            "skipped": 0}
    TRP.reset_vis_pack_counts()
    assert TRP.VIS_PACK == {"offered": 0, "kept": 0}
