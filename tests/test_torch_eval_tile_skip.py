"""The eval's skip of secondary-march tiles that hold no used ray
(``secondary_shading_tiled``'s ``ray_used``, handed down by
``render_train_batch`` where every ray of a chunk is relit without a
gradient), on the CPU, on a TensorVM and a TensorCP blob field:

- the pass with ``ray_used`` equals the pass without it bit for bit on
  every tile it marches, gives zeros on the tiles it skips, and skips
  exactly the tiles none of whose pairs belongs to a used ray, also where
  one ray's pairs straddle two tiles;
- an eval chunk over one image row, some of whose tiles hold only
  background rays: every map within 1e-4 of the JAX package's chunk (the
  eval tests' tolerance; JAX's chunk jitted on the VM field, as in
  ``test_torch_eval.py``, and run eagerly on the CP field, whose jitted
  bake differs, as ``test_torch_variants_eval.py`` says) and equal bit for
  bit to the port's chunk marching every tile; a chunk with no surface ray
  marches and bakes nothing and gives the same maps;
- the relight step (a gradient, relit rays capped or not) skips no tile.
"""
import contextlib

import jax
import numpy as np
import pytest
import torch

from tensoir_tpu.render import eval as JE

from tensoir_tpu_torch.models import field as TF
from tensoir_tpu_torch.render import brdf_render as TBR
from tensoir_tpu_torch.render import eval as TE
from tensoir_tpu_torch.render import secondary as TSec
from tensoir_tpu_torch.train import optim as TO
from tensoir_tpu_torch.train import step as TS

from torch_parity import (masked_jax_field, one_torch_thread,  # noqa: F401
                          port_cfg, port_field)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

DECOMPS = ["vm", "cp"]
S, CHUNK, N_SECOND = 48, 24, 16
L = 32                      # the 4 x 8 fixed light directions
MAP_ATOL = 1e-4


@pytest.fixture(scope="module", params=DECOMPS)
def field(request):
    jcfg, jp, js = masked_jax_field(decomp=request.param)
    return jcfg, jp, js


def _row(x0: float, x1: float, n: int = CHUNK) -> np.ndarray:
    """[n, 6] rays of one image row, in order: origins from x0 to x1 at
    z = -4, straight down +z. Across the box the ends miss the blob."""
    r = np.zeros((n, 6), np.float32)
    r[:, 0] = np.linspace(x0, x1, n, dtype=np.float32)
    r[:, 1] = 0.1
    r[:, 2] = -4.0
    r[:, 5] = 1.0
    return r


def _pairs(P: int, seed: int = 1):
    """(surface points [P, 3], light dirs [P, L, 3], light indices [P],
    the cosine mask [P, L]): points in the blob's shell, the dirs of every
    point the same, random normals."""
    g = torch.Generator().manual_seed(seed)
    d = torch.randn(P, 3, generator=g)
    pts = d / d.norm(dim=-1, keepdim=True) * (0.2 + 0.5 * torch.rand(
        P, 1, generator=g))
    dirs = torch.randn(L, 3, generator=g)
    dirs = dirs / dirs.norm(dim=-1, keepdim=True)
    normals = torch.randn(P, 3, generator=g)
    surf2l = dirs[None].expand(P, L, 3).contiguous()
    mask = (surf2l * normals[:, None]).sum(-1) > 1e-6
    return pts, surf2l, torch.zeros(P, dtype=torch.int32), mask


def _want_marched(used: np.ndarray, tile: int) -> np.ndarray:
    """[n_tiles] bool: the tiles holding a pair of a used ray, pair by pair
    (pair p belongs to ray p // L)."""
    n = used.size * L
    n_tiles = -(-n // tile)
    return np.array([used[np.arange(t * tile, min(n, (t + 1) * tile)) // L]
                     .any() for t in range(n_tiles)])


def _check_pass(field, monkeypatch, tile: int, used: np.ndarray) -> None:
    """The pass with ``ray_used`` against the pass without it: each tile
    bit for bit where marched, zeros where skipped; the tiles marched, each
    known by its first pair's point, are those of ``_want_marched``;
    marched and skipped add up to the tiles."""
    jcfg, jp, js = field
    cfg = port_cfg(jcfg)
    tp, ts = port_field(jp, js)
    pairs = _pairs(used.size)
    knobs = TSec.SecondaryKnobs(second_n_sample=N_SECOND, secondary_tile=tile)
    full = TSec.secondary_shading_tiled(cfg, tp, ts, *pairs, knobs)
    firsts, real_tile = [], TSec._tile
    monkeypatch.setattr(TSec, "_tile", lambda cfg, params, scene, pts, *a: (
        firsts.append(pts[0].tolist()),
        real_tile(cfg, params, scene, pts, *a))[1])
    TSec.reset_march_counts()
    got = TSec.secondary_shading_tiled(cfg, tp, ts, *pairs, knobs,
                                       ray_used=torch.as_tensor(used))
    want = _want_marched(used, tile)
    n = used.size * L
    assert 0 < want.sum() < want.size
    assert firsts == [pairs[0][t * tile // L].tolist()
                      for t in np.flatnonzero(want)]
    assert TSec.MARCHED == {
        "pairs": sum(min(tile, n - t * tile) for t in np.flatnonzero(want)),
        "tiles": int(want.sum()), "skipped": int((~want).sum())}
    for g, f in zip(got, full):
        assert g.shape == f.shape and g.dtype == f.dtype
        g, f = g.reshape(n, -1), f.reshape(n, -1)
        for t, marched in enumerate(want):
            sl = slice(t * tile, (t + 1) * tile)
            if marched:
                assert torch.equal(g[sl], f[sl]), t
            else:
                assert not g[sl].any(), t


def test_pass_skips_tiles_of_unused_rays(field, monkeypatch):
    """Tiles of two rays (64 pairs): runs of unused rays skip whole
    tiles, a tile with one used ray is marched."""
    used = np.zeros(24, bool)
    used[[4, 5, 9, 14, 15, 16, 23]] = True
    _check_pass(field, monkeypatch, 2 * L, used)


def test_pass_tiles_straddling_rays(field, monkeypatch):
    """Tiles of 48 pairs, one and a half rays: a ray's pairs straddle two
    tiles, and a tile is skipped only when no pair of it is of a used ray
    (ray 4's pairs straddle tiles 2 and 3, 16 in each, and mark both; ray
    9's lie in tile 6 alone, ray 20's in tile 13)."""
    used = np.zeros(24, bool)
    used[[4, 9, 20]] = True
    want = _want_marched(used, 48)
    assert list(np.flatnonzero(want)) == [2, 3, 6, 13]
    _check_pass(field, monkeypatch, 48, used)


def _chunk_fns(jcfg, tile: int):
    kw = dict(n_samples=S, chunk=CHUNK, second_n_sample=N_SECOND,
              secondary_tile=tile)
    j_fn, _ = JE.make_eval_chunk_fn(jcfg, **kw)
    t_fn, _ = TE.make_eval_chunk_fn(port_cfg(jcfg), **kw)
    return j_fn, t_fn


def _full_march(monkeypatch):
    """The port's chunk marching every tile: ``ray_used`` dropped."""
    real = TBR.secondary_shading_tiled
    monkeypatch.setattr(TBR, "secondary_shading_tiled",
                        lambda *a, ray_used=None: real(*a))


def _render(fn, params, scene, rays):
    return TE.render_image(fn, CHUNK, params, scene, rays,
                           np.zeros((CHUNK, 1), np.int32))


def _assert_same(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k


def test_eval_chunk_skips_background_tiles(field, monkeypatch):
    """One image row across the blob in tiles of two rays: the chunk
    marches only the tiles with a surface ray, its maps within 1e-4 of
    JAX's and bit for bit those of marching every tile."""
    jcfg, jp, js = field
    tp, ts = port_field(jp, js)
    rays = _row(-1.4, 1.4)
    j_fn, t_fn = _chunk_fns(jcfg, 2 * L)
    with (jax.disable_jit() if jcfg.decomp == "cp"
          else contextlib.nullcontext()):
        j_out = JE.render_image(j_fn, CHUNK, jp, js, rays,
                                np.zeros((CHUNK, 1), np.int32))
    TSec.reset_march_counts()
    got = _render(t_fn, tp, ts, rays)
    want = _want_marched(got["acc_mask"].reshape(-1), 2 * L)
    assert 0 < want.sum() < want.size
    assert TSec.MARCHED["tiles"] == want.sum()
    assert TSec.MARCHED["skipped"] == (~want).sum()
    assert set(got) == set(j_out)
    for k, jv in j_out.items():
        d = np.abs(got[k].astype(np.float64) - jv.astype(np.float64)).max()
        assert d <= MAP_ATOL, (k, d)
    _full_march(monkeypatch)
    TSec.reset_march_counts()
    _assert_same(got, _render(t_fn, tp, ts, rays))
    assert TSec.MARCHED == {"pairs": CHUNK * L, "tiles": want.size,
                            "skipped": 0}


def test_eval_chunk_without_surface_ray_marches_nothing(field, monkeypatch):
    """A row that misses the blob: no tile marched, no bake, every tile
    skipped, and the maps of marching every tile."""
    jcfg, jp, js = field
    tp, ts = port_field(jp, js)
    rays = _row(1.25, 1.45)
    _, t_fn = _chunk_fns(jcfg, 2 * L)
    bakes = []
    real_bake = TF.bake_packed_sigma_grid
    monkeypatch.setattr(TF, "bake_packed_sigma_grid", lambda *a, **k: (
        bakes.append(1), real_bake(*a, **k))[1])
    TSec.reset_march_counts()
    got = _render(t_fn, tp, ts, rays)
    assert not got["acc_mask"].any()
    assert TSec.MARCHED == {"pairs": 0, "tiles": 0,
                            "skipped": CHUNK * L // (2 * L)}
    assert bakes == []
    _full_march(monkeypatch)
    _assert_same(got, _render(t_fn, tp, ts, rays))
    assert bakes == [1]


@pytest.mark.parametrize("cap", [8, 0], ids=["capped", "all_rays"])
def test_relight_step_skips_no_tile(field, cap):
    """The relight step on the image row: with the relit rays capped (8 of
    24, surface rays first) and with every ray relit, it marches every
    tile of its relit rays and skips none, though the eval skips some of
    the same rays' tiles."""
    jcfg, jp, js = field
    tp, ts = port_field(jp, js)
    tile = 2 * L
    st = TS.StepStatic(n_samples=S, is_relight=True, white_bg=True,
                       relight_ray_cap=cap, second_n_sample=N_SECOND,
                       secondary_tile=tile, deterministic=True)
    w = TS.LossWeights(n_iters=80000, relight_start=10000)
    opt = TO.make_optimizer(tp, 0.02, 1e-3, 0.999971)
    step = TS.make_train_step(port_cfg(jcfg), opt, st, w, device="cpu")
    batch = {"rays": _row(-1.4, 1.4),
             "rgbs": np.full((CHUNK, 3), 0.5, np.float32),
             "light_idx": np.zeros((CHUNK,), np.int32)}
    TSec.reset_march_counts()
    _, _, metrics = step(tp, opt.init(tp), ts, batch, None, 10000)
    relit = cap or CHUNK
    assert np.isfinite(float(metrics["total_loss"]))
    assert TSec.MARCHED == {"pairs": relit * L, "tiles": relit * L // tile,
                            "skipped": 0}
