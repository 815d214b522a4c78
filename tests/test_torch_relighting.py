"""The port's relighting against the JAX package's, on the CPU: the
lat-long lookups, the held-out environment lights, the light kinds
``pixel`` and ``gt``, the visibility march, the relight chunk, the whole
benchmark on a relighting test set on disk (read by each package's own
loader), the analytic ground truth, material editing, and the scripts.

The field is JAX's (blob seeded, masked by its ``update_alpha_mask``),
carried over as numpy. JAX runs jitted where its callers jit (the chunk,
the march, the lookups of the renderer); three chunk functions are
compiled, shared between the chunk test and the benchmark.

Tolerances:
- ``bilerp_plane``: 1e-6 absolute on values of order 1;
- the lat-long lookups (``latlong_lookup``, ``get_light``,
  ``get_light_rgbs``): 1e-6 of the map's largest value, plus what one ulp
  of phi moves a lookup (``_lookup_atol``). The port multiplies by JAX's
  f32 reciprocal of pi, so the longitude is JAX's bit for bit; XLA's
  arccos is its own approximation and differs from torch's by up to one
  ulp (2.4e-7 at phi ~ 2), which moved a lookup on an 8 x 16 map of values
  up to 5 by 4.1e-6;
- ``EnvironmentLight``: every table equal, and the draws from JAX's
  uniforms equal (same texels, same directions, colours and pdfs);
- the march (``compute_transmittance``) and ``render_with_brdf``: 2e-5
  relative and 2e-6 absolute, as the secondary pass's tests;
- the relight chunk: every output within 1e-4 absolute, on the same
  uniforms and, with ``fast_vis``, the same bake;
- the benchmark: PSNR within 0.01 dB, SSIM within 1e-4, every PNG within
  one level, the same artifact tree (JAX writes a video file where the
  port writes a folder of frames);
- ``render_env_gt``: 1e-5 (the sRGB curve of values JAX computes eagerly).
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tensoir_tpu.data import get_dataset as j_get
from tensoir_tpu.data import synthetic as JSyn
from tensoir_tpu.models import env_light as JEnv
from tensoir_tpu.models import lifecycle as JLC
from tensoir_tpu.models import lighting as JL
from tensoir_tpu.ops.interp import bilerp_plane as j_bilerp
from tensoir_tpu.render import relight_pipeline as JRP
from tensoir_tpu.render.brdf_render import render_with_brdf as _j_brdf
from tensoir_tpu.render.secondary import compute_transmittance as _j_trans
from tensoir_tpu.models import field as JF

from tensoir_tpu_torch.data import get_dataset as t_get
from tensoir_tpu_torch.data import synthetic as TSyn
from tensoir_tpu_torch.data.hdr import write_hdr
from tensoir_tpu_torch.kernels import LAUNCHES, reset_launch_counts
from tensoir_tpu_torch.models import env_light as TEnv
from tensoir_tpu_torch.models import lighting as TL
from tensoir_tpu_torch.ops.interp import bilerp_plane as t_bilerp
from tensoir_tpu_torch.render import relight_pipeline as TRP
from tensoir_tpu_torch.render import secondary as TSec
from tensoir_tpu_torch.render.brdf_render import render_with_brdf as t_brdf
from tensoir_tpu_torch.utils.ckpt import save_checkpoint
from tensoir_tpu_torch.utils.png import read_png
from tensoir_tpu_torch.utils.video import write_videos

from torch_parity import (jax_field, one_torch_thread, port_cfg,  # noqa: F401
                          port_field, small_cfg, t)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

LOOKUP_ATOL = 1e-6
MARCH = dict(rtol=2e-5, atol=2e-6)
CHUNK_ATOL = 1e-4
GRID = (24, 20, 16)
LIGHTS = ("bridge", "city")
# the relight chunk at test size: 64 rays x 32 light samples in tiles of
# 512 pairs, 96 secondary samples (the window needs more than its 48)
N_SAMPLES, CHUNK, N_LIGHT, VIS_TILE, SEC_N = 96, 64, 32, 512, 96
RESCALE = np.array([1.1, 0.9, 1.0], np.float32)
SEED = 20211202


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The masked JAX field and its port copy, and a relighting test set
    on disk (the shadow scene, two 12 x 12 views, probes of 16 x 32)
    with both packages' loaders and environment lights."""
    root = tmp_path_factory.mktemp("relight")
    scene_dir, hdr_dir = str(root / "scene"), str(root / "hdr")
    TSyn.write_relight_test_scene(scene_dir, hdr_dir, lights=LIGHTS,
                                  n_views=2, size=12, env_hw=(16, 32),
                                  gt_env_hw=(8, 16))
    jcfg = small_cfg(envmap_h=4, envmap_w=8)
    jp, js = jax_field(jcfg, grid=GRID)
    js, _ = JLC.update_alpha_mask(jcfg, jp, js, GRID)
    tp, ts = port_field(jp, js)
    kw = dict(split="test", light_names=LIGHTS)
    return dict(root=root, scene=scene_dir, hdr=hdr_dir, jcfg=jcfg,
                tcfg=port_cfg(jcfg), jp=jp, js=js, tp=tp, ts=ts,
                jds=j_get("tensoIR_relighting_test")(scene_dir, hdr_dir, **kw),
                tds=t_get("tensoIR_relighting_test")(scene_dir, hdr_dir, **kw),
                jenv=JEnv.EnvironmentLight(hdr_dir),
                tenv=TEnv.EnvironmentLight(hdr_dir, device="cpu"))


# ------------------------------------------------------------- lookups

def _plane_coords(n=400, seed=0):
    """Coordinates over and just past [-1, 1]: random, on the edges, at
    the corners, and a little outside."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.05, 1.05, n)
    y = rng.uniform(-1.05, 1.05, n)
    edge = np.array([-1.0, 1.0, -1.0, 1.0, -1.02, 1.02, 0.0, -0.999, 0.999])
    x = np.concatenate([x, edge, np.roll(edge, 3)])
    y = np.concatenate([y, np.roll(edge, 1), edge])
    return x.astype(np.float32), y.astype(np.float32)


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("padding", ["border", "zeros"])
def test_bilerp_plane_matches_jax(align_corners, padding):
    plane = np.random.default_rng(1).normal(size=(6, 10, 3)).astype(
        np.float32)
    x, y = _plane_coords()
    want = j_bilerp(jnp.asarray(plane), jnp.asarray(x), jnp.asarray(y),
                    align_corners=align_corners, padding=padding)
    got = t_bilerp(t(plane), t(x), t(y), align_corners=align_corners,
                   padding=padding)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                               atol=LOOKUP_ATOL)
    if padding == "zeros":   # past the edge the value fades to 0
        far = np.abs(_np(got)[np.abs(x) > 1.0 + 2.0 / 10]).max(initial=0.0)
        assert far == 0.0
    # the default is the VM planes' lookup, unchanged
    if align_corners and padding == "border":
        assert torch.equal(got, t_bilerp(t(plane), t(x), t(y)))
    with pytest.raises(ValueError, match="padding"):
        t_bilerp(t(plane), t(x), t(y), padding="reflect")


def _lookup_atol(env) -> float:
    """1e-6 of the map's largest value, plus one ulp of phi (2.4e-7) in
    texels of latitude (H / pi per radian) times the largest step between
    neighbouring rows of the map."""
    env = np.asarray(env, np.float64)
    step = np.abs(np.diff(env, axis=0)).max()
    return (LOOKUP_ATOL * np.abs(env).max()
            + 2.4e-7 * env.shape[0] / np.pi * step)


def _dirs(n=500, seed=2):
    """Unit directions: random, the poles, and the seam (y = +-0, x < 0)."""
    d = np.random.default_rng(seed).normal(size=(n, 3))
    special = np.array([[0, 0, 1], [0, 0, -1], [-1, 0, 0], [-1, -0.0, 0],
                        [-1, 1e-7, 0], [-1, -1e-7, 0], [1, 0, 0],
                        [0.3, 0, 0.95], [-0.3, 0, -0.95]], np.float64)
    d = np.concatenate([d, special])
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


_j_latlong = jax.jit(JL.latlong_lookup,
                     static_argnames=("align_corners", "padding"))


@pytest.mark.parametrize("align_corners,padding", [
    (True, "zeros"), (False, "zeros"), (False, "border")])
def test_latlong_lookup_matches_jax(align_corners, padding):
    env = np.random.default_rng(3).uniform(0, 5, (8, 16, 3)).astype(
        np.float32)
    d = _dirs()
    want = _j_latlong(jnp.asarray(env), jnp.asarray(d),
                      align_corners=align_corners, padding=padding)
    got = TL.latlong_lookup(t(env), t(d), align_corners=align_corners,
                            padding=padding)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                               atol=_lookup_atol(env))


# -------------------------------------------------- environment lights

def test_environment_light_tables_and_draws_equal_jax(tmp_path):
    """Tables of two probes of different sizes (one 64 x 128, so the CDF
    has 8,192 texels), equal to JAX's; draws from JAX's own uniforms pick
    the same texels; ``get_light`` within the lookup tolerance."""
    rng = np.random.default_rng(4)
    write_hdr(str(tmp_path / "a.hdr"),
              rng.gamma(0.5, 2.0, (64, 128, 3)).astype(np.float32))
    write_hdr(str(tmp_path / "b.hdr"),
              rng.uniform(0, 3, (8, 16, 3)).astype(np.float32))
    (tmp_path / "notes.txt").write_text("not a probe")
    jenv = JEnv.EnvironmentLight(str(tmp_path))
    tenv = TEnv.EnvironmentLight(str(tmp_path), device="cpu")
    assert tenv.light_names == jenv.light_names == ["a", "b"]
    for table in ("rgbs", "pdf_return", "cdf", "dirs"):
        for name in ("a", "b"):
            a, b = _np(getattr(tenv, table)[name]), np.asarray(
                getattr(jenv, table)[name])
            assert a.dtype == b.dtype == np.float32, (table, name)
            assert np.array_equal(a, b), (table, name)
    key = jax.random.PRNGKey(5)
    for name in ("a", "b"):
        want = jenv.sample_light(name, 7, 300, key)
        u = np.asarray(jax.random.uniform(key, (7, 300)))
        got = tenv.sample_light(name, 7, 300, draws=u)
        for w, g in zip(want, got):
            assert np.array_equal(_np(g), np.asarray(w)), name
    # draws from a generator: the shapes, and each direction is a texel's
    d, rgb, pdf = tenv.sample_light("a", 3, 5,
                                    torch.Generator().manual_seed(0))
    assert d.shape == rgb.shape == (3, 5, 3) and pdf.shape == (3, 5, 1)
    gap = (d.reshape(-1, 1, 3) - tenv.dirs["a"]).norm(dim=-1).amin(1)
    assert (gap == 0).all()
    dirs = _dirs(200, seed=6)
    np.testing.assert_allclose(
        _np(tenv.get_light("a", t(dirs))),
        # jitted, as the relight chunk calls it
        np.asarray(jax.jit(jenv.get_light, static_argnums=0)(
            "a", jnp.asarray(dirs))), rtol=0,
        atol=_lookup_atol(tenv.rgbs["a"]))


_j_light_rgbs = jax.jit(JL.get_light_rgbs, static_argnums=1)


@pytest.mark.parametrize("kind", ["pixel", "gt"])
def test_get_light_rgbs_pixel_and_gt_match_jax(kind):
    """The learned lat-long map (init as JAX's: uniform in [0, 3), in the
    light Adam group) and the dataset's probe, queried at rotated
    directions; align_corners False, zero padding."""
    from tensoir_tpu_torch.models.field import init_field_params
    from tensoir_tpu_torch.train.optim import param_group
    jcfg = small_cfg(envmap_h=4, envmap_w=8, light_kind=kind,
                     light_rotations=(0, 120))
    jp, _ = jax_field(jcfg, grid=(8, 8, 8), blob=False)
    gt_env = np.random.default_rng(7).uniform(0, 4, (8, 16, 3)).astype(
        np.float32)
    d = _dirs(300, seed=8)
    want = _j_light_rgbs(jp, jcfg, jnp.asarray(d),
                         gt_envmap=jnp.asarray(gt_env) if kind == "gt"
                         else None)
    tp, _ = port_field(jp, {})
    got = TL.get_light_rgbs(tp, port_cfg(jcfg), t(d),
                            gt_envmap=t(gt_env) if kind == "gt" else None)
    assert got.shape == (2, d.shape[0], 3)
    env = (np.log1p(np.exp(5.0 * _np(tp["light_pixel"]))) / 5.0).reshape(
        4, 8, 3) if kind == "pixel" else gt_env
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                               atol=_lookup_atol(env))
    tp2, ts2 = init_field_params(torch.Generator().manual_seed(0),
                                 port_cfg(jcfg), (8, 8, 8),
                                 [[-1.5] * 3, [1.5] * 3], device="cpu",
                                 gt_envmap=gt_env)
    if kind == "pixel":
        px = tp2["light_pixel"]
        assert px.shape == (32, 3) and 0.0 <= float(px.min())
        assert float(px.max()) < 3.0
        assert param_group("light_pixel") == "light"
    else:
        assert "light_pixel" not in tp2 and "lgt_sgs" not in tp2
        assert np.array_equal(_np(ts2["gt_envmap"]), gt_env)
        with pytest.raises(ValueError, match="gt_envmap"):
            TL.get_light_rgbs(tp, port_cfg(jcfg), t(d))


_j_render_brdf = jax.jit(
    _j_brdf, static_argnums=0,
    static_argnames=("sample_method", "second_n_sample", "secondary_tile",
                     "second_march_cap", "second_app_cap",
                     "secondary_use_baked"))


def test_render_with_brdf_gt_light_matches_jax(setup):
    """The rendering equation lit by the dataset's probe (light_kind
    'gt', in the scene as ``gt_envmap``), exact march."""
    s = setup
    jcfg = dataclasses.replace(s["jcfg"], light_kind="gt")
    gt_env = np.random.default_rng(9).uniform(0, 3, (8, 16, 3)).astype(
        np.float32)
    js = dict(s["js"], gt_envmap=jnp.asarray(gt_env))
    ts = dict(s["ts"], gt_envmap=t(gt_env))
    P = 16
    rng = np.random.default_rng(10)
    pts = rng.normal(size=(P, 3))
    pts = (pts / np.linalg.norm(pts, axis=-1, keepdims=True) * 0.5).astype(
        np.float32)
    o = np.zeros((P, 3), np.float32)
    o[:, 2] = -4.0
    dv = pts - o
    depth = np.linalg.norm(dv, axis=-1).astype(np.float32)
    rays = np.concatenate([o, dv / depth[:, None]], -1).astype(np.float32)
    normal = (pts / np.linalg.norm(pts, axis=-1, keepdims=True)).astype(
        np.float32)
    albedo = rng.uniform(0.1, 0.9, (P, 3)).astype(np.float32)
    rough = rng.uniform(0.1, 0.9, (P, 1)).astype(np.float32)
    fres = np.full((P, 3), 0.04, np.float32)
    lidx = np.zeros((P,), np.int32)
    kw = dict(sample_method="fixed_envirmap", key=None, second_n_sample=16,
              secondary_tile=256, second_march_cap=6, second_app_cap=8)
    want = _j_render_brdf(jcfg, s["jp"], js, jnp.asarray(depth),
                          jnp.asarray(normal), jnp.asarray(albedo),
                          jnp.asarray(rough), jnp.asarray(fres),
                          jnp.asarray(rays), jnp.asarray(lidx),
                          secondary_use_baked=False, **kw)
    got = t_brdf(port_cfg(jcfg), s["tp"], ts, t(depth), t(normal),
                 t(albedo), t(rough), t(fres), t(rays), t(lidx, torch.int32),
                 secondary_use_baked=False, **kw)
    np.testing.assert_allclose(_np(got), np.asarray(want), **MARCH)
    assert (np.asarray(want) > 0.05).any()


# ---------------------------------------------------- the visibility march

_j_transmittance = jax.jit(
    _j_trans, static_argnums=0,
    static_argnames=("n_sample", "march_cap", "window", "window_back",
                     "prepass_n"))


def _pairs(n, seed):
    """Surface points around the blob's shell and unit directions."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pts = d * rng.uniform(0.2, 0.7, size=(n, 1))
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return pts.astype(np.float32), dirs.astype(np.float32)


@pytest.mark.parametrize("route", ["exact_cap48", "exact", "window"])
def test_compute_transmittance_matches_jax(setup, route):
    """The exact march culled to its first 48 occupied samples of 96 (the
    relight default), uncapped, and the 48/16 window over the coarse
    occupancy of the same bf16 bake (prepass 12, dilate 3)."""
    s = setup
    pts, dirs = _pairs(256, seed=11)
    kw = dict(n_sample=96, vis_near=0.05, vis_far=1.5)
    jb = jc = tb = tc = None
    if route == "window":
        jb = JF.bake_packed_sigma_grid(s["jcfg"], s["jp"], s["js"])
        jc = JF.bake_coarse_occupancy(jb, dilate=3)
        conv = port_field({}, {"b": jb, "c": jc})[1]
        tb, tc = conv["b"], conv["c"]
        kw.update(window=48, window_back=16, prepass_n=12)
    else:
        kw["march_cap"] = 48 if route == "exact_cap48" else 0
    want = _j_transmittance(s["jcfg"], s["jp"], s["js"], jnp.asarray(pts),
                            jnp.asarray(dirs), baked=jb, coarse=jc, **kw)
    reset_launch_counts()
    got = TSec.compute_transmittance(s["tcfg"], s["tp"], s["ts"], t(pts),
                                     t(dirs), baked=tb, coarse=tc, **kw)
    assert sum(LAUNCHES.values()) == 0       # the CPU runs no kernel
    for name, a, b in zip(("nerv", "nerfactor"), got, want):
        assert not a.requires_grad
        np.testing.assert_allclose(_np(a), np.asarray(b), err_msg=name,
                                   **MARCH)
    vis = np.asarray(want[0])
    assert (vis < 0.5).any() and (vis > 0.5).any()     # shadowed and lit
    if route == "window":   # the bake is marched only through its window
        with pytest.raises(ValueError, match="window"):
            TSec.compute_transmittance(s["tcfg"], s["tp"], s["ts"], t(pts),
                                       t(dirs), baked=tb, coarse=tc,
                                       n_sample=96, window=0)


# --------------------------------------------------- the relight chunk

_j_chunk_fns = {}


def _j_chunk_fn(cfg, env, name, **kw):
    """JAX's jitted chunk function, built once per light and options, so
    that the chunk test and the benchmark share their compiles."""
    key = (id(env), name, tuple(sorted(kw.items())))
    if key not in _j_chunk_fns:
        _j_chunk_fns[key] = _make_j_chunk_fn(cfg, env, name, **kw)
    return _j_chunk_fns[key]


_make_j_chunk_fn = JRP.make_relight_chunk_fn


def _view_rays(s, n):
    """n rays from the middle rows of the first test view."""
    rays = np.asarray(s["tds"][0]["rays"], np.float32)
    start = (rays.shape[0] - n) // 2
    return rays[start:start + n]


@pytest.mark.parametrize("fast_vis", [False, True], ids=["exact", "fast"])
def test_relight_chunk_matches_jax(setup, fast_vis):
    """One chunk of 64 rays across a test view under light 'bridge', 32 light
    samples per ray from JAX's own uniforms, 4 visibility tiles of 512:
    the eight outputs in JAX's order. With ``fast_vis`` both march JAX's
    jitted bake (the port bakes once per benchmark, JAX in each call)."""
    s = setup
    kw = dict(n_samples=N_SAMPLES, n_light_samples=N_LIGHT,
              second_n_sample=SEC_N, vis_tile=VIS_TILE, fast_vis=fast_vis)
    j_fn = _j_chunk_fn(s["jcfg"], s["jenv"], "bridge", **kw)
    t_fn = TRP.make_relight_chunk_fn(s["tcfg"], s["tenv"], "bridge", **kw)
    rays = _view_rays(s, CHUNK)
    key = jax.random.PRNGKey(12)
    want = j_fn(s["jp"], s["js"], jnp.asarray(rays), key,
                jnp.asarray(RESCALE))
    u = np.asarray(jax.random.uniform(key, (CHUNK, N_LIGHT)))
    bakes = None
    if fast_vis:
        jb = jax.jit(JF.bake_packed_sigma_grid, static_argnums=0,
                     static_argnames="max_reso")(s["jcfg"], s["jp"], s["js"],
                                                 max_reso=128)
        conv = port_field({}, {"b": jb,
                               "c": JF.bake_coarse_occupancy(jb, dilate=3)})
        bakes = (conv[1]["b"], conv[1]["c"])
    reset_launch_counts()
    TSec.reset_march_counts()
    got = t_fn(s["tp"], s["ts"], t(rays), None, t(RESCALE), draws=u,
               vis_bakes=bakes)
    assert sum(LAUNCHES.values()) == 0
    assert TSec.MARCHED == {"pairs": CHUNK * N_LIGHT,
                            "tiles": CHUNK * N_LIGHT // VIS_TILE}
    names = ("relight_without_bg", "relight_with_bg", "acc", "albedo",
             "roughness", "normal", "depth", "rgb")
    assert len(got) == len(want) == 8
    for name, a, b in zip(names, got, want):
        assert a.shape == b.shape, name
        d = np.abs(_np(a).astype(np.float64) - np.asarray(b)).max()
        assert d <= CHUNK_ATOL, (name, d)
    acc = np.asarray(want[2])
    assert (acc > 0.5).sum() > 5 and (acc < 0.5).sum() > 5
    # a relit surface, lit and not white; the background from the probe
    wo = np.asarray(want[0])
    assert (wo[acc > 0.5] < 0.99).any()
    if fast_vis:   # the port bakes once per benchmark: the bake is needed
        with pytest.raises(ValueError, match="vis_bakes"):
            t_fn(s["tp"], s["ts"], t(rays), None, t(RESCALE), draws=u)


# ------------------------------------------------------------- benchmark

def _jax_draws(seed, chunk, n):
    """The uniforms JAX's benchmark draws, one chunk call after another:
    the key split its loop makes before each call."""
    key = jax.random.PRNGKey(seed)
    while True:
        key, sub = jax.random.split(key)
        yield np.asarray(jax.random.uniform(sub, (chunk, n)))


def _tree(root):
    """Files under root, with a video (a file in JAX, a folder of frames in
    the port) as its folder and name."""
    out = set()
    for dirpath, _, files in os.walk(root):
        rel = os.path.relpath(dirpath, root)
        top = rel.split(os.sep)[0]
        if top.startswith("video"):
            if rel == top:      # JAX: video/<name>.gif or .mp4
                out |= {f"{top}/{os.path.splitext(f)[0]}" for f in files}
            else:               # the port: video/<name>/<i>.png
                out.add(rel.replace(os.sep, "/"))
            continue
        out |= {os.path.normpath(os.path.join(rel, f)) for f in files}
    return out


def test_relight_benchmark_matches_jax(setup, monkeypatch):
    """relight_benchmark end to end on the relighting test set on disk (two
    views of 12 x 12, lights bridge and city), each package on its own
    loader's items and lights, the port replaying JAX's draws: metrics,
    every PNG, the text records and the artifact tree."""
    s = setup
    for i in range(len(s["jds"])):           # the loaders agree
        ti, ji = s["tds"][i], s["jds"][i]
        assert set(ti) == set(ji)
        for k in ji:
            a, b = np.asarray(ti[k]), np.asarray(ji[k])
            assert a.dtype == b.dtype and np.array_equal(a, b), (i, k)
    assert set(s["tds"].lights_probes) == set(LIGHTS)
    for name in LIGHTS:
        assert np.array_equal(s["tds"].lights_probes[name],
                              s["jds"].lights_probes[name])
    monkeypatch.setattr(JRP, "make_relight_chunk_fn",
                        lambda cfg, env, name, **kw: _j_chunk_fn(
                            cfg, env, name, **kw))
    kw = dict(n_samples=N_SAMPLES, chunk=CHUNK, n_light_samples=N_LIGHT,
              second_n_sample=SEC_N, vis_tile=VIS_TILE, rescale3=RESCALE,
              seed=SEED)
    jdir, tdir = str(s["root"] / "j_out"), str(s["root"] / "t_out")
    want = JRP.relight_benchmark(s["jcfg"], s["jp"], s["js"], s["jds"],
                                 s["jenv"], save_path=jdir, **kw)
    reset_launch_counts()
    got = TRP.relight_benchmark(s["tcfg"], s["tp"], s["ts"], s["tds"],
                                s["tenv"], save_path=tdir,
                                draws=_jax_draws(SEED, CHUNK, N_LIGHT), **kw)
    assert LAUNCHES["row_scatter_add"] == 0
    assert list(got) == list(want) == list(LIGHTS)
    for name in LIGHTS:
        assert abs(got[name]["psnr"] - want[name]["psnr"]) <= 0.01, name
        assert abs(got[name]["ssim"] - want[name]["ssim"]) <= 1e-4, name
    assert _tree(tdir) == _tree(jdir)
    n_png = 0
    for rel in sorted(_tree(jdir)):
        path = os.path.join(jdir, rel)
        if rel.endswith(".png"):
            a = read_png(os.path.join(tdir, rel)).astype(int)
            b = np.asarray(Image.open(path)).astype(int)
            assert a.shape == b.shape, rel
            assert np.abs(a - b).max() <= 1, rel
            n_png += 1
    assert n_png == 2 * (4 + 8)
    for view in ("test_000", "test_001"):
        rec = os.path.join(view, "relighting_without_bg", "relight_psnr.txt")
        for tl, jl in zip(open(os.path.join(tdir, rec)).readlines(),
                          open(os.path.join(jdir, rec)).readlines()):
            assert tl.split(":")[0] == jl.split(":")[0]
    assert len(open(os.path.join(tdir, "relight_psnr.txt")).readlines()) == 2
    frames = sorted(os.listdir(os.path.join(tdir, "video_with_bg",
                                            "city_video")))
    assert frames == ["000.png", "001.png"]
    assert np.array_equal(
        read_png(os.path.join(tdir, "video_with_bg", "city_video",
                              "001.png")),
        read_png(os.path.join(tdir, "test_001", "relighting_with_bg",
                              "city.png")))


def test_write_videos_writes_frames(tmp_path):
    frames = [np.full((4, 5, 3), i, np.uint8) for i in range(3)]
    write_videos(str(tmp_path / "v"), [("clip", frames), ("none", []),
                                       ("counted", 2)])
    assert sorted(os.listdir(tmp_path / "v")) == ["clip"]
    assert np.array_equal(read_png(tmp_path / "v" / "clip" / "002.png"),
                          frames[2])


# ---------------------------------------------------- ground truth, edits

@pytest.mark.parametrize("background", ["env", "white"])
def test_render_env_gt_matches_jax(background):
    """The analytic relit image of the shadow scene under a 8 x 16 probe:
    the lambertian integral with shadows, the background, the sRGB curve."""
    kw = dict(split="test", n_views=1, img_wh=(10, 10))
    jds, tds = JSyn.SyntheticShadowDataset(**kw), TSyn.SyntheticShadowDataset(
        **kw)
    env = np.random.default_rng(13).uniform(0, 4, (8, 16, 3)).astype(
        np.float32)
    rays = tds.all_rays
    want = jds.render_env_gt(rays, env, background=background)
    got = tds.render_env_gt(rays, env, background=background)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    lin = tds.render_env_gt(rays, env, background=background, srgb=False)
    hit = tds.view(0)["masks"] > 0
    assert 0 < hit.sum() < hit.size
    if background == "white":
        # the sRGB curve's 1e-6 bias takes white to 1.0000004
        assert (lin[~hit] == 1.0).all()
        np.testing.assert_allclose(got[~hit], 1.0, rtol=0, atol=1e-6)


def test_material_editing_loader_and_one_edit(setup):
    """The material-editing set reads the 'city' image for every light (as
    JAX's); an edit (albedo tint, roughness x 0.5) changes exactly the
    decoded BRDF and the relit image."""
    s = setup
    kw = dict(split="test", light_names=("bridge", "forest"))
    jds = j_get("tensoIR_material_editing_test")(s["scene"], s["hdr"], **kw)
    tds = t_get("tensoIR_material_editing_test")(s["scene"], s["hdr"], **kw)
    ti, ji = tds[1], jds[1]
    assert set(ti) == set(ji)
    for k in ji:
        assert np.array_equal(np.asarray(ti[k]), np.asarray(ji[k])), k
    city = s["tds"][1]["rgbs"][LIGHTS.index("city")]
    assert np.array_equal(ti["rgbs"][0], city)
    assert np.array_equal(ti["rgbs"][1], city)
    rays = t(_view_rays(s, CHUNK))
    u = np.random.default_rng(14).uniform(size=(CHUNK, N_LIGHT))
    ckw = dict(n_samples=N_SAMPLES, n_light_samples=N_LIGHT,
               second_n_sample=SEC_N, vis_tile=VIS_TILE)
    plain = TRP.make_relight_chunk_fn(s["tcfg"], s["tenv"], "city", **ckw)
    edit = TRP.make_relight_chunk_fn(s["tcfg"], s["tenv"], "city",
                                     roughness_scale=0.5, **ckw)
    tint = t([1.0, 0.3, 0.3])
    a = plain(s["tp"], s["ts"], rays, None, t(np.ones(3)), draws=u)
    b = edit(s["tp"], s["ts"], rays, None, tint, draws=u)
    assert torch.equal(b[3], a[3] * tint)
    assert torch.equal(b[4], torch.clamp(a[4] * 0.5, 0.0, 1.0))
    for i in (2, 5, 6, 7):        # acc, normal, depth, rgb: unedited
        assert torch.equal(a[i], b[i])
    surf = a[2] > 0.5
    assert (a[0][surf] - b[0][surf]).abs().max() > 0.01


# ---------------------------------------------------------------- scripts

def test_scripts_run_on_the_cpu(setup, tmp_path):
    """relight_importance (the five lights, one 12 x 12 view), material
    editing and the relight demo, through their ``main(argv,
    device="cpu")`` at tiny widths, on a checkpoint of the port's field."""
    from tensoir_tpu_torch.examples import relight_demo
    from tensoir_tpu_torch.scripts import material_editing, relight_importance
    s = setup
    ckpt = str(tmp_path / "ckpt.npz")
    save_checkpoint(ckpt, s["tcfg"], s["tp"], s["ts"])
    scene, hdr = str(tmp_path / "scene"), str(tmp_path / "hdr")
    TSyn.write_relight_test_scene(scene, hdr, n_views=1, size=12,
                                  env_hw=(16, 32), gt_env_hw=(8, 16))
    config = "configs/relighting_test/armadillo.txt"
    res = relight_importance.main(
        ["--config", config, "--ckpt", ckpt, "--datadir", scene, "--hdrdir",
         hdr, "--basedir", str(tmp_path / "log"), "--batch_size", "64",
         "--batch_size_test", "64", "--secondary_tile", "4096",
         "--second_nSample", "8", "--test_number", "1"], device="cpu")
    assert list(res) == relight_importance.LIGHT_NAMES
    assert all(np.isfinite(r["psnr"]) and np.isfinite(r["ssim"])
               for r in res.values())
    out = tmp_path / "log" / "relight_armadillo"
    assert (out / "relight_psnr.txt").exists()
    assert (out / "test_000" / "relighting_with_bg" / "night.png").exists()
    # the visibility and surface the reference fixes; the config's keys
    # may only restate them
    for key, val in (("vis_equation", "nerfactor"),
                     ("acc_mask_threshold", "0.3")):
        with pytest.raises(SystemExit, match=key):
            relight_importance.main(["--config", config, "--ckpt", ckpt,
                                     f"--{key}", val], device="cpu")

    argv = ["--config", config, "--ckpt", ckpt, "--datadir", scene,
            "--hdrdir", hdr, "--chunk", "64", "--out",
            str(tmp_path / "edit")]
    edited = material_editing.main(argv + ["--roughness_scale", "0.5",
                                           "--albedo_tint", "1,0.3,0.3"],
                                   device="cpu")
    plain = material_editing.main(argv, device="cpu")
    assert len(edited) == len(plain) == 1 and edited[0].shape == (12, 12, 3)
    assert np.abs(edited[0] - plain[0]).max() > 0.01
    assert (tmp_path / "edit" / "edit_000_city.png").exists()

    demo_out = tmp_path / "demo"
    res = relight_demo.main(["--ckpt", ckpt, "--out", str(demo_out),
                             "--img", "12", "--n_views", "1", "--chunk",
                             "512", "--n_light_samples", "64"],
                            device="cpu")
    assert set(res) == {"sunset2", "twinlight"}
    saved = json.loads((demo_out / "relight_metrics.json").read_text())
    assert saved == res
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            relight_importance.main(["--ckpt", ckpt])
