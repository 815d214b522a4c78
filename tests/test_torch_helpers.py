"""The JAX package's public helpers that its pipeline does not call,
against the port's, on the CPU: the ray/AABB test, inverse-CDF sampling,
the spherical-coordinate conversions, sRGB -> linear, ``raw2alpha`` from
a density, the lat-long image lookup, the static sample count, the dense
baked-density lookup, the mesh padding, the names ``ops`` exports; and
the image loaders' resize on load against PIL and JAX's loaders.

Tolerances: f32 results 1e-6 relative (1e-7 absolute; the same
arithmetic, where XLA may fuse a multiply-add), but ``sample_pdf`` 1e-4
relative: its CDF is a prefix sum that XLA adds in another order, and a
sample's place in its bin divides by the bin's small probability (the
worst is 1.2e-5); numpy and integer results exact. The resize is held
to PIL bit for bit: every pixel equal, at every size tried (none needs
the 1/255 allowance).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import tensoir_tpu.ops as JOPS
from tensoir_tpu.data import images as JImg
from tensoir_tpu.models import field as JF
from tensoir_tpu.ops import color as JC
from tensoir_tpu.ops import compositing as JComp
from tensoir_tpu.ops import interp as JI
from tensoir_tpu.ops import rays as JR
from tensoir_tpu.parallel.mesh import pad_to_multiple as j_pad

import tensoir_tpu_torch.ops as TOPS
from tensoir_tpu_torch.data import images as TImg
from tensoir_tpu_torch.models import field as TF
from tensoir_tpu_torch.ops import color as TC
from tensoir_tpu_torch.ops import compositing as TComp
from tensoir_tpu_torch.ops import interp as TI
from tensoir_tpu_torch.ops import rays as TR
from tensoir_tpu_torch.parallel.mesh import pad_to_multiple as t_pad

from torch_parity import AABB, t

F32 = dict(rtol=1e-6, atol=1e-7)
RNG = np.random.default_rng(0)


def test_ops_exports_the_jax_names():
    names = {n for n in dir(JOPS) if not n.startswith("_")
             and callable(getattr(JOPS, n))}
    assert names <= set(dir(TOPS))


def test_aabb_intersect_matches_jax():
    o = RNG.uniform(-3, 3, (64, 3)).astype(np.float32)
    d = RNG.normal(size=(64, 3)).astype(np.float32)
    d[:4, 0] = 0.0                      # axis-parallel rays: the 1e-6 guard
    want = JR.aabb_intersect(jnp.asarray(o), jnp.asarray(d), jnp.asarray(AABB))
    got = TR.aabb_intersect(t(o), t(d), t(AABB))
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32)
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[2].any() and not got[2].all()


@pytest.mark.parametrize("n_samples", [1, 7, 32])
def test_sample_pdf_deterministic_matches_jax(n_samples):
    bins = np.sort(RNG.uniform(2, 6, (16, 9)), -1).astype(np.float32)
    weights = RNG.uniform(0, 1, (16, 8)).astype(np.float32)
    weights[0] = 0.0                    # flat: the 1e-5 floor
    want = JR.sample_pdf(jnp.asarray(bins), jnp.asarray(weights), n_samples)
    got = TR.sample_pdf(t(bins), t(weights), n_samples)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_sample_pdf_with_a_generator_inverts_its_own_draws():
    """The random path draws its quantiles from the generator: the same
    quantiles through JAX's deterministic inverse-CDF give the same
    samples."""
    bins = np.sort(RNG.uniform(2, 6, (8, 5)), -1).astype(np.float32)
    weights = RNG.uniform(0, 1, (8, 4)).astype(np.float32)
    got = TR.sample_pdf(t(bins), t(weights), 6,
                        key=torch.Generator().manual_seed(3))
    u = torch.rand((8, 6), generator=torch.Generator().manual_seed(3))
    w = weights + 1e-5
    cdf = np.concatenate([np.zeros((8, 1), np.float32),
                          np.cumsum(w / w.sum(-1, keepdims=True), -1)], -1)
    want = np.stack([np.interp(u[i].numpy(), cdf[i], bins[i])
                     for i in range(8)])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert ((got >= t(bins[:, :1])) & (got <= t(bins[:, -1:]))).all()


@pytest.mark.parametrize("what", ["lat-lng_to_theta-phi",
                                  "theta-phi_to_lat-lng"])
def test_sph_conventions_match_jax(what):
    pts = np.stack([RNG.uniform(0.5, 2, 32), RNG.uniform(-1.5, 1.5, 32),
                    RNG.uniform(-3.1, 6.2, 32)], -1)
    assert np.array_equal(TR.convert_sph_conventions(pts, what),
                          JR.convert_sph_conventions(pts, what))
    with pytest.raises(NotImplementedError):
        TR.convert_sph_conventions(pts, "xyz")


@pytest.mark.parametrize("convention", ["lat-lng", "theta-phi"])
def test_sph2cart_matches_jax(convention):
    pts = np.stack([RNG.uniform(0.5, 2, 32), RNG.uniform(0, 3.1, 32),
                    RNG.uniform(-3.1, 6.2, 32)], -1)
    assert np.array_equal(TR.sph2cart(pts, convention),
                          JR.sph2cart(pts, convention))
    with pytest.raises(ValueError, match="out of"):
        TR.sph2cart(pts * 4.0, convention)


def test_srgb2linear_and_raw2alpha_from_sigma_match_jax():
    x = np.concatenate([np.linspace(-0.1, 1.1, 97),
                        [0.0404, 0.04045, 0.0405]]).astype(np.float32)
    np.testing.assert_allclose(TC.srgb2linear(t(x)).numpy(),
                               np.asarray(JC.srgb2linear(jnp.asarray(x))),
                               **F32)
    sigma = RNG.uniform(0, 5, (8, 12)).astype(np.float32)
    dist = RNG.uniform(0, 0.1, (8, 12)).astype(np.float32)
    want = JComp.raw2alpha_from_sigma(jnp.asarray(sigma), jnp.asarray(dist),
                                      25.0)
    got = TComp.raw2alpha_from_sigma(t(sigma), t(dist), 25.0)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32)


@pytest.mark.parametrize("align_corners", [True, False])
def test_bilerp_image_nchw_like_matches_jax(align_corners):
    img = RNG.uniform(0, 4, (8, 16, 3)).astype(np.float32)
    x = RNG.uniform(-1.1, 1.1, 50).astype(np.float32)
    y = RNG.uniform(-1.1, 1.1, 50).astype(np.float32)
    want = JI.bilerp_image_nchw_like(jnp.asarray(img), jnp.asarray(x),
                                     jnp.asarray(y), align_corners)
    got = TI.bilerp_image_nchw_like(t(img), t(x), t(y), align_corners)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("grid,step_ratio", [((128, 128, 128), 0.5),
                                             ((300, 297, 211), 0.5),
                                             ((24, 20, 16), 2.0)])
def test_num_samples_for_matches_jax(grid, step_ratio):
    for aabb in (AABB, np.array([[-0.7, -1.2, -0.3], [0.9, 1.1, 0.4]])):
        assert (TF.num_samples_for(aabb, grid, step_ratio)
                == JF.num_samples_for(aabb, grid, step_ratio))


def test_density_feature_baked_matches_jax():
    baked = RNG.normal(size=(9, 7, 11)).astype(np.float32)
    xyz = RNG.uniform(-1.6, 1.6, (40, 3)).astype(np.float32)
    want = JF.density_feature_baked(jnp.asarray(baked), jnp.asarray(AABB),
                                    jnp.asarray(xyz))
    got = TF.density_feature_baked(t(baked), t(AABB), t(xyz))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("shape,multiple,axis", [((10, 3), 4, 0),
                                                 ((8, 3), 4, 0),
                                                 ((2, 7, 3), 3, 1)])
def test_pad_to_multiple_matches_jax(shape, multiple, axis):
    arr = RNG.normal(size=shape).astype(np.float32)
    got, n = t_pad(arr, multiple, axis)
    want, n_want = j_pad(arr, multiple, axis)
    assert n == n_want and np.array_equal(got, want)


# ------------------------------------------------------------ resize on load

def _image(h, w, mode, seed):
    rng = np.random.default_rng(seed)
    arr = (rng.random((h, w, 4)) * 255).astype(np.uint8)
    arr[..., 3] = np.where(rng.random((h, w)) < 0.3, 0,
                           np.where(rng.random((h, w)) < 0.5, 255,
                                    arr[..., 3]))
    im = Image.fromarray(arr, "RGBA")
    if mode == "P":
        return im.convert("RGB").quantize(64)
    return im if mode == "RGBA" else im.convert(mode)


@pytest.mark.parametrize("src,dst", [((29, 37), (18, 14)), ((800, 800),
                                                           (400, 400)),
                                     ((13, 17), (40, 31)),
                                     ((64, 48), (64, 20))])
@pytest.mark.parametrize("mode", ["RGBA", "RGB", "L", "P"])
def test_resize_matches_pil_pixel_for_pixel(src, dst, mode):
    """``resize_like_pil`` against ``Image.resize`` (Lanczos and nearest):
    every pixel equal. src and dst are (height, width)."""
    im = _image(*src, mode, seed=src[0] + dst[1])
    size = (dst[1], dst[0])
    for lanczos, flt in ((True, Image.Resampling.LANCZOS),
                         (False, Image.Resampling.NEAREST)):
        want = np.asarray(im.resize(size, flt))
        got = TImg.resize_like_pil(np.asarray(im), size, lanczos,
                                   palette=mode == "P")
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got, want), (lanczos, int(
            (got != want).sum()))


@pytest.mark.parametrize("mode", ["RGBA", "RGB", "L", "P"])
def test_loaders_resize_on_load_as_jax(tmp_path, mode):
    """The loaders at a view size the file does not have: the port resizes
    as JAX's PIL loaders do, to the bit."""
    path = tmp_path / f"x_{mode}.png"
    _image(37, 29, mode, seed=1).save(path)
    for wh in ((14, 18), (29, 37), (58, 74)):
        got, gmask = TImg.load_rgba_white_composite(path, wh)
        want, wmask = JImg.load_rgba_white_composite(path, wh)
        assert np.array_equal(got, want) and np.array_equal(gmask, wmask)
        if mode in ("RGBA", "RGB"):
            assert np.array_equal(TImg.load_normal_png(path, wh),
                                  JImg.load_normal_png(path, wh))
