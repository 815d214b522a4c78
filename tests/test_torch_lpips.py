"""The port's LPIPS against the JAX package's, on the CPU.

No trained LPIPS weights are in the repo, so both packages run on RANDOM
weights written in the converter's npz format
(``scripts/convert_lpips_weights.py:convert_state_dict``), as
``tests/test_lpips.py`` does. Tolerance: 1e-5 relative on the distance.
Both run f32 convolutions on the CPU (JAX at ``Precision.HIGHEST``) that
sum in other orders; the distance is a mean of unit-normalised feature
differences, whose rounding stays near f32's 1e-7 (the largest difference
seen is under 1e-6 relative).
"""
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from tensoir_tpu.utils import lpips_jax as JL
from tensoir_tpu.utils import metrics as JM

from tensoir_tpu_torch.data import get_dataset as t_get
from tensoir_tpu_torch.data.synthetic import (write_relight_test_scene,
                                              write_shadow_scene)
from tensoir_tpu_torch.models.env_light import EnvironmentLight
from tensoir_tpu_torch.render import eval as TE
from tensoir_tpu_torch.render import relight_pipeline as TRP
from tensoir_tpu_torch.utils import lpips as TLP
from tensoir_tpu_torch.utils import metrics as TM

from torch_parity import (jax_field, one_torch_thread,  # noqa: F401
                          port_field, small_cfg, port_cfg)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = Path(__file__).resolve().parent.parent
RTOL = 1e-5
CHANNELS = {"alex": [(3, 64, 11), (64, 192, 5), (192, 384, 3), (384, 256, 3),
                     (256, 256, 3)],
            "vgg": [(3, 64, 3), (64, 64, 3), (64, 128, 3), (128, 128, 3),
                    (128, 256, 3), (256, 256, 3), (256, 256, 3),
                    (256, 512, 3), (512, 512, 3), (512, 512, 3),
                    (512, 512, 3), (512, 512, 3), (512, 512, 3)]}
# lpips' state-dict layer indices inside each torchvision slice
SLICES = {"alex": [[0], [0], [0], [0], [0]],
          "vgg": [[0, 2], [0, 2], [0, 2, 4], [0, 2, 4], [0, 2, 4]]}
TAPS = {"alex": [64, 192, 384, 256, 256], "vgg": [64, 128, 256, 512, 512]}


def _converter():
    spec = importlib.util.spec_from_file_location(
        "convert_lpips_weights", ROOT / "scripts" / "convert_lpips_weights.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.convert_state_dict


def _weights(net: str, seed: int) -> dict:
    """A random lpips state dict (Kaiming-scaled convolutions, lin heads in
    [0, 0.1)), through the user-facing converter."""
    rng = np.random.default_rng(seed)
    sd, plan = {}, iter(CHANNELS[net])
    for si, layers in enumerate(SLICES[net]):
        for li in layers:
            i, o, k = next(plan)
            sd[f"net.slice{si + 1}.{li}.weight"] = (
                rng.normal(size=(o, i, k, k)) * np.sqrt(2.0 / (i * k * k))
            ).astype(np.float32)
            sd[f"net.slice{si + 1}.{li}.bias"] = (
                0.01 * rng.normal(size=o)).astype(np.float32)
    for t, c in enumerate(TAPS[net]):
        sd[f"lin{t}.model.1.weight"] = (
            0.1 * rng.uniform(size=(1, c, 1, 1))).astype(np.float32)
    return _converter()(sd, net)


def _images(h=64, seed=0, n=None):
    rng = np.random.default_rng(seed)
    shape = (h, h, 3) if n is None else (n, h, h, 3)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("net", ["alex", "vgg"])
def test_lpips_distance_matches_jax(net, tmp_path):
    params = _weights(net, seed=1)
    path = tmp_path / f"lpips_{net}.npz"
    np.savez(path, **params)
    tparams, tnet = TLP.load_lpips_params(str(path), device="cpu")
    assert tnet == net
    assert tparams["conv0_w"].shape == (64, 3) + params["conv0_w"].shape[:2]
    a, b = _images()
    want = float(np.asarray(JL.lpips_distance(params, a, b, net=net))[0])
    got = TLP.lpips_distance(tparams, a, b, net=net)
    assert got.shape == (1,) and want > 0
    assert abs(float(got[0]) - want) <= RTOL * want, (float(got[0]), want)
    # a batch of two pairs, and a pair of equal images
    a2, b2 = _images(h=72, seed=3, n=2)
    want2 = np.asarray(JL.lpips_distance(params, a2, b2, net=net))
    got2 = TLP.lpips_distance(tparams, a2, b2, net=net).numpy()
    np.testing.assert_allclose(got2, want2, rtol=RTOL)
    assert abs(float(TLP.lpips_distance(tparams, a, a, net=net)[0])) < 1e-7


@pytest.fixture
def weights_file(tmp_path, monkeypatch):
    """A random alex weights file named by TENSOIR_LPIPS_WEIGHTS, with both
    packages' parameter caches cleared before and after (the JAX package
    caches on the function)."""
    path = tmp_path / "w" / "lpips_alex.npz"
    path.parent.mkdir()
    np.savez(path, **_weights("alex", seed=2))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("TENSOIR_LPIPS_WEIGHTS", str(path))
    monkeypatch.setattr(TM, "_LPIPS_PARAMS", {})
    for net in ("alex", "vgg"):
        if hasattr(JM.rgb_lpips, f"_params_{net}"):
            monkeypatch.delattr(JM.rgb_lpips, f"_params_{net}")
    yield path
    for net in ("alex", "vgg"):
        if hasattr(JM.rgb_lpips, f"_params_{net}"):
            delattr(JM.rgb_lpips, f"_params_{net}")


def test_rgb_lpips_matches_jax_with_a_weights_file(weights_file,
                                                   monkeypatch):
    a, b = _images(h=48, seed=5)
    want = JM.rgb_lpips(a, b, "alex")
    got = TM.rgb_lpips(a, b, "alex", device="cpu")
    assert isinstance(got, float) and want > 0
    assert abs(got - want) <= RTOL * want, (got, want)
    # loaded once
    assert list(TM._LPIPS_PARAMS) == [(str(weights_file), "alex", "cpu")]
    assert TM.rgb_lpips(a, b, "alex", device="cpu") == got
    # the file serves only the net it was converted for
    assert TM.rgb_lpips(a, b, "vgg", device="cpu") is None
    assert JM.rgb_lpips(a, b, "vgg") is None
    # without a weights file: None from both
    monkeypatch.delenv("TENSOIR_LPIPS_WEIGHTS")
    assert TM.rgb_lpips(a, b, "alex") is None
    assert JM.rgb_lpips(a, b, "alex") is None
    if not torch.cuda.is_available():
        monkeypatch.setenv("TENSOIR_LPIPS_WEIGHTS", str(weights_file))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TM.rgb_lpips(a, b, "alex")


def test_eval_reports_lpips_with_a_weights_file(weights_file, tmp_path,
                                                monkeypatch):
    """evaluation_iter with compute_extra_metrics on one 64 x 64 view: the
    lpips_alex keys appear (vgg has no file), each the mean of finite
    values; without the file they do not."""
    write_shadow_scene(str(tmp_path / "scene"), str(tmp_path / "hdr"),
                       views=(("test", 1, 64),), env_hw=(8, 16))
    ds = t_get("tensoIR_unknown_rotated_lights")(
        str(tmp_path / "scene"), str(tmp_path / "hdr"), split="test")
    jcfg = small_cfg(envmap_h=4, envmap_w=8)
    tp, ts = port_field(*jax_field(jcfg))
    kw = dict(n_samples=48, chunk=1024, test_all=True,
              compute_extra_metrics=True, second_n_sample=8,
              secondary_tile=1024)
    res = TE.evaluation_iter(port_cfg(jcfg), tp, ts, ds, **kw)
    keys = {k for k in res if k.startswith("lpips")}
    assert {"lpips_alex", "lpips_alex_brdf"} <= keys
    assert not any("vgg" in k for k in keys)
    assert all(math.isfinite(res[k]) and res[k] >= 0 for k in keys)
    monkeypatch.delenv("TENSOIR_LPIPS_WEIGHTS")
    res = TE.evaluation_iter(port_cfg(jcfg), tp, ts, ds, **kw)
    assert not any(k.startswith("lpips") for k in res)


def test_relight_benchmark_reports_lpips_on_its_device(weights_file,
                                                      tmp_path):
    """relight_benchmark with compute_extra_metrics on the CPU: one 32 x 32
    view (AlexNet's smallest input that keeps a pixel through both pools)
    under one light gives a finite lpips, computed with parameters loaded
    on the benchmark's device, the CPU, and never on the card."""
    scene_dir, hdr_dir = str(tmp_path / "rs"), str(tmp_path / "rh")
    write_relight_test_scene(scene_dir, hdr_dir, lights=("city",),
                             n_views=1, size=32, env_hw=(8, 16),
                             gt_env_hw=(4, 8))
    ds = t_get("tensoIR_relighting_test")(scene_dir, hdr_dir, split="test",
                                          light_names=("city",))
    jcfg = small_cfg(envmap_h=4, envmap_w=8)
    tp, ts = port_field(*jax_field(jcfg))
    res = TRP.relight_benchmark(
        port_cfg(jcfg), tp, ts, ds, EnvironmentLight(hdr_dir, device="cpu"),
        n_samples=32, chunk=256, n_light_samples=8, second_n_sample=16,
        vis_tile=1024, compute_extra_metrics=True)
    assert math.isfinite(res["city"]["lpips"]) and res["city"]["lpips"] > 0
    assert list(TM._LPIPS_PARAMS) == [(str(weights_file), "alex", "cpu")]
