"""The paper's two multi-light training settings in the port, against the
JAX package's, on the CPU: the rotated setting (one SG set seen under
three rotations, 0/120/240 degrees) and the general setting (three
distinct lights, one SG set each: ``per_light_sg``). Both carry three rows
of ``light_line``; the intrinsic feature averages them.

- One deterministic training step of each setting, radiance and relight
  phase, on the same field (JAX's, blob seeded, masked) and rays spread
  over the three lights: the loss 1e-4 relative, every gradient
  (``light_line`` and each light's SGs included) 1e-4 relative and 1e-5
  absolute (sums over every sample of two backward passes, as in
  test_torch_relight.py); then one Adam step of each package's optimizer
  from those gradients (the light group at ``lr_light``), parameters 1e-4
  absolute (Adam's first step moves each element by about lr * sign(g)).
- The eval chunk of each light, through ``evaluation_iter(
  light_idx_to_test=li)`` on the three-light scene the port's writer puts
  on disk, read by each package's own loader: PSNR within 0.01 dB, normal
  MAE within 0.01 degrees (as test_torch_eval.py).
- A checkpoint with three lights, JAX -> port -> JAX, equal.
- Both demos and the CLI on both configs, at tiny widths.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tensoir_tpu.data import get_dataset as j_get
from tensoir_tpu.models import lifecycle as JLC
from tensoir_tpu.render import eval as JE
from tensoir_tpu.train import optim as JO
from tensoir_tpu.train import step as JS
from tensoir_tpu.utils import ckpt as JCK

from tensoir_tpu_torch import train_tensoir as TCLI
from tensoir_tpu_torch.data import get_dataset as t_get
from tensoir_tpu_torch.data.synthetic import write_shadow_scene
from tensoir_tpu_torch.examples import train_general_multilight_demo as gdemo
from tensoir_tpu_torch.examples import train_multilight_demo as rdemo
from tensoir_tpu_torch.render import eval as TE
from tensoir_tpu_torch.train import optim as TO
from tensoir_tpu_torch.train import step as TS
from tensoir_tpu_torch.utils import ckpt as TCK

from torch_parity import (jax_field, one_torch_thread,  # noqa: F401
                          port_cfg, port_field, rays, small_cfg, t, to_numpy)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GRID = (24, 20, 16)
B, S = 48, 48
SETTINGS = {
    "rotated": dict(light_num=3, light_rotations=(0, 120, 240)),
    "general": dict(light_num=3, light_rotations=(0, 0, 0),
                    per_light_sg=True),
}
LR_LIGHT = {"rotated": 1e-3, "general": 3e-3}


def _cfg(setting):
    return small_cfg(envmap_h=4, envmap_w=8, **SETTINGS[setting])


@pytest.fixture(scope="module")
def fields():
    """Per setting: (jax cfg, params, scene masked by JAX's
    update_alpha_mask)."""
    out = {}
    for setting in SETTINGS:
        jcfg = _cfg(setting)
        jp, js = jax_field(jcfg, grid=GRID)
        js, _ = JLC.update_alpha_mask(jcfg, jp, js, GRID)
        out[setting] = (jcfg, jp, js)
    return out


def _static(relight):
    if relight:
        return dict(n_samples=S, is_relight=True, white_bg=True, app_cap=8,
                    march_cap=24, deterministic=True, relight_ray_cap=16,
                    second_n_sample=16, secondary_tile=256, second_app_cap=8)
    return dict(n_samples=S, is_relight=False, white_bg=True, app_cap=8,
                deterministic=True)


def _weights(relight):
    if relight:
        return dict(l1=4e-5, rgb_brdf=0.2, normals_diff=5e-4,
                    normals_ori=1e-3, albedo_sm=1e-3, rough_sm=1e-3,
                    lr_factor=0.99997, n_iters=80000, relight_start=10000)
    return dict(l1=8e-5, tv_density=0.05, tv_app=0.005, lr_factor=0.99997,
                n_iters=80000, relight_start=10000)


_j_loss_grad = jax.jit(jax.value_and_grad(JS.compute_loss, argnums=1,
                                          has_aux=True),
                       static_argnums=(0, 6, 7))


@pytest.mark.parametrize("phase", ["radiance", "relight"])
@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_one_step_matches_jax(fields, setting, phase):
    jcfg, jp, js = fields[setting]
    relight = phase == "relight"
    tp, ts = port_field(jp, js)
    rng = np.random.default_rng(7)
    r = rays(B, seed=7)
    lidx = (np.arange(B) % 3).astype(np.int32)
    rgbs = rng.uniform(0, 1, (B, 3)).astype(np.float32)
    it = 10040 if relight else 40
    st, w = _static(relight), _weights(relight)
    (jl, jm), jg = _j_loss_grad(
        jcfg, jp, js, {"rays": jnp.asarray(r), "rgbs": jnp.asarray(rgbs),
                       "light_idx": jnp.asarray(lidx)},
        None, jnp.asarray(it), JS.StepStatic(**st), JS.LossWeights(**w))

    flat = TO.flatten(tp)
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in flat.items()}
    tl, tm = TS.compute_loss(port_cfg(jcfg), TS._unflatten(leaves), ts,
                             {"rays": t(r), "rgbs": t(rgbs),
                              "light_idx": t(lidx, torch.int32)},
                             None, it, TS.StepStatic(**st),
                             TS.LossWeights(**w))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-4)
    for k in ("loss_rgb", "loss_rgb_brdf") if relight else ("loss_rgb",):
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]),
                                   rtol=1e-4, err_msg=k)
    grads = dict(zip(leaves, torch.autograd.grad(
        tl, list(leaves.values()), allow_unused=True)))
    jflat = TO.flatten(jg)
    assert set(grads) == set(jflat)
    reached = {"light_line"} | ({"lgt_sgs"} if relight else set())
    for k, g in grads.items():
        want = np.asarray(jflat[k])
        if g is None:           # the loss does not reach it; JAX's is zero
            assert not np.any(want), k
            continue
        if k in reached:
            assert float(g.abs().max()) > 0, k
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    lgt = jflat["lgt_sgs"]
    assert lgt.shape == ((3, 8, 7) if setting == "general" else (8, 7))
    if relight and setting == "general":
        # every light's SG set is reached by its own rays
        assert all(np.abs(np.asarray(lgt[i])).max() > 0 for i in range(3))

    # one Adam step of each package from the same gradients, the light group
    # at its own rate (a step of 1e-3 in place of 3e-3 would miss by 2e-3)
    jopt = JO.make_optimizer(jp, 0.02, 1e-3, 0.99997,
                             lr_light=LR_LIGHT[setting])
    upd, _ = jopt.update(jg, jopt.init(jp), jp)
    jnew = TO.flatten(optax.apply_updates(jp, upd))
    topt = TO.make_optimizer(tp, 0.02, 1e-3, 0.99997,
                             lr_light=LR_LIGHT[setting])
    state = topt.init(tp)
    topt.update({k: torch.zeros_like(flat[k]) if g is None else g
                 for k, g in grads.items()}, state, tp)
    assert state["count"]["light"] == 1
    for k, v in TO.flatten(tp).items():
        np.testing.assert_allclose(v.detach().numpy(), np.asarray(jnew[k]),
                                   rtol=0, atol=1e-4, err_msg=k)


# scene writer arguments per setting, the loader's dataset name and keywords
SCENES = {
    "rotated": (dict(rotations=("000", "120", "240")),
                "tensoIR_unknown_rotated_lights",
                dict(light_rotation=["000", "120", "240"],
                     light_name="sunset")),
    "general": (dict(light_names=("sunset", "snow", "courtyard")),
                "tensoIR_unknown_general_multi_lights",
                dict(light_name_list=["sunset", "snow", "courtyard"])),
}


def _scene(root, setting, views=(("test", 1, 12),)):
    write_kw, name, load_kw = SCENES[setting]
    write_shadow_scene(str(root / "scene"), str(root / "hdr"), views=views,
                       env_hw=(8, 16), **write_kw)
    return name, load_kw


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_eval_of_each_light_matches_jax(fields, setting, tmp_path):
    name, kw = _scene(tmp_path, setting)
    jds = j_get(name)(str(tmp_path / "scene"), str(tmp_path / "hdr"),
                      split="test", **kw)
    tds = t_get(name)(str(tmp_path / "scene"), str(tmp_path / "hdr"),
                      split="test", **kw)
    item = tds[0]
    assert item["rgbs"].shape == (3, 144, 3)
    # the three images differ: the light turns about the scene
    assert np.abs(item["rgbs"][0] - item["rgbs"][1]).max() > 0.05
    np.testing.assert_array_equal(item["rgbs"], jds[0]["rgbs"])
    np.testing.assert_array_equal(item["light_idx"][:, 0, 0], [0, 1, 2])
    jcfg, jp, js = fields[setting]
    tp, ts = port_field(jp, js)
    ekw = dict(n_samples=96, chunk=64, test_all=True,
               compute_extra_metrics=False, second_n_sample=16,
               secondary_tile=1024)
    seen = set()
    for li in range(3):
        j_res = JE.evaluation_iter(jcfg, jp, js, jds, light_idx_to_test=li,
                                   **ekw)
        t_res = TE.evaluation_iter(port_cfg(jcfg), tp, ts, tds,
                                   light_idx_to_test=li, **ekw)
        assert list(t_res) == list(j_res)
        for k, v in j_res.items():
            assert abs(t_res[k] - v) <= 0.01, (li, k, t_res[k], v)
        seen.add(round(t_res["psnr_nvs_brdf"], 6))
    assert len(seen) == 3           # each light renders its own image


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_three_light_checkpoint_round_trip(fields, setting, tmp_path):
    jcfg, jp, js = fields[setting]
    path = str(tmp_path / "ckpt.npz")
    JCK.save_checkpoint(path, jcfg, to_numpy(jp), to_numpy(js),
                        extra={"iteration": 5})
    tcfg, tp, ts, extra = TCK.load_checkpoint(path, device="cpu")
    assert tcfg == port_cfg(jcfg) and extra["iteration"] == 5
    assert tp["light_line"].shape[0] == 3
    assert tp["lgt_sgs"].shape == ((3, 8, 7) if setting == "general"
                                   else (8, 7))
    jflat = TO.flatten(to_numpy(jp))
    for k, v in TO.flatten(tp).items():
        np.testing.assert_array_equal(v.numpy(), jflat[k], err_msg=k)
    back = str(tmp_path / "back.npz")
    TCK.save_checkpoint(back, tcfg, tp, ts, extra={"iteration": 5})
    jcfg2, jp2, js2, _ = JCK.load_checkpoint(back)
    assert jcfg2 == jcfg
    for k, v in TO.flatten(to_numpy(jp2)).items():
        np.testing.assert_array_equal(v, jflat[k], err_msg=k)
    for k in js:
        np.testing.assert_array_equal(np.asarray(js2[k]), np.asarray(js[k]),
                                      err_msg=k)


TINY = dict(N_voxel_init=12 ** 3, N_voxel_final=16 ** 3,
            n_lamb_sigma=(4, 4, 4), n_lamb_sh=(6, 6, 6), data_dim_color=8,
            featureC=16, numLgtSGs=8, secondary_tile=1024,
            batch_size=64, batch_size_test=64)


@pytest.mark.parametrize("general", [False, True], ids=["rotated", "general"])
def test_demo_runs_and_writes_final_metrics(tmp_path, monkeypatch, general):
    """The demo's configuration (full width, checked here) through its whole
    flow at tiny widths: 10 iterations of 2 views of 12 x 12 under three
    lights, the relight-cap curriculum flipping at 6, then one eval per
    light into final_metrics.json."""
    demo = gdemo if general else rdemo
    cfg = rdemo.demo_config(rdemo.parse_args(["--lr_light", "0.003"]
                                             if general else [], general))
    assert (cfg.n_iters, cfg.N_voxel_final, cfg.upsamp_list,
            cfg.update_AlphaMask_list, cfg.relight_cap_start,
            cfg.fast_march_start, cfg.relight_ray_cap, cfg.numLgtSGs,
            cfg.second_window, cfg.app_bake_reso, cfg.light_num) == (
        4000, 128 ** 3, (1200,), (1200, 1800), 512, 2400, 4096, 64, 48, 64,
        3)
    if general:
        assert (cfg.light_name_list, cfg.lr_light) == (
            ("sunset", "noon", "dusk"), 0.003)
    else:
        assert cfg.light_rotation == ("000", "120", "240")
    full = rdemo.demo_config
    monkeypatch.setattr(rdemo, "demo_config",
                        lambda args: full(args).replace(**TINY))
    out = tmp_path / "demo"
    argv = ["--iters", "10", "--img", "12", "--views", "2",
            "--relight_cap", "16", "--cap_start", "8", "--out", str(out)]
    metrics = demo.main(argv, device="cpu")
    saved = json.loads((out / "final_metrics.json").read_text())
    assert saved == metrics and saved["iters"] == 10
    for li in range(3):
        assert {"psnr_nvs", "psnr_nvs_brdf", "normal_mae_deg"} <= set(
            saved[f"light{li}"])
        assert len(list((out / f"eval_light{li}" / "nvs_with_brdf")
                        .iterdir())) == 3
    assert (out / "ckpt_final.npz").exists()


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_cli_trains_on_the_multilight_scene(setting, tmp_path):
    """The CLI on configs/multi_light_<setting>/armadillo.txt at tiny
    widths, on the writer's three-light scene: it trains through a mask and
    the shrink into the relight phase and evaluates the final test set, per
    light in the general setting (one directory each)."""
    _scene(tmp_path, setting, views=(("train", 2, 16), ("test", 1, 12)))
    cfg = f"configs/multi_light_{setting}/armadillo.txt"
    argv = ["--config", cfg, "--datadir", str(tmp_path / "scene"),
            "--hdrdir", str(tmp_path / "hdr"), "--basedir",
            str(tmp_path / "log"), "--n_iters", "5", "--batch_size", "64",
            "--n_lamb_sigma", "[4,4,4]", "--n_lamb_sh", "[4,4,4]",
            "--data_dim_color", "6", "--featureC", "16",
            "--N_voxel_init", "1728", "--N_voxel_final", "1728",
            "--upsamp_list", "[100]", "--update_AlphaMask_list", "[2]",
            "--nSamples", "32", "--numLgtSGs", "8", "--envmap_h", "2",
            "--envmap_w", "4", "--second_nSample", "8",
            "--relight_ray_cap", "8", "--secondary_tile", "64",
            "--batch_size_test", "64", "--N_vis", "0", "--test_number", "1",
            "--save_iters", "0"]
    res = TCLI.main(argv, device="cpu")
    dirs = (["imgs_test_all"] if setting == "rotated"
            else [f"imgs_test_all_light{li}" for li in range(3)])
    assert sorted(res) == dirs
    assert all(np.isfinite(res[d]["psnr_nvs_brdf"]) for d in dirs)
    fcfg, tp, _, _ = TCK.load_checkpoint(
        str(tmp_path / "log" / "armadillo" / "ckpt_final.npz"), device="cpu")
    assert fcfg.light_num == 3 and tp["light_line"].shape[0] == 3
    assert fcfg.per_light_sg == (setting == "general")
