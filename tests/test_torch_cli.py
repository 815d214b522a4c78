"""The port's training CLI and its synthetic demo, on the CPU at tiny
widths: a config file trains on a rotated-lights scene on disk (the shadow
scene written by ``write_shadow_scene``), evaluates during training,
renders the final test and train sets, and a render-only run reloads the
checkpoint and reproduces the final test metrics exactly. Its parse errors
are the JAX CLI's, word for word; its refusals name their reasons."""
import json
import math
import os

import pytest
import torch

import train_tensoir as JCLI
from tensoir_tpu_torch import train_tensoir as TCLI
from tensoir_tpu_torch.data.synthetic import (write_relight_test_scene,
                                              write_shadow_scene)
from tensoir_tpu_torch.examples import train_synthetic_demo as demo
from tensoir_tpu_torch.train import loop as TL
from tensoir_tpu_torch.utils.bench_scene import seed_solid_blob

from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TINY = """
# the armadillo config's keys at tiny widths
dataset_name = tensoIR_unknown_rotated_lights
expname = tiny
n_iters = 9
batch_size = 128
N_voxel_init = 4096
N_voxel_final = 8000
upsamp_list = [4]
update_AlphaMask_list = [2, 5]
N_vis = 1
vis_every = 3
render_test = 1
test_number = 2
n_lamb_sigma = [4,4,4]
n_lamb_sh = [6,6,6]
data_dim_color = 8
featureC = 16
nSamples = 48
numLgtSGs = 8
envmap_h = 4
envmap_w = 8
second_nSample = 16
relight_ray_cap = 16
secondary_tile = 256
batch_size_test = 64
save_iters = 0
progress_refresh_rate = 1
light_rotation = [000]
light_name = sunset
"""


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One training run through the CLI (blob-seeded field), shared."""
    root = tmp_path_factory.mktemp("cli")
    write_shadow_scene(str(root / "scene"), str(root / "hdr"),
                       views=(("train", 2, 24), ("test", 2, 12)),
                       env_hw=(16, 32))
    (root / "tiny.txt").write_text(TINY)
    argv = ["--config", str(root / "tiny.txt"), "--datadir",
            str(root / "scene"), "--hdrdir", str(root / "hdr"), "--basedir",
            str(root / "log")]
    init = TL.init_field_params
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TL, "init_field_params", lambda *a, **kw: (
            lambda p, s: (seed_solid_blob(p, amp=4.0, sharp=0.2), s))(
                *init(*a, **kw)))
        results = TCLI.main(argv + ["--render_train", "1"], device="cpu")
    return dict(root=root, argv=argv, results=results,
                logdir=root / "log" / "tiny")


def test_cli_trains_evaluates_and_writes_the_artifacts(run):
    res, logdir = run["results"], run["logdir"]
    assert set(res) == {"imgs_test_all", "imgs_train_all"}
    assert {"psnr_nvs", "ssim_nvs", "normal_mae_deg",
            "psnr_albedo_single"} <= set(res["imgs_test_all"])
    assert "ssim_nvs" not in res["imgs_train_all"]
    # relight from the first mask (2); evals at it % 3 == 2 from then on
    lines = (logdir / "imgs_vis" / "metrics_record.txt").read_text()
    assert [ln.split(":")[1] for ln in lines.splitlines()] == [
        "000002", "000005", "000008"]
    for sub in ("nvs_with_radiance_field", "nvs_with_brdf", "normal", "brdf",
                "acc_map"):
        assert sorted(os.listdir(logdir / "imgs_test_all" / sub)) == [
            "000.png", "001.png"]
        assert len(os.listdir(logdir / "imgs_vis" / sub)) == 3
    for f in ("ckpt_final.npz", "config.txt", "metrics.jsonl",
              "imgs_test_all/envir_map/envirmap.png",
              "imgs_train_all/metrics_record.txt"):
        assert (logdir / f).exists(), f
    evals = [json.loads(x) for x in
             (logdir / "metrics.jsonl").read_text().splitlines()
             if "eval/psnr_nvs" in x]
    assert [e["step"] for e in evals] == [2, 5, 8]
    assert res["imgs_test_all"]["psnr_nvs"] != res["imgs_test_all"][
        "psnr_nvs_brdf"]           # some rays are relit


def test_cli_render_only_reproduces_the_final_test_metrics(run):
    again = TCLI.main(run["argv"] + [
        "--render_only", "1", "--render_test", "1", "--ckpt",
        str(run["logdir"] / "ckpt_final.npz")], device="cpu")
    assert again == {"imgs_test_all": run["results"]["imgs_test_all"]}
    lines = (run["logdir"] / "imgs_test_all" /
             "metrics_record.txt").read_text().splitlines()
    assert len(lines) == 2 and lines[0] == lines[1]


def test_cli_parse_errors_match_the_jax_cli(tmp_path):
    cases = [["--no_such_key", "1"], ["--n_iters"], ["stray"],
             ["--light_rotation", "[000,120]", "--n_iters"]]
    for argv in cases:
        with pytest.raises(SystemExit) as j:
            JCLI.parse_cli(argv)
        with pytest.raises(SystemExit) as t:
            TCLI.parse_cli(argv)
        assert str(t.value) == str(j.value) and str(j.value), argv
    cfg = TCLI.parse_cli(["--light_rotation", "[000,120]", "--n_iters", "7",
                          "--lr_init", "1"])
    jcfg = JCLI.parse_cli(["--light_rotation", "[000,120]", "--n_iters", "7",
                           "--lr_init", "1"])
    assert (cfg.light_rotation, cfg.n_iters, cfg.lr_init) == (
        jcfg.light_rotation, jcfg.n_iters, jcfg.lr_init) == (
        ("000", "120"), 7, 1.0)


def test_cli_refusals(run, tmp_path, monkeypatch):
    # mesh export is ported: the flag parses (test_torch_mesh.py runs it)
    assert TCLI.parse_cli(["--export_mesh", "1"]).export_mesh == 1
    with pytest.raises(SystemExit, match="train_tensoir.py:73"):
        TCLI.parse_cli(["--dataset_name", "synthetic_sphere"])
    with pytest.raises(SystemExit, match="synthetic-orbit support"):
        TCLI.main(run["argv"] + ["--render_only", "1", "--render_path", "1",
                                 "--ckpt", str(run["logdir"] /
                                               "ckpt_final.npz")],
                  device="cpu")
    # a relighting test set loads; training on one fails in both CLIs at
    # its missing training rays (each train loop reads dataset.all_rays)
    argv = run["argv"] + ["--dataset_name", "tensoIR_relighting_test"]
    with pytest.raises(AttributeError, match="all_rays"):
        TCLI.main(argv, device="cpu")
    # the JAX CLI turns on its persistent compile cache: keep it in tmp_path
    # and put the cache settings back afterwards
    import jax
    monkeypatch.setenv("TENSOIR_COMPILE_CACHE", str(tmp_path / "xla"))
    saved = {k: getattr(jax.config, k) for k in (
        "jax_compilation_cache_dir",
        "jax_persistent_cache_min_compile_time_secs")}
    try:
        with pytest.raises(AttributeError, match="all_rays"):
            JCLI.main(argv)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    # and render-only evaluates on one (under its first light's images)
    relit = run["root"] / "relight_set"
    write_relight_test_scene(str(relit / "scene"), str(relit / "hdr"),
                             n_views=1, size=12, env_hw=(16, 32),
                             gt_env_hw=(8, 16))
    res = TCLI.main(run["argv"] + [
        "--dataset_name", "tensoIR_relighting_test", "--datadir",
        str(relit / "scene"), "--hdrdir", str(relit / "hdr"), "--basedir",
        str(relit / "log"), "--render_only", "1", "--render_test", "1",
        "--ckpt", str(run["logdir"] / "ckpt_final.npz")], device="cpu")
    assert math.isfinite(res["imgs_test_all"]["psnr_nvs"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TCLI.main(run["argv"])


def test_demo_runs_and_writes_final_metrics(tmp_path, monkeypatch):
    """The demo's configuration (full width, checked here) through its whole
    flow at tiny widths: 8 iterations of 2 views of 12 x 12 (the schedule
    scales with the iterations: upsamples at 1 and 4, masks at 1, 2 and
    4), then the eval of its 4 test views into final_metrics.json."""
    cfg = demo.demo_config(demo.parse_args(["--iters", "8"]))
    assert (cfg.n_lamb_sh, cfg.featureC, cfg.N_voxel_final, cfg.upsamp_list,
            cfg.update_AlphaMask_list, cfg.secondary_tile,
            cfg.batch_size_test) == (
        (48, 48, 48), 128, 160 ** 3, (1, 4), (1, 2, 4), 32768, 4096)
    full = demo.demo_config

    def tiny(args):
        return full(args).replace(
            N_voxel_init=12 ** 3, N_voxel_final=16 ** 3,
            n_lamb_sigma=(4, 4, 4), n_lamb_sh=(6, 6, 6), data_dim_color=8,
            featureC=16, numLgtSGs=8, secondary_tile=1024,
            batch_size_test=64)
    monkeypatch.setattr(demo, "demo_config", tiny)
    out = tmp_path / "demo"
    metrics = demo.main(["--iters", "8", "--img", "12", "--views", "2",
                         "--batch", "64", "--relight_cap", "16", "--out",
                         str(out)], device="cpu")
    saved = json.loads((out / "final_metrics.json").read_text())
    assert saved == metrics and saved["iters"] == 8
    assert {"psnr_nvs", "psnr_nvs_brdf", "ssim_nvs", "normal_mae_deg",
            "psnr_albedo_single", "psnr_albedo_three",
            "train_time_s"} <= set(saved)
    assert (out / "ckpt_final.npz").exists()
    assert len(os.listdir(out / "eval" / "nvs_with_brdf")) == 4
    # the grouped marches run: the primary with a cap below the tiny
    # march's samples, so that it groups; the secondary on a window march
    monkeypatch.setattr(demo, "demo_config", lambda args: tiny(args).replace(
        march_cap_primary=32))
    grouped = demo.main(["--iters", "8", "--img", "12", "--views", "2",
                         "--batch", "64", "--relight_cap", "16",
                         "--primary_group", "2", "--march_group", "2",
                         "--group_bake", "8", "--window", "8",
                         "--window_back", "4", "--out", str(tmp_path / "g")],
                        device="cpu")
    assert math.isfinite(grouped["psnr_nvs_brdf"])
