"""The port stands alone: it imports nothing of JAX, of tensoir_tpu, or of
PIL, imageio and cv2 (the machine with the card has none of the last
three), and runs a radiance, a relight and a fast-knob relight training
step, a tiny relighting benchmark on a relighting test set written to
disk, a 3-iteration training run through an alpha-mask and shrink event
that writes and reads back its checkpoint, and a tiny run of the training
CLI on a scene written to disk (the loaders, evals during training, the
final render_test, a render-only run from the checkpoint), on the CPU in a
process where none of them can be imported."""
import re
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = re.compile(
    r"^\s*(from|import)\s+(jax|tensoir_tpu|PIL|imageio|cv2)(\.|\s|$)",
    re.MULTILINE)

STEP = textwrap.dedent("""
    import sys
    for name in ("jax", "jaxlib", "tensoir_tpu", "PIL", "imageio", "cv2"):
        sys.modules[name] = None          # any import of them now fails
    import math
    import torch
    torch.set_num_threads(1)
    from tensoir_tpu_torch.models.field import FieldConfig, init_field_params
    from tensoir_tpu_torch.train.optim import make_optimizer
    from tensoir_tpu_torch.train.step import (LossWeights, StepStatic,
                                              make_train_step)
    from tensoir_tpu_torch.utils.bench_scene import bench_rays, seed_solid_blob
    from tensoir_tpu_torch.models.lifecycle import update_alpha_mask
    cfg = FieldConfig(density_n_comp=(4, 4, 4), app_n_comp=(6, 6, 6),
                      app_dim=8, feature_c=16, num_sgs=8, envmap_h=4,
                      envmap_w=8)
    params, scene = init_field_params(torch.Generator().manual_seed(0), cfg,
                                      (16, 16, 16), [[-1.5] * 3, [1.5] * 3],
                                      device="cpu")
    seed_solid_blob(params, amp=4.0, sharp=0.2)
    opt = make_optimizer(params, 0.02, 1e-3, 0.999)
    step = make_train_step(cfg, opt, StepStatic(n_samples=32,
                           is_relight=False, white_bg=True, app_cap=8),
                           LossWeights(l1=8e-5, tv_density=0.05), device="cpu")
    batch = {"rays": bench_rays(32, spread=0.2), "light_idx": [0] * 32,
             "rgbs": torch.full((32, 3), 0.5)}
    params, state, m = step(params, opt.init(params), scene, batch,
                            torch.Generator().manual_seed(1), 0)
    assert math.isfinite(float(m["total_loss"]))
    assert state["count"]["spatial"] == 1
    # the relight phase: alpha mask, culled march, BRDF, derived normals,
    # baked secondary march
    scene, _ = update_alpha_mask(cfg, params, scene, (16, 16, 16))
    step = make_train_step(cfg, opt, StepStatic(
        n_samples=32, is_relight=True, white_bg=True, app_cap=8,
        march_cap=16, relight_ray_cap=8, second_n_sample=16,
        secondary_tile=128), LossWeights(l1=4e-5), device="cpu")
    params, state, m = step(params, state, scene, batch,
                            torch.Generator().manual_seed(2), 10000)
    assert math.isfinite(float(m["total_loss"]))
    assert math.isfinite(float(m["loss_rgb_brdf"]))
    assert float(m["n_acc_masked"]) > 0
    # bench.py's fast knobs: resized bake, window march over the coarse
    # occupancy, hemisphere compaction, baked appearance, the sec/* stats
    step = make_train_step(cfg, opt, StepStatic(
        n_samples=32, is_relight=True, white_bg=True, app_cap=8,
        march_cap=16, relight_ray_cap=8, second_n_sample=16,
        secondary_tile=128, secondary_bake_reso=12, second_window=12,
        second_window_back=4, second_prepass_n=8, coarse_dilate=3,
        secondary_compact_frac=0.5625, app_bake_reso=12, second_app_cap=6,
        app_pair_frac=0.4375, secondary_stats=True),
        LossWeights(l1=4e-5), device="cpu")
    params, state, m = step(params, state, scene, batch,
                            torch.Generator().manual_seed(3), 10001)
    assert math.isfinite(float(m["total_loss"]))
    assert 0.0 <= float(m["sec/app_pair_occupancy"])
    # relighting: a relighting test set on disk, its loader, the held-out
    # light, and a tiny benchmark with its artifact tree
    import os
    import tempfile
    from tensoir_tpu_torch.data import get_dataset
    from tensoir_tpu_torch.data.synthetic import write_relight_test_scene
    from tensoir_tpu_torch.models.env_light import EnvironmentLight
    from tensoir_tpu_torch.render.relight_pipeline import relight_benchmark
    with tempfile.TemporaryDirectory() as tmp:
        write_relight_test_scene(os.path.join(tmp, "s"),
                                 os.path.join(tmp, "h"), lights=("city",),
                                 n_views=1, size=12, env_hw=(8, 16),
                                 gt_env_hw=(4, 8))
        rds = get_dataset("tensoIR_relighting_test")(
            os.path.join(tmp, "s"), os.path.join(tmp, "h"), split="test",
            light_names=("city",))
        res = relight_benchmark(
            cfg, params, scene, rds,
            EnvironmentLight(os.path.join(tmp, "h"), device="cpu"),
            n_samples=32, save_path=os.path.join(tmp, "out"), chunk=64,
            n_light_samples=8, second_n_sample=16, vis_tile=256)
        assert math.isfinite(res["city"]["psnr"])
        assert os.path.exists(os.path.join(
            tmp, "out", "test_000", "relighting_with_bg", "city.png"))
    # a whole training run: 3 iterations with the alpha mask and shrink at
    # the second, and a checkpoint written and read back
    import tensoir_tpu_torch.profiling  # noqa: F401
    import tensoir_tpu_torch.utils.tb_writer  # noqa: F401
    from tensoir_tpu_torch.config import TensoIRConfig
    from tensoir_tpu_torch.data.synthetic import SyntheticShadowDataset
    from tensoir_tpu_torch.models.field import grid_size_of
    from tensoir_tpu_torch.models.lifecycle import (filter_rays_mask, shrink,
                                                    upsample)
    from tensoir_tpu_torch.train.loop import reconstruction
    from tensoir_tpu_torch.utils.ckpt import load_checkpoint
    ds = get_dataset("synthetic_sphere")(split="train", n_views=2,
                                         img_wh=(16, 16))
    assert SyntheticShadowDataset(n_views=1, img_wh=(4, 4)).all_rays.shape \
        == (16, 6)
    run_cfg = TensoIRConfig(
        n_iters=3, batch_size=64, n_lamb_sigma=(4, 4, 4),
        n_lamb_sh=(4, 4, 4), data_dim_color=6, featureC=16,
        N_voxel_init=12 ** 3, N_voxel_final=12 ** 3, upsamp_list=(100,),
        update_AlphaMask_list=(1,), step_ratio=2.0, nSamples=32,
        numLgtSGs=8, envmap_h=2, envmap_w=4, second_nSample=8,
        relight_ray_cap=8, secondary_tile=64, save_iters=0,
        progress_refresh_rate=1)
    with tempfile.TemporaryDirectory() as tmp:
        res = reconstruction(run_cfg, ds, log_dir=tmp, device="cpu")
        assert len(res.metrics_history) == 3
        assert all(math.isfinite(h["total_loss"]) for h in res.metrics_history)
        assert "loss_rgb_brdf" in res.metrics_history[-1]
        fcfg, params, scene_ck, extra = load_checkpoint(
            os.path.join(tmp, "ckpt_final.npz"), device="cpu")
        assert extra["train_state"]["iteration"] == 3
        assert extra["train_state"]["relight"]
        assert grid_size_of(params) == grid_size_of(res.params)
        assert torch.equal(scene_ck["aabb"], res.scene["aabb"])
        assert os.path.exists(os.path.join(tmp, "metrics.jsonl"))
    # the training CLI on a rotated-lights scene on disk: PNG and RGBE
    # loaders, evals during training, the final render_test, render-only
    from tensoir_tpu_torch import train_tensoir
    from tensoir_tpu_torch.data.synthetic import write_shadow_scene
    with tempfile.TemporaryDirectory() as tmp:
        write_shadow_scene(os.path.join(tmp, "scene"),
                           os.path.join(tmp, "hdr"),
                           views=(("train", 2, 16), ("test", 1, 12)),
                           env_hw=(8, 16))
        argv = ["--config", "configs/single_light/armadillo.txt",
                "--datadir", os.path.join(tmp, "scene"),
                "--hdrdir", os.path.join(tmp, "hdr"), "--basedir", tmp,
                "--n_iters", "4", "--batch_size", "64",
                "--n_lamb_sigma", "[4,4,4]", "--n_lamb_sh", "[4,4,4]",
                "--data_dim_color", "6", "--featureC", "16",
                "--N_voxel_init", "1728", "--N_voxel_final", "1728",
                "--upsamp_list", "[100]", "--update_AlphaMask_list", "[1]",
                "--nSamples", "32", "--numLgtSGs", "8", "--envmap_h", "2",
                "--envmap_w", "4", "--second_nSample", "8",
                "--relight_ray_cap", "8", "--secondary_tile", "64",
                "--batch_size_test", "64", "--vis_every", "2",
                "--N_vis", "1", "--test_number", "1"]
        res = train_tensoir.main(argv, device="cpu")
        run = os.path.join(tmp, "armadillo")
        assert len(open(os.path.join(run, "imgs_vis",
                                     "metrics_record.txt")).readlines()) == 2
        assert os.path.exists(os.path.join(run, "imgs_test_all", "acc_map",
                                           "000.png"))
        again = train_tensoir.main(argv + [
            "--render_only", "1", "--render_test", "1", "--ckpt",
            os.path.join(run, "ckpt_final.npz")], device="cpu")
        assert again == res and math.isfinite(res["imgs_test_all"]["psnr_nvs"])
    assert not any(k.split(".")[0] in ("jax", "tensoir_tpu", "PIL", "imageio",
                                       "cv2")
                   for k, v in sys.modules.items() if v is not None)
    print("ok")
""")


def test_port_runs_a_step_with_jax_unimportable():
    out = subprocess.run([sys.executable, "-c", STEP], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


def test_no_port_file_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "tensoir_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if FORBIDDEN.search(f.read_text())]
    assert offenders == []
