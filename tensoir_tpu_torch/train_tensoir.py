"""The training CLI of the port (counterpart of the JAX package's
``train_tensoir.py``): load a reference-format config, train, evaluate
during training and at the end, or evaluate a checkpoint.

Usage:
  python -m tensoir_tpu_torch.train_tensoir --config configs/single_light/armadillo.txt
  python -m tensoir_tpu_torch.train_tensoir --config ... --render_only 1 --render_test 1 --ckpt <ckpt_final.npz>
  python -m tensoir_tpu_torch.train_tensoir --config ... --export_mesh 1 --ckpt <ckpt_final.npz>
  python -m torch.distributed.run --nproc_per_node N -m tensoir_tpu_torch.train_tensoir --config ...

Under the launcher (one process per GPU) the run trains data-parallel over
the N cards, each on ``batch_size // N`` rays of its own share per step;
only rank 0 writes the logs, checkpoints and renders.

Any config key can be overridden as ``--key value``. It runs on the card;
``main(argv, device="cpu")`` runs it on the CPU from Python (there is no
flag for the device). ``--export_mesh 1`` writes the checkpoint's mesh
(level 0.005) beside it, then stops unless ``render_only`` or
``render_test`` is set, as the JAX CLI does. Refused at parse time:
``dataset_name = synthetic_sphere``, which the JAX CLI cannot build either
(it passes the data directories positionally into the scene's (split,
n_views)); the synthetic scenes run through ``tensoir_tpu_torch.examples``.
"""
from __future__ import annotations

import argparse
import dataclasses
import inspect
import os
import sys

import numpy as np

from tensoir_tpu_torch.config import (TensoIRConfig, _coerce, _parse_value,
                                      load_config)
from tensoir_tpu_torch.data import get_dataset
from tensoir_tpu_torch.device import DeviceLike, resolve_device
from tensoir_tpu_torch.parallel import multihost


def parse_cli(argv=None) -> TensoIRConfig:
    parser = argparse.ArgumentParser(add_help=True)
    parser.add_argument("--config", type=str, default=None)
    known, rest = parser.parse_known_args(argv)

    overrides = {}
    fields = {f.name: f for f in dataclasses.fields(TensoIRConfig)}
    i = 0
    while i < len(rest):
        tok = rest[i]
        if not tok.startswith("--"):
            raise SystemExit(f"unexpected argument: {tok}")
        key = tok[2:]
        if key not in fields:
            raise SystemExit(f"unknown config key: --{key}")
        if i + 1 >= len(rest):
            raise SystemExit(f"--{key} needs a value (config keys are "
                             f"key/value pairs, e.g. --{key} 1)")
        overrides[key] = _coerce(key, _parse_value(rest[i + 1]), fields)
        i += 2
    cfg = load_config(known.config, overrides)
    if cfg.dataset_name == "synthetic_sphere":
        raise SystemExit(
            "dataset_name = synthetic_sphere: the JAX CLI passes datadir and "
            "hdrdir positionally into SyntheticSphereDataset(split, n_views) "
            "(train_tensoir.py:73), so neither CLI builds it; run the "
            "synthetic scenes with python -m "
            "tensoir_tpu_torch.examples.train_synthetic_demo")
    return cfg


def build_dataset(cfg: TensoIRConfig, split: str):
    cls = get_dataset(cfg.dataset_name)
    kw = dict(
        split=split,
        downsample=(cfg.downsample_train if split == "train"
                    else cfg.downsample_test),
        light_rotation=list(cfg.light_rotation),
        light_name=cfg.light_name,
    )
    if (split == "test" and cfg.test_number > 0
            and "sub" in inspect.signature(cls.__init__).parameters):
        # the reference caps the test split at test_number views
        kw["sub"] = cfg.test_number
    if cfg.light_name_list:
        kw["light_name_list"] = list(cfg.light_name_list)
    if cfg.scene_bbox:
        kw["scene_bbox"] = np.asarray(cfg.scene_bbox, np.float32).reshape(2, 3)
    if cfg.dataset_name == "blender":
        return cls(cfg.datadir, split=kw["split"], downsample=kw["downsample"])
    return cls(cfg.datadir, cfg.hdrdir, **kw)


def render_orbit_path(cfg, fcfg, params, scene, n_samples, logfolder):
    """--render_path: orbit frames from a dataset that makes synthetic
    orbit poses (test_new_pose); any other dataset is refused."""
    from tensoir_tpu_torch.render.eval import evaluation_path
    cls = get_dataset(cfg.dataset_name)
    if "test_new_pose" not in inspect.signature(cls.__init__).parameters:
        raise SystemExit(
            f"--render_path needs a dataset with synthetic-orbit support "
            f"(test_new_pose); {cfg.dataset_name} has none")
    kw = dict(split="test", downsample=cfg.downsample_test,
              light_rotation=list(cfg.light_rotation),
              light_name=cfg.light_name, test_new_pose=True,
              n_orbit=cfg.n_orbit)
    if cfg.scene_bbox:
        kw["scene_bbox"] = np.asarray(cfg.scene_bbox, np.float32).reshape(2, 3)
    path_dataset = cls(cfg.datadir, cfg.hdrdir, **kw)
    n = evaluation_path(
        fcfg, params, scene, path_dataset, n_samples=n_samples,
        save_path=os.path.join(logfolder, "imgs_path_all"),
        chunk=cfg.batch_size_test, second_n_sample=cfg.second_nSample,
        secondary_tile=cfg.secondary_tile, ndc_ray=bool(cfg.ndc_ray))
    print(f"======> {cfg.expname} path: {n} frames -> imgs_path_all")
    return n


def _eval_kw(cfg: TensoIRConfig) -> dict:
    """The evaluation knobs every evaluation of the CLI shares."""
    return dict(chunk=cfg.batch_size_test, second_n_sample=cfg.second_nSample,
                secondary_tile=cfg.secondary_tile,
                fast_march=bool(cfg.eval_fast), ndc_ray=bool(cfg.ndc_ray))


def main(argv=None, device: DeviceLike = None) -> dict:
    """Run the CLI with ``argv`` (None: ``sys.argv[1:]``) on ``device``
    (None: the card). Returns each final evaluation's metrics under the
    name of its output directory (``imgs_test_all``, ...), for
    ``--render_path`` the frames written under ``imgs_path_all``, and for
    ``--export_mesh`` the PLY's path under ``mesh``.

    Under a launcher it joins the process group first (a no-op without
    one, or when the caller made the group) and leaves the group it made
    at the end; only rank 0 renders and exports, and returns what they
    made (the other ranks return ``{}``)."""
    cfg = parse_cli(argv)
    dev = resolve_device(device)
    owns_group = multihost.initialize(device=dev)
    try:
        return _main(cfg, dev)
    finally:
        if owns_group:
            multihost.shutdown()


def _main(cfg: TensoIRConfig, dev) -> dict:
    from tensoir_tpu_torch.models.field import grid_size_of
    from tensoir_tpu_torch.models.lifecycle import cal_n_samples
    from tensoir_tpu_torch.render.eval import evaluation_iter
    from tensoir_tpu_torch.utils.ckpt import load_checkpoint

    logfolder = os.path.join(cfg.basedir, cfg.expname)
    out = {}
    is_main = multihost.process_index() == 0

    if cfg.export_mesh and is_main:
        from tensoir_tpu_torch.scripts.export_mesh import export_checkpoint
        out["mesh"], _, _ = export_checkpoint(cfg.ckpt, 0.005, dev)
        print(f"mesh written to {out['mesh']}")
    if cfg.export_mesh and not (cfg.render_only or cfg.render_test):
        return out

    if cfg.render_only and (cfg.render_test or cfg.render_train
                            or cfg.render_path):
        if not is_main:
            return out
        fcfg, params, scene, _ = load_checkpoint(cfg.ckpt, device=dev)
        n_samples = min(cfg.nSamples,
                        cal_n_samples(grid_size_of(params), cfg.step_ratio))
        if cfg.render_test:
            results = evaluation_iter(
                fcfg, params, scene, build_dataset(cfg, "test"),
                n_samples=n_samples,
                save_path=os.path.join(logfolder, "imgs_test_all"),
                test_all=True, **_eval_kw(cfg))
            out["imgs_test_all"] = results
            print(results)
        if cfg.render_train:
            results = evaluation_iter(
                fcfg, params, scene, build_dataset(cfg, "train"),
                n_samples=n_samples,
                save_path=os.path.join(logfolder, "imgs_train_all"),
                test_all=True, compute_extra_metrics=False, **_eval_kw(cfg))
            out["imgs_train_all"] = results
            print(f"======> {cfg.expname} train all: {results}")
        if cfg.render_path:
            out["imgs_path_all"] = render_orbit_path(
                cfg, fcfg, params, scene, n_samples, logfolder)
        return out

    # ---- training ----
    from tensoir_tpu_torch.train.loop import reconstruction

    train_dataset = build_dataset(cfg, "train")
    test_dataset = build_dataset(cfg, "test")

    def eval_cb(fcfg, params, scene, it, n_samples, logger=None):
        # an eval that fails ends the run with its error (the JAX CLI
        # prints it and trains on)
        results = evaluation_iter(
            fcfg, params, scene, test_dataset, n_samples=n_samples,
            save_path=os.path.join(logfolder, "imgs_vis"),
            prtx=f"{it:06d}_", n_vis=cfg.N_vis, compute_extra_metrics=False,
            logger=logger, log_step=it, **_eval_kw(cfg))
        print(f"[eval @{it}] {results}", flush=True)

    result = reconstruction(
        cfg, train_dataset, log_dir=logfolder,
        eval_fn=eval_cb if cfg.N_vis != 0 else None,
        progress_cb=lambda it, m: print(
            f"it {it:06d} psnr {m.get('psnr', 0):.2f} "
            f"loss {m.get('total_loss', 0):.5f}", flush=True)
        if it % (cfg.progress_refresh_rate * 10) == 0 and is_main else None,
        device=dev)
    if not is_main:
        return out

    if cfg.render_test:
        # general multi-light: each learned light on its own, into its own
        # directory; other settings: light 0
        light_indices = range(cfg.light_num) if cfg.light_name_list else [0]
        for li in light_indices:
            suffix = f"_light{li}" if cfg.light_name_list else ""
            results = evaluation_iter(
                result.fcfg, result.params, result.scene, test_dataset,
                n_samples=result.n_samples,
                save_path=os.path.join(logfolder, f"imgs_test_all{suffix}"),
                test_all=True, light_idx_to_test=li, **_eval_kw(cfg))
            out[f"imgs_test_all{suffix}"] = results
            print(f"======> {cfg.expname} test all{suffix}: {results}")

    if cfg.render_train:
        results = evaluation_iter(
            result.fcfg, result.params, result.scene,
            build_dataset(cfg, "train"), n_samples=result.n_samples,
            save_path=os.path.join(logfolder, "imgs_train_all"),
            test_all=True, compute_extra_metrics=False, **_eval_kw(cfg))
        out["imgs_train_all"] = results
        print(f"======> {cfg.expname} train all: {results}")

    if cfg.render_path:
        out["imgs_path_all"] = render_orbit_path(
            cfg, result.fcfg, result.params, result.scene, result.n_samples,
            logfolder)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
