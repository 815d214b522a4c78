"""The port's training loop against the JAX package's, on the CPU.

Both ``reconstruction``s train the same tiny ``SyntheticSphereDataset``
from the same initial field (JAX's, blob seeded, handed to the port as
numpy) with deterministic steps (no jitter, white background), through a
schedule that hits every event within 12 iterations: the alpha mask,
shrink, relight switch and upsample (2, as the reference's first event
at 10,000), a periodic checkpoint (5), and the mask refresh with the ray
refilter and the fast-march flip, which keeps Adam's state (6). The JAX
loop compiles its step three times. The events run on host values, so grids,
sample counts, AABBs, keep masks and the steps built are equal. The
numbers are held within tolerances that grow with the steps they follow.
The two packages sum in other orders (1.5e-5 relative in the first loss),
and Adam divides each gradient by its own running size, so an element
whose gradient nearly cancels between steps takes a step of another size
on each side: after 12 steps a few density elements are up to 0.09 apart.
- metrics 2e-3 relative (largest seen 6.7e-4, the normal and BRDF terms);
- every final parameter array, Adam moment and checkpoint array within
  5e-2 of its norm, in the L2 norm (largest seen 2.4e-2, a z line of the
  shrunk and upsampled grid; the planes 8.7e-3);
- what the two trained fields render: rgb and acc within 5e-3 (largest
  seen 7.9e-4);
- the scene (AABB, masks) and the checkpoints' headers, masks and scene
  arrays: equal.
Port-only checks: a ``resume_full`` run of 6 + 6 iterations equals one of
12 (bit for bit, with the step's randomness on), the stop file, and the
options the port refuses (``mesh_data`` > 1 in one process, which names
the launcher; the data-parallel runs are in test_torch_parallel.py).
"""
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensoir_tpu.config import TensoIRConfig as JConfig
from tensoir_tpu.data.synthetic import SyntheticSphereDataset as JDataset
from tensoir_tpu.models import field as JF
from tensoir_tpu.models import lifecycle as JLC
from tensoir_tpu.train import loop as JL
from tensoir_tpu.utils.bench_scene import seed_solid_blob

from tensoir_tpu_torch.config import TensoIRConfig as TConfig
from tensoir_tpu_torch.data.synthetic import SyntheticSphereDataset
from tensoir_tpu_torch.models import lifecycle as TLC
from tensoir_tpu_torch.models.field import grid_size_of
from tensoir_tpu_torch.train import loop as TL
from tensoir_tpu_torch.utils.bench_scene import seed_solid_blob as seed_blob
from tensoir_tpu_torch.utils.ckpt import load_checkpoint
from tensoir_tpu_torch.weights import params_from_numpy

from tensoir_tpu_torch.render.primary import render_rays as t_render_rays

from torch_parity import j_render_rays, t, to_numpy

SCHEDULE = dict(
    n_iters=12, batch_size=128, n_lamb_sigma=(4, 4, 4), n_lamb_sh=(6, 6, 6),
    data_dim_color=8, featureC=16, N_voxel_init=16 ** 3,
    N_voxel_final=20 ** 3, upsamp_list=(2,), update_AlphaMask_list=(2, 6),
    step_ratio=2.0, nSamples=48, numLgtSGs=8, envmap_h=4, envmap_w=8,
    second_nSample=16, app_cap_per_ray=8, relight_ray_cap=16,
    relight_cap_start=4, secondary_tile=256, second_window=12,
    second_window_back=4, second_prepass_n=8, coarse_dilate=3,
    app_bake_reso=12, fast_march_start=6, vis_every=4, save_iters=5,
    progress_refresh_rate=1)
METRIC_RTOL = 2e-3
ARRAY_REL_L2 = 5e-2
RENDER_ATOL = 5e-3


def _dataset(cls=SyntheticSphereDataset):
    return cls(split="train", n_views=4, img_wh=(16, 16))


def _record_events(monkeypatch, lc, log):
    """Log the grid and AABB after each lifecycle event of module ``lc``."""
    def wrap(name, fn):
        def run(*a, **kw):
            out = fn(*a, **kw)
            if name == "update_alpha_mask":
                log.append((name, tuple(out[0]["alpha_volume"].shape),
                            np.asarray(out[1], np.float32).tolist()))
            elif name == "shrink":
                log.append((name, tuple(int(g) for g in
                                        lc.F.grid_size_of(out[0])),
                            np.asarray(out[1]["aabb"]).tolist()))
            elif name == "upsample":
                log.append((name, tuple(int(g) for g in
                                        lc.F.grid_size_of(out)), None))
            else:   # filter_rays_bbox
                log.append((name, int(np.sum(out)), None))
            return out
        monkeypatch.setattr(lc, name, run)
    for name in ("update_alpha_mask", "shrink", "upsample",
                 "filter_rays_bbox"):
        wrap(name, getattr(lc, name))


def _deterministic_steps(monkeypatch, loop_mod, log):
    """Every step the loop builds is deterministic; log its static knobs."""
    cls = loop_mod.StepStatic

    def build(**kw):
        st = cls(**kw, deterministic=True)
        log.append((st.n_samples, st.is_relight, st.second_window,
                    st.app_bake_reso, st.relight_ray_cap,
                    st.second_window_probe))
        return st
    monkeypatch.setattr(loop_mod, "StepStatic", build)


def _assert_rel_l2(a, b, what):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape, what
    err = np.linalg.norm(a - b)
    assert err <= ARRAY_REL_L2 * np.linalg.norm(b), (what, err)


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_reconstruction_matches_jax(monkeypatch, tmp_path):
    init = {}

    def j_init(key, fcfg, reso, aabb, gt_envmap=None):
        params, scene = JF.init_field_params(key, fcfg, tuple(reso), aabb)
        params = seed_solid_blob(dict(params), amp=4.0, sharp=0.2)
        init["params"], init["scene"] = to_numpy(params), to_numpy(scene)
        return params, scene

    def t_init(gen, fcfg, reso, aabb, device=None, gt_envmap=None):
        # JAX's scene holds the dataset's probe already, when it has one
        return params_from_numpy(init["params"], init["scene"],
                                 device=device)

    monkeypatch.setattr(JL, "init_field_params", j_init)
    monkeypatch.setattr(TL, "init_field_params", t_init)
    logs = {side: {"events": [], "steps": [], "evals": []}
            for side in ("jax", "port")}
    _record_events(monkeypatch, JLC, logs["jax"]["events"])
    _record_events(monkeypatch, TLC, logs["port"]["events"])
    _deterministic_steps(monkeypatch, JL, logs["jax"]["steps"])
    _deterministic_steps(monkeypatch, TL, logs["port"]["steps"])

    def eval_fn(side, grid_of):
        def run(fcfg, params, scene, it, n_samples, logger=None):
            logs[side]["evals"].append(
                (it, n_samples, tuple(int(g) for g in grid_of(params))))
        return run

    j_dir, t_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jr = JL.reconstruction(JConfig(**SCHEDULE), JDataset(
        split="train", n_views=4, img_wh=(16, 16)), log_dir=j_dir,
        eval_fn=eval_fn("jax", JF.grid_size_of))
    tr = TL.reconstruction(TConfig(**SCHEDULE), _dataset(), log_dir=t_dir,
                           eval_fn=eval_fn("port", grid_size_of),
                           device="cpu")

    # the schedule: every event, on equal grids, boxes and ray pools
    assert logs["port"] == logs["jax"]
    events = logs["port"]["events"]
    assert [e[0] for e in events] == [
        "filter_rays_bbox", "update_alpha_mask", "shrink", "upsample",
        "update_alpha_mask", "filter_rays_bbox"]
    # the mask on the first grid, the box shrunk, the grid upsampled and
    # the next mask on it, and the refilter dropped rays
    assert events[1][1] == (16, 16, 16)
    assert events[2][2] != [[-1.5] * 3, [1.5] * 3]
    assert events[2][1] != events[3][1] == events[4][1][::-1]
    assert events[5][1] < events[0][1]
    # radiance; relight at the core cap (the shrink's step, then the
    # upsample's, each with a fresh Adam); the flip to the fast knobs at
    # the full cap
    steps = logs["port"]["steps"]
    assert [s[1] for s in steps] == [False, True, True, True]
    assert [s[4] for s in steps[1:]] == [4, 4, 16]
    assert [s[2] for s in steps] == [0, 0, 0, 12]
    assert [e[0] for e in logs["port"]["evals"]] == [3, 7, 11]

    aabb = tr.scene["aabb"].numpy()
    assert np.array_equal(aabb, np.asarray(jr.scene["aabb"]))
    assert grid_size_of(tr.params) == tuple(JF.grid_size_of(jr.params))
    assert grid_size_of(tr.params) == TLC.n_to_reso(20 ** 3, aabb)
    assert tr.n_samples == jr.n_samples

    assert len(tr.metrics_history) == len(jr.metrics_history) == 12
    for tm, jm in zip(tr.metrics_history, jr.metrics_history):
        assert set(tm) <= set(jm) and tm["iteration"] == jm["iteration"]
        for k, v in tm.items():
            if k not in ("elapsed_s", "rays_per_s"):
                np.testing.assert_allclose(
                    v, jm[k], rtol=METRIC_RTOL,
                    err_msg=f"it {tm['iteration']} {k}")
    assert tr.metrics_history[-1]["n_acc_masked"] > 0

    t_flat, j_flat = _flat(tr.params), _flat(to_numpy(jr.params))
    assert set(t_flat) == set(j_flat)
    for k in t_flat:
        _assert_rel_l2(t_flat[k].numpy(), j_flat[k], k)
    for k, v in tr.scene.items():
        a = v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()
        assert np.array_equal(a, np.asarray(jr.scene[k], np.float32)), k

    # what the two trained fields render
    r = np.asarray(_dataset().all_rays[::4][:256])
    lidx = np.zeros((256,), np.int32)
    kw = dict(n_samples=tr.n_samples, key=None, is_relight=False,
              white_bg=True, app_cap=8)
    jout = j_render_rays(jr.fcfg, jr.params, jr.scene, jnp.asarray(r),
                         jnp.asarray(lidx), **kw)
    tout = t_render_rays(tr.fcfg, tr.params, tr.scene, t(r),
                         t(lidx, torch.int32), **kw)
    acc = np.asarray(jout["acc_map"])
    assert (acc > 0.5).any() and (acc < 0.5).any()
    for k in ("rgb_map", "acc_map"):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   rtol=0, atol=RENDER_ATOL, err_msg=k)

    # the checkpoints: the same files, up to the port's own RNG state
    for name in ("ckpt_5.npz", "ckpt_10.npz", "ckpt_final.npz"):
        t_ck = _npz(os.path.join(t_dir, name))
        j_ck = _npz(os.path.join(j_dir, name))
        assert set(j_ck) - set(t_ck) == {"train/rng_key"}, name
        assert set(t_ck) - set(j_ck) == {"train/torch_rng_state",
                                         "train/sampler_state"}, name
        for k, v in j_ck.items():
            if k.startswith("train/"):
                continue
            if k == "__tensoir_header__" or k.startswith(("alpha/", "scene/")):
                assert np.array_equal(t_ck[k], v), (name, k)
            elif v.ndim == 0:
                assert t_ck[k] == v, (name, k)
            else:
                _assert_rel_l2(t_ck[k], v, f"{name} {k}")
    header = json.loads(bytes(t_ck["__tensoir_header__"]).decode())
    assert header["extra"]["train_state"]["iteration"] == 12


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _port_cfg(**kw):
    base = dict(SCHEDULE, vis_every=0, update_AlphaMask_list=(2, 4),
                upsamp_list=(8,))
    base.update(kw)
    return TConfig(**base)


@pytest.mark.parametrize("refilter_at", [4, 6])
def test_resume_full_continues_exactly(tmp_path, monkeypatch, refilter_at):
    """12 iterations in one run, and 6 + 6 through ``resume_full`` from the
    checkpoint at iteration 5: the same parameters, Adam state, metrics
    and final checkpoint, bit for bit, with the step's march jitter and
    random background on. The blob makes the shrunk box drop rays; at
    ``refilter_at`` 6 the checkpoint predates the refilter at the end of
    iteration 6, which the resumed run does then."""
    init = TL.init_field_params
    monkeypatch.setattr(TL, "init_field_params", lambda *a, **kw: (
        lambda p, s: (seed_blob(p, amp=4.0, sharp=0.2), s))(*init(*a, **kw)))
    ds = _dataset()
    cfg = _port_cfg(update_AlphaMask_list=(2, refilter_at))
    one = TL.reconstruction(cfg, ds, log_dir=str(tmp_path / "one"),
                            device="cpu")
    ckpt = str(tmp_path / "one" / "ckpt_5.npz")
    _, _, _, extra = load_checkpoint(ckpt, device="cpu")
    assert extra["train_state"]["iteration"] == 6
    assert extra["sampler_state"]["drawn"]
    _, _, _, final = load_checkpoint(str(tmp_path / "one" / "ckpt_final.npz"),
                                     device="cpu")
    pools = (extra["sampler_state"]["total"], final["sampler_state"]["total"])
    assert pools[1] < ds.all_rays.shape[0]
    assert (pools[0] == pools[1]) == (refilter_at < 6)
    two = TL.reconstruction(dataclasses.replace(cfg, ckpt=ckpt,
                                                resume_full=True),
                            ds, log_dir=str(tmp_path / "two"), device="cpu")
    assert [m["iteration"] for m in two.metrics_history] == list(range(6, 12))
    for a, b in zip(one.metrics_history[6:], two.metrics_history):
        for k in a:
            if k not in ("elapsed_s", "rays_per_s"):
                assert a[k] == b[k], (a["iteration"], k)
    ta, tb = _flat(one.params), _flat(two.params)
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k
    fa = _npz(str(tmp_path / "one" / "ckpt_final.npz"))
    fb = _npz(str(tmp_path / "two" / "ckpt_final.npz"))
    assert set(fa) == set(fb)
    for k in fa:
        assert np.array_equal(fa[k], fb[k]), k


def test_stop_file_ends_the_run_with_a_final_checkpoint(tmp_path,
                                                        monkeypatch):
    ds = _dataset()
    cfg = _port_cfg(n_iters=500, save_iters=0, progress_refresh_rate=2)
    stop = tmp_path / "stop_now"
    stop.write_text("stop")
    monkeypatch.setenv("TENSOIR_STOP_FILE", str(stop))
    res = TL.reconstruction(cfg, ds, log_dir=str(tmp_path / "env"),
                            device="cpu")
    assert [m["iteration"] for m in res.metrics_history] == [0]
    _, _, _, extra = load_checkpoint(str(tmp_path / "env" / "ckpt_final.npz"),
                                     device="cpu")
    assert extra["train_state"]["iteration"] == 1

    # without the variable, <log_dir>/STOP: one left by an earlier run is
    # cleared, one made during the run stops it at the next refresh
    monkeypatch.delenv("TENSOIR_STOP_FILE")
    log_dir = tmp_path / "own"
    log_dir.mkdir()
    (log_dir / "STOP").write_text("stale")

    def touch(it, m):
        if it == 4:
            (log_dir / "STOP").write_text("stop")
    res = TL.reconstruction(cfg, ds, log_dir=str(log_dir), progress_cb=touch,
                            device="cpu")
    assert [m["iteration"] for m in res.metrics_history] == [0, 2, 4]
    _, _, _, extra = load_checkpoint(str(log_dir / "ckpt_final.npz"),
                                     device="cpu")
    assert extra["train_state"]["iteration"] == 5
    lines = (log_dir / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(x)["step"] for x in lines] == [0, 2, 4]
    assert any(f.startswith("events.out.tfevents") for f in os.listdir(log_dir))
    assert (log_dir / "config.txt").exists()


@pytest.mark.parametrize("kw,exc,match", [
    # several ranks need the launcher: one process cannot make them
    (dict(mesh_data=2), ValueError, "torch.distributed.run --nproc_per_node")],
    ids=["mesh_data"])
def test_unported_options_are_refused_at_the_start(kw, exc, match, tmp_path,
                                                   monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(exc, match=match):
        TL.reconstruction(_port_cfg(**kw), _dataset(),
                          log_dir=str(tmp_path), device="cpu")
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("kw", [
    dict(march_group=4, march_cap_primary=32, step_ratio=0.5),
    dict(second_march_group=4),
    dict(secondary_app_hoist=1)],
    ids=["march_group", "second_march_group", "secondary_app_hoist"])
def test_grouped_options_run_and_downgrade_as_jax(kw, tmp_path, monkeypatch,
                                                  capsys):
    """The grouped marches and the hoisted app stage run through the
    loop's relight phases; at each rebuild the loop takes the groups JAX's
    resolvers take for the live AABB and grid, and prints JAX's downgrade
    lines."""
    calls = []
    for name in ("resolve_march_group", "resolve_primary_march_group"):
        def record(*args, _fn=getattr(TL, name), _name=name):
            calls.append((_name, args, _fn(*args)))
            return calls[-1][2]
        monkeypatch.setattr(TL, name, record)
    res = TL.reconstruction(_port_cfg(**kw), _dataset(),
                            log_dir=str(tmp_path), device="cpu")
    printed = capsys.readouterr().out
    relit = [m for m in res.metrics_history if "loss_rgb_brdf" in m]
    assert relit and all(np.isfinite(m["total_loss"]) for m in relit)
    assert res.metrics_history[-1]["iteration"] == SCHEDULE["n_iters"] - 1
    jcfg = JConfig(**dict(SCHEDULE, **kw))
    for name, args, got in calls:
        assert getattr(JL, name)(jcfg, *args[1:]) == got, (name, args[1:])
        for line in capsys.readouterr().out.splitlines():
            assert line in printed
    groups = {name: [got for n, _, got in calls if n == name]
              for name in ("resolve_march_group",
                           "resolve_primary_march_group")}
    if "march_group" in kw:
        assert groups["resolve_primary_march_group"] and max(
            groups["resolve_primary_march_group"]) == 4
    if "second_march_group" in kw:
        # resolved once the window march is on; the shrunk box's bake
        # cells are too small for 4 consecutive samples
        assert groups["resolve_march_group"]
        assert max(groups["resolve_march_group"]) < 4
        assert "grouped secondary march downgraded 4 ->" in printed


def test_reconstruction_defaults_to_the_card():
    if torch.cuda.is_available():
        assert TL.resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TL.reconstruction(_port_cfg(), _dataset())


def test_metrics_logger_and_trace_match_jax(tmp_path):
    """The port's metrics sink writes the JAX package's metrics.jsonl and
    event records (scalars and an image panel), read back by JAX's parser;
    a profiler's trace holds what ran under a span."""
    from torch.profiler import ProfilerActivity, profile

    from tensoir_tpu.profiling import MetricsLogger as JLogger
    from tensoir_tpu.utils.tb_writer import read_events
    from tensoir_tpu_torch.profiling import MetricsLogger, span
    img = np.random.default_rng(0).random((5, 7, 3)).astype(np.float32)
    records = {}
    for side, cls in (("jax", JLogger), ("port", MetricsLogger)):
        d = tmp_path / side
        logger = cls(str(d))
        logger.log(3, {"psnr": 21.5, "total_loss": 0.125})
        logger.log(4, {"psnr": 22.0}, prefix="eval")
        logger.log_image(4, "eval/panel", img)
        logger.close()
        (events,) = [f for f in os.listdir(d) if f.startswith("events.out")]
        evs = read_events(str(d / events))
        records[side] = ((d / "metrics.jsonl").read_text(),
                         [{k: v for k, v in e.items() if k != "wall_time"}
                          for e in evs])
    assert records["port"] == records["jax"]

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("field"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    text = (tmp_path / "trace.json").read_text()
    assert '"field"' in text and "aten::mm" in text
