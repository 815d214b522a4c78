"""The training loop (port of tensoir_tpu.train.loop): ``reconstruction``
with the coarse-to-fine phase schedule, in one process on one device.

Phase schedule, as in the JAX loop:
  * at update_AlphaMask_list[0]: update_alpha_mask -> shrink -> L1 switch ->
    relight branch on -> TV weights zeroed -> a new step with a fresh Adam;
  * at update_AlphaMask_list[1]: the rays are refiltered with the shrunk box;
  * later update_AlphaMask_list entries: mask refresh only;
  * at each upsamp_list entry: factor upsample + fresh Adam + LR reset;
  * at fast_march_start / fast_march_end (or the auto flip on
    ``sec/window_resid_rel``): a new step that keeps the Adam state.
The step runs eagerly, so an event recompiles nothing: the next step runs
on the new shapes (the JAX loop recompiles its jitted step at each event).

Between progress refreshes and events nothing waits for the device: the
batch ids come from a permutation uploaded once per epoch from pinned
memory without a wait, and the metrics stay on the device until a refresh
copies them to the host in one transfer. The events (mask, shrink,
upsample, refilter, checkpoint) read device values and so wait for it.

``cfg.resume_full`` from one of the port's checkpoints goes on exactly:
the checkpoint also holds the step generator's and the ray sampler's
states, the ray pool is the one the interrupted run trained on, and the
step is built as it stood. The JAX loop reseeds its sampler, filters the
rays with the checkpoint's box, and builds the step at the resume
iteration, which flips fast_march_start one step early there.
"""
from __future__ import annotations

import dataclasses
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch

from tensoir_tpu_torch.config import TensoIRConfig, field_config_from
from tensoir_tpu_torch.device import DeviceLike, resolve_device
from tensoir_tpu_torch.models import field as F
from tensoir_tpu_torch.models import lifecycle as LC
from tensoir_tpu_torch.models.field import FieldConfig, init_field_params
from tensoir_tpu_torch.profiling import MetricsLogger, RayThroughputMeter
from tensoir_tpu_torch.train.optim import decay_factor, make_optimizer
from tensoir_tpu_torch.train.step import (LossWeights, StepStatic,
                                          make_train_step)
from tensoir_tpu_torch.utils.ckpt import (load_checkpoint, restore_opt_state,
                                          save_checkpoint)


def write_config_provenance(cfg: TensoIRConfig, log_dir: str) -> str:
    """Write every resolved config field to ``<log_dir>/config.txt``."""
    path = os.path.join(log_dir, "config.txt")
    with open(path, "w") as f:
        for fld in dataclasses.fields(cfg):
            f.write(f"{fld.name} = {getattr(cfg, fld.name)!r}\n")
    return path


class SimpleSampler:
    """Random-permutation batcher. The permutations are numpy's, from the
    same seeds as the JAX loop's, so both packages train on the same ray
    ids; each is uploaded to ``device`` once, and ``nextids`` returns a
    slice of it there."""

    def __init__(self, total: int, batch: int, device: DeviceLike,
                 seed: int = 0):
        if total < batch:
            raise ValueError(
                f"ray pool ({total}) smaller than the batch ({batch}); "
                f"shrink batch_size or loosen the ray filter")
        self.total = total
        self.batch = batch
        self.curr = total
        self.ids = None
        self.rng = np.random.default_rng(seed)
        self.device = resolve_device(device)
        # the generator's state before it drew the current permutation
        self._perm_from = None

    def nextids(self) -> torch.Tensor:
        self.curr += self.batch
        if self.curr + self.batch > self.total:
            self._perm_from = self.rng.bit_generator.state
            self.ids = self._upload(self.rng.permutation(self.total))
            self.curr = 0
        return self.ids[self.curr:self.curr + self.batch]

    def _upload(self, perm: np.ndarray) -> torch.Tensor:
        """``perm`` on the device. From pageable memory the copy would make
        the host wait for the card; from pinned memory it queues behind the
        running step (the pinned allocator keeps the buffer until the copy
        is done)."""
        host = torch.from_numpy(perm)
        if self.device.type == "cuda":
            host = host.pin_memory()
        return host.to(self.device, non_blocking=True)

    def state(self) -> Dict:
        """Where the sampler stands, as JSON-able values: ``restore`` of it
        goes on with the same ids."""
        drawn = self.ids is not None
        return {"total": self.total, "curr": self.curr, "drawn": drawn,
                "rng": self._perm_from if drawn else self.rng.bit_generator.state}

    def restore(self, state: Dict) -> bool:
        """Go on from ``state()`` of a sampler over the same pool; False,
        with nothing changed, for another pool size."""
        if state["total"] != self.total:
            return False
        self.rng.bit_generator.state = state["rng"]
        self.ids, self._perm_from = None, None
        if state["drawn"]:
            self._perm_from = state["rng"]
            self.ids = self._upload(self.rng.permutation(self.total))
        self.curr = state["curr"]
        return True


@dataclass
class TrainResult:
    params: Dict
    scene: Dict
    fcfg: FieldConfig
    metrics_history: list
    n_samples: int


def _refuse_unported(cfg: TensoIRConfig) -> None:
    """Options the port's step or loop cannot run yet: refused before the
    first step rather than at the first rebuild."""
    if cfg.mesh_data > 1:
        raise NotImplementedError(
            f"mesh_data={cfg.mesh_data}: multi-GPU training is not ported "
            f"yet (ROADMAP queue 1 item 7); the loop runs on one device")
    for name in ("march_group", "second_march_group"):
        if getattr(cfg, name) > 1:
            raise NotImplementedError(
                f"{name}={getattr(cfg, name)}: the grouped march is not "
                f"ported yet (ROADMAP queue 1 item 6d)")


def _to_host(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The step's 0-d device metrics as floats, in one transfer."""
    vals = torch.stack([v.detach().float().reshape(())
                        for v in metrics.values()]).tolist()
    return dict(zip(metrics, vals))


def reconstruction(
    cfg: TensoIRConfig,
    dataset,
    log_dir: Optional[str] = None,
    eval_fn: Optional[Callable] = None,
    max_iters: Optional[int] = None,
    progress_cb: Optional[Callable[[int, Dict], None]] = None,
    device: DeviceLike = None,
) -> TrainResult:
    """Train a TensoIR field on ``device`` (None: the card). ``dataset``
    must satisfy the data contract (all_rays/all_rgbs/all_light_idx,
    scene_bbox, near_far, white_bg)."""
    _refuse_unported(cfg)
    dev = resolve_device(device)
    n_iters = max_iters or cfg.n_iters
    # float32, as the JAX loop reads it: n_to_reso(128**3) is 128 per axis
    # on [-1.5, 1.5]^3 in float32, 127 in float64
    aabb = np.asarray(dataset.scene_bbox, np.float32).reshape(2, 3)
    white_bg = bool(dataset.white_bg)
    fcfg = field_config_from(cfg, dataset.near_far)

    reso_cur = LC.n_to_reso(cfg.N_voxel_init, aabb)
    n_samples = min(cfg.nSamples, LC.cal_n_samples(reso_cur, cfg.step_ratio))

    # the step's random draws (march jitter, background); the JAX loop
    # splits a key per step instead
    key = torch.Generator(device=dev).manual_seed(cfg.seed)
    resume_state = None
    resume_opt_leaves = None
    resume_sampler = None
    if cfg.ckpt:
        # weights and alpha mask; with cfg.resume_full and a checkpoint that
        # carries train state, also the optimizer, schedule and generator
        fcfg, params, scene, ck_extra = load_checkpoint(cfg.ckpt, device=dev)
        reso_cur = F.grid_size_of(params)
        n_samples = min(cfg.nSamples,
                        LC.cal_n_samples(reso_cur, cfg.step_ratio))
        aabb = scene["aabb"].cpu().numpy()
        if cfg.resume_full and "train_state" in ck_extra:
            resume_state = ck_extra["train_state"]
            resume_opt_leaves = ck_extra.get("opt_leaves")
            resume_sampler = ck_extra.get("sampler_state")
            state = ck_extra.get("torch_rng_state")
            if state is not None:
                if state.numel() == key.get_state().numel():
                    key.set_state(state)
                else:
                    print(f"[loop] {cfg.ckpt}: generator state of another "
                          f"device type; the run draws from its seed",
                          flush=True)
    else:
        # the dataset's probe, the light of light_kind='gt' (a relighting
        # test set's dict of probes is not one)
        gt_envmap = getattr(dataset, "lights_probes", None)
        if not isinstance(gt_envmap, np.ndarray):
            gt_envmap = None
        params, scene = init_field_params(
            torch.Generator().manual_seed(cfg.seed), fcfg, reso_cur, aabb,
            device=dev, gt_envmap=gt_envmap)

    lr_factor = decay_factor(cfg.lr_decay_target_ratio,
                             cfg.lr_decay_iters, n_iters)

    all_rays = np.asarray(dataset.all_rays, np.float32)
    all_rgbs = np.asarray(dataset.all_rgbs, np.float32)
    all_lidx = np.asarray(dataset.all_light_idx, np.int32).reshape(-1)

    def ray_pool(box, seed):
        """The rays that hit ``box``, on the device, and their sampler."""
        keep = LC.filter_rays_bbox(all_rays, box)
        pool = [torch.as_tensor(a[keep], device=dev)
                for a in (all_rays, all_rgbs, all_lidx)]
        return pool, SimpleSampler(int(keep.sum()), cfg.batch_size, dev,
                                   seed=seed)

    (rays_f, rgbs_f, lidx_f), sampler = ray_pool(aabb, cfg.seed)

    voxel_list = LC.voxel_schedule(cfg.N_voxel_init, cfg.N_voxel_final,
                                   len(cfg.upsamp_list))
    upsamp_left = list(cfg.upsamp_list)
    update_am_list = list(cfg.update_AlphaMask_list)

    relight = False
    l1_weight = cfg.L1_weight_inital
    tv_density, tv_app = cfg.TV_weight_density, cfg.TV_weight_app
    relight_start = (update_am_list[0] if update_am_list else 0)
    cur_lr_scale = 1.0
    start_it = 0

    if resume_state is not None:
        start_it = int(resume_state["iteration"])
        relight = bool(resume_state["relight"])
        l1_weight = float(resume_state["l1_weight"])
        tv_density = float(resume_state["tv_density"])
        tv_app = float(resume_state["tv_app"])
        voxel_list = list(resume_state["voxel_list"])
        cur_lr_scale = float(resume_state["lr_scale"])
        # the rays the interrupted run trained on: refiltered with the
        # shrunk box from the end of iteration update_AlphaMask_list[1] on
        # (never in NDC runs), else filtered with the scene's box. The JAX
        # loop filters with the checkpoint's box in either case, and its
        # ``>=`` counts a checkpoint of the iteration before the refilter
        # as refiltered
        refiltered = (not cfg.ndc_ray and len(update_am_list) > 1
                      and start_it > update_am_list[1])
        box = (scene["aabb"].cpu().numpy() if refiltered else
               np.asarray(dataset.scene_bbox, np.float32).reshape(2, 3))
        (rays_f, rgbs_f, lidx_f), sampler = ray_pool(box,
                                                     cfg.seed + start_it)
        # the port's own checkpoints carry the sampler, so the run goes on
        # with the ids it would have drawn; the JAX loop (and a JAX
        # checkpoint here) reseeds it from the resume iteration instead
        if resume_sampler is not None and not sampler.restore(resume_sampler):
            print(f"[loop] {cfg.ckpt}: sampler state of another ray pool; "
                  f"reseeded at iteration {start_it}", flush=True)

    # fast_march_start == -1 (auto): the flip is decided by the measured
    # window-truncation residual; the flag latches once it fires, so later
    # rebuilds keep the fast knobs on
    fast_auto = cfg.fast_march_start == -1
    fast_flipped = False
    # plateau tracker of the auto flip: the best residual, the iteration it
    # was last improved at, and the refreshes within the patience window
    auto_best_resid = float("inf")
    auto_best_it = -1
    auto_recent = []
    # the relight cap of the current step (curriculum-aware); the meter
    # credits visibility rays with it
    cur_relight_cap = [cfg.relight_ray_cap]
    curriculum_warned = [False]

    def build_step(lr_scale: float, at_iter: int = 0, reuse_opt=None):
        # the lossy fast-march knobs (window cull, app bake) stay off until
        # fast_march_start, and are off again (at full cap) past
        # fast_march_end
        past_end = (cfg.fast_march_end > 0
                    and at_iter >= cfg.fast_march_end)
        past_start = (fast_flipped if fast_auto
                      else at_iter >= cfg.fast_march_start) or past_end
        fast_on = past_start and not past_end
        eff_window = cfg.second_window if fast_on else 0
        eff_window_back = cfg.second_window_back if fast_on else 0
        eff_app_bake = cfg.app_bake_reso if fast_on else 0
        # relight-cap curriculum: before the flip the relight branch trains
        # only the relight_cap_start highest-acc rays
        eff_relight_cap = (min(cfg.relight_cap_start, cfg.relight_ray_cap)
                           if (cfg.relight_cap_start > 0 and relight
                               and not past_start)
                           else cfg.relight_ray_cap)
        cur_relight_cap[0] = eff_relight_cap
        if cfg.relight_cap_start > 0 and relight \
                and not curriculum_warned[0]:
            # the JAX loop's two warnings; the second also fires, falsely,
            # when fast_march_end lifts the cap to full (kept, for parity)
            if 0 <= cfg.fast_march_start <= relight_start:
                curriculum_warned[0] = True
                print("[loop] WARNING: relight_cap_start is INERT — "
                      f"fast_march_start {cfg.fast_march_start} <= relight "
                      f"start {relight_start}; full pressure lands on the "
                      "soft density", flush=True)
            elif cfg.fast_march_start >= n_iters:
                curriculum_warned[0] = True
                print("[loop] WARNING: full relight cap never activates — "
                      f"fast_march_start {cfg.fast_march_start} >= n_iters "
                      f"{n_iters}; the run stays at the core cap "
                      f"{cfg.relight_cap_start}", flush=True)
        if relight and 0 < eff_window < cfg.second_nSample:
            # the window march's conservativeness contract, against the
            # current (possibly shrunk) AABB
            F.check_march_contract(
                scene["aabb"].cpu().numpy(),
                prepass_n=cfg.second_prepass_n, dilate=cfg.coarse_dilate,
                vis_near=cfg.second_near, vis_far=cfg.second_far)
        # lr_light is not scaled: the reference fixes the light group's rate
        optimizer = make_optimizer(params, cfg.lr_init * lr_scale,
                                   cfg.lr_basis * lr_scale, lr_factor,
                                   lr_light=cfg.lr_light)
        # a knob flip changes no parameter shape and keeps Adam's state
        opt_state = optimizer.init(params) if reuse_opt is None else reuse_opt
        st = StepStatic(
            n_samples=n_samples, is_relight=relight, white_bg=white_bg,
            sample_method=cfg.light_sample_train,
            app_cap=cfg.app_cap_per_ray,
            march_cap=cfg.march_cap_primary if relight else 0,
            second_march_cap=cfg.march_cap_secondary,
            secondary_use_baked=cfg.secondary_use_baked,
            secondary_bake_reso=cfg.secondary_bake_reso,
            second_window=eff_window,
            second_window_back=eff_window_back,
            second_prepass_n=cfg.second_prepass_n,
            coarse_dilate=cfg.coarse_dilate,
            march_select=cfg.march_select,
            secondary_compact_frac=cfg.secondary_compact_frac,
            group_bake_reso=cfg.group_bake_reso,
            app_bake_reso=eff_app_bake,
            secondary_app_hoist=bool(cfg.secondary_app_hoist),
            second_app_cap=cfg.second_app_cap,
            app_pair_frac=cfg.app_pair_frac,
            # before the flip, probe what the configured window would
            # truncate; auto mode needs the statistics to decide its flip
            second_window_probe=(cfg.second_window
                                 if relight and not past_start else 0),
            second_window_probe_back=(cfg.second_window_back
                                      if relight and not past_start else 0),
            secondary_stats=bool(cfg.secondary_stats) or (
                fast_auto and relight and not past_start),
            relight_ray_cap=eff_relight_cap,
            second_n_sample=cfg.second_nSample,
            second_near=cfg.second_near, second_far=cfg.second_far,
            secondary_tile=cfg.secondary_tile,
            ndc_ray=bool(cfg.ndc_ray))
        w = LossWeights(
            ortho=cfg.Ortho_weight, l1=l1_weight,
            tv_density=tv_density, tv_app=tv_app,
            rgb_brdf=cfg.rgb_brdf_weight,
            normals_diff=cfg.normals_diff_weight,
            normals_ori=cfg.normals_orientation_weight,
            albedo_sm=cfg.albedo_smoothness_loss_weight,
            rough_sm=cfg.roughness_smoothness_loss_weight,
            normals_enhance_ratio=cfg.normals_loss_enhance_ratio,
            brdf_enhance_ratio=cfg.BRDF_loss_enhance_ratio,
            n_iters=n_iters, relight_start=relight_start,
            lr_factor=lr_factor,
            rgb_brdf_warmup_iters=cfg.rgb_brdf_warmup_iters)
        return make_train_step(fcfg, optimizer, st, w, device=dev), opt_state

    # a step built at iteration i serves the steps after it, so a resumed
    # run builds at the iteration before its first: resumed at
    # fast_march_start, the JAX loop (at_iter=start_it) flips a step early
    step_fn, opt_state = build_step(cur_lr_scale,
                                    at_iter=max(start_it - 1, 0))
    if resume_opt_leaves is not None:
        opt_state = restore_opt_state(opt_state, resume_opt_leaves, params)

    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        write_config_provenance(cfg, log_dir)
        logger = MetricsLogger(log_dir)
    else:
        logger = None

    def make_meter(n_masked: int = None) -> RayThroughputMeter:
        # visibility rays: min(measured acc-mask count, cap) x directions;
        # none until a count has been read
        if relight and n_masked is not None:
            vis = (min(n_masked, cur_relight_cap[0])
                   * cfg.envmap_h * cfg.envmap_w)
        else:
            vis = 0
        meter = RayThroughputMeter(primary_per_step=cfg.batch_size,
                                   visibility_per_step=vis)
        meter.start()
        return meter

    meter = make_meter()

    def train_state_extra(it: int) -> Dict:
        return {"iteration": it, "train_state": {
            "iteration": it, "relight": relight, "l1_weight": l1_weight,
            "tv_density": tv_density, "tv_app": tv_app,
            "voxel_list": [int(v) for v in voxel_list],
            "lr_scale": float(cur_lr_scale)}}

    def save(name: str, it_next: int) -> None:
        save_checkpoint(os.path.join(log_dir, name), fcfg, params, scene,
                        extra=train_state_extra(it_next),
                        opt_state=opt_state, rng_state=key.get_state(),
                        sampler_state=sampler.state())

    history = []
    t_start = time.time()
    # graceful stop: the run ends at the next progress refresh after
    # $TENSOIR_STOP_FILE (else <log_dir>/STOP) appears, and still writes its
    # final checkpoint with the true stop iteration. A <log_dir>/STOP left
    # by an earlier run is cleared first; the env-var file is the caller's.
    stop_path = os.environ.get("TENSOIR_STOP_FILE", "")
    if not stop_path and log_dir:
        stop_path = os.path.join(log_dir, "STOP")
        if os.path.exists(stop_path):
            print(f"[loop] clearing stale stop file {stop_path} "
                  "(predates this run)", flush=True)
            os.remove(stop_path)
    stopped_early = False
    it = start_it - 1  # a run resumed at its end runs no step
    for it in range(start_it, n_iters):
        ids = sampler.nextids()
        batch = {"rays": rays_f[ids], "rgbs": rgbs_f[ids],
                 "light_idx": lidx_f[ids]}
        params, opt_state, metrics = step_fn(params, opt_state, scene,
                                             batch, key, it)
        meter.step()

        if it % cfg.progress_refresh_rate == 0 or it == n_iters - 1:
            m = _to_host(metrics)
            m["iteration"] = it
            m["elapsed_s"] = time.time() - t_start
            if relight:
                m["relight_cap_eff"] = float(cur_relight_cap[0])
            # the transfer above waited for the device: the window is real
            m["rays_per_s"] = meter.report()["rays_per_s"]
            meter = make_meter(int(m["n_acc_masked"])
                               if "n_acc_masked" in m else None)
            history.append(m)
            if logger:
                logger.log(it, m)
            if progress_cb:
                progress_cb(it, m)
            if (fast_auto and relight and not fast_flipped
                    and (cfg.fast_march_end <= 0
                         or it < cfg.fast_march_end)):
                # flip when the configured window truncates less than thres
                # of the marched weight, or when the residual has plateaued
                # below the ceiling (the JAX loop's criteria; it runs before
                # this iteration's event resets the tracker, as there)
                resid = m.get("sec/window_resid_rel", float("inf"))
                flip_why = ""
                if resid < cfg.fast_march_auto_thres:
                    flip_why = (f"window_resid_rel {resid:.4f} < "
                                f"{cfg.fast_march_auto_thres}")
                elif cfg.fast_march_auto_patience > 0 and np.isfinite(resid):
                    band = 1.0 - cfg.fast_march_auto_rel_improve
                    auto_recent.append((it, resid))
                    auto_recent = [
                        (i, r) for i, r in auto_recent
                        if it - i <= cfg.fast_march_auto_patience]
                    trailing_min = min(r for _, r in auto_recent)
                    if resid < auto_best_resid * band:
                        auto_best_resid, auto_best_it = resid, it
                    elif (auto_best_it >= 0
                          and it - auto_best_it
                          >= cfg.fast_march_auto_patience
                          and auto_best_resid < cfg.fast_march_auto_ceiling
                          and resid < cfg.fast_march_auto_ceiling
                          and resid
                          <= trailing_min * cfg.fast_march_auto_spike_tol):
                        flip_why = (
                            f"plateau: window_resid_rel {resid:.4f} at "
                            f"best {auto_best_resid:.4f} with no "
                            f">{cfg.fast_march_auto_rel_improve:.0%} "
                            f"improvement for {it - auto_best_it} iters "
                            f"(ceiling {cfg.fast_march_auto_ceiling})")
                if flip_why:
                    fast_flipped = True
                    print(f"[loop] fast-march AUTO flip at iter {it}: "
                          f"{flip_why}", flush=True)
                    step_fn, _ = build_step(cur_lr_scale, at_iter=it,
                                            reuse_opt=opt_state)
            if stop_path and os.path.exists(stop_path):
                stopped_early = True
                print(f"[loop] stop file {stop_path} seen at iter {it}; "
                      "stopping early (final checkpoint still written)",
                      flush=True)
                break

        # ---- phase schedule ----
        rebuilt_this_it = False
        if it in update_am_list:
            reso_mask = tuple(min(r, 256) for r in reso_cur)
            scene, new_aabb = LC.update_alpha_mask(fcfg, params, scene,
                                                   reso_mask)
            if it == update_am_list[0]:
                params, scene = LC.shrink(fcfg, params, scene, new_aabb)
                l1_weight = cfg.L1_weight_rest
                relight = True
                tv_density, tv_app = 0.0, 0.0
                reso_cur = F.grid_size_of(params)
                n_samples = min(cfg.nSamples,
                                LC.cal_n_samples(reso_cur, cfg.step_ratio))
                cur_lr_scale = 1.0
                step_fn, opt_state = build_step(cur_lr_scale, at_iter=it)
                rebuilt_this_it = True
                meter = make_meter()   # relighting changes rays per step
            # the reference refilters only outside NDC mode
            if (not cfg.ndc_ray and len(update_am_list) > 1
                    and it == update_am_list[1]):
                (rays_f, rgbs_f, lidx_f), sampler = ray_pool(
                    scene["aabb"].cpu().numpy(), cfg.seed + it)

        if it in upsamp_left and voxel_list:
            n_voxels = voxel_list.pop(0)
            reso_cur = LC.n_to_reso(n_voxels, scene["aabb"].cpu().numpy())
            n_samples = min(cfg.nSamples,
                            LC.cal_n_samples(reso_cur, cfg.step_ratio))
            params = LC.upsample(params, reso_cur)
            cur_lr_scale = 1.0 if cfg.lr_upsample_reset else (
                cfg.lr_decay_target_ratio ** (it / n_iters))
            step_fn, opt_state = build_step(cur_lr_scale, at_iter=it)
            rebuilt_this_it = True

        if rebuilt_this_it or it in update_am_list:
            # an event perturbs the density: the plateau patience starts over
            auto_best_resid, auto_best_it = float("inf"), -1
            auto_recent = []

        if (relight and cfg.fast_march_start > 0
                and it == cfg.fast_march_start and not rebuilt_this_it):
            # the fast-march knobs flip on; a rebuild above at this
            # iteration already built the step with them
            step_fn, _ = build_step(cur_lr_scale, at_iter=it,
                                    reuse_opt=opt_state)

        if (relight and cfg.fast_march_end > 0
                and it == cfg.fast_march_end and not rebuilt_this_it):
            print(f"[loop] exact-finish flip at iter {it}: fast-march "
                  "knobs off, full relight cap retained", flush=True)
            step_fn, _ = build_step(cur_lr_scale, at_iter=it,
                                    reuse_opt=opt_state)

        if eval_fn is not None and relight and cfg.vis_every > 0 \
                and it % cfg.vis_every == cfg.vis_every - 1:
            eval_fn(fcfg, params, scene, it, n_samples, logger=logger)
            meter.start()   # the eval's time is not training throughput

        if log_dir and cfg.save_iters > 0 and it > 0 \
                and it % cfg.save_iters == 0:
            save(f"ckpt_{it}.npz", it + 1)

    if log_dir:
        save("ckpt_final.npz", it + 1 if stopped_early else n_iters)
        if logger:
            logger.close()

    return TrainResult(params=params, scene=scene, fcfg=fcfg,
                       metrics_history=history, n_samples=n_samples)
