"""Typed configuration (the port's own copy of tensoir_tpu.config).

A dataclass that reads the reference's ``configs/**/*.txt`` key = value
files (same key names, ``[a,b,c]`` lists, ``#`` comments), plus
``field_config_from``, which derives the field's static config from it.
"""
from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

from tensoir_tpu_torch.models.field import FieldConfig


@dataclass
class TensoIRConfig:
    # experiment / paths (reference opt.py:9-25)
    expname: str = "exp"
    basedir: str = "./log"
    add_timestamp: int = 0
    datadir: str = "./data"
    hdrdir: str = "./data"
    progress_refresh_rate: int = 10
    downsample_train: float = 1.0
    downsample_test: float = 1.0

    model_name: str = "TensorVMSplit"
    dataset_name: str = "tensoIR_unknown_rotated_lights"

    # loader / schedule (opt.py:32-34)
    batch_size: int = 4096
    n_iters: int = 30000
    save_iters: int = 10000

    # learning rates (opt.py:44-53)
    lr_init: float = 0.02
    lr_basis: float = 1e-3
    # light-param lr — the reference hardcodes 1e-3 (train_tensoIR.py
    # optimizer group for lgtSGs); exposed here because per-light SG sets
    # (general multi-lights) each see only 1/L of the ray gradient signal,
    # so the general setting may want it scaled (BASELINE.md r5 gap study)
    lr_light: float = 1e-3
    lr_decay_iters: int = -1
    lr_decay_target_ratio: float = 0.1
    lr_upsample_reset: int = 1

    # regularizer weights (opt.py:56-65)
    L1_weight_inital: float = 0.0
    L1_weight_rest: float = 0.0
    Ortho_weight: float = 0.0
    TV_weight_density: float = 0.0
    TV_weight_app: float = 0.0

    # volume model (opt.py:69-80)
    n_lamb_sigma: Tuple[int, ...] = (16, 16, 16)
    n_lamb_sh: Tuple[int, ...] = (48, 48, 48)
    data_dim_color: int = 27
    rm_weight_mask_thre: float = 1e-4
    alpha_mask_thre: float = 1e-4
    distance_scale: float = 25.0
    density_shift: float = -10.0

    # shading decoder (opt.py:83-92)
    shadingMode: str = "MLP_Fea"
    pos_pe: int = 2
    view_pe: int = 2
    fea_pe: int = 2
    featureC: int = 128

    ckpt: Optional[str] = None
    # Beyond-reference preemption recovery: when True and the checkpoint
    # carries full train state (optimizer moments, iteration, schedule),
    # resume exactly where training stopped instead of the reference's
    # weights-only restart (train_tensoIR.py:163-168).
    resume_full: bool = False
    render_only: int = 0
    render_test: int = 0
    test_number: int = 200
    render_train: int = 0
    render_path: int = 0
    # orbit-path video knobs (render_path; tensoIR_simple.py:84-155's
    # test_new_pose machinery — the reference hardcodes 150 frames)
    n_orbit: int = 150
    # flag-gated fast secondary march for the eval suite (the canonical
    # quality-gated window/compaction/bake config, render/eval.py
    # FAST_MARCH_KNOBS); 0 = the reference's exact full march
    eval_fast: int = 0
    export_mesh: int = 0

    # rendering options (opt.py:109-118)
    lindisp: bool = False
    perturb: float = 1.0
    accumulate_decay: float = 0.998
    fea2denseAct: str = "softplus"
    ndc_ray: int = 0
    nSamples: int = 1_000_000
    step_ratio: float = 0.5

    white_bkgd: bool = False

    # coarse-to-fine voxel schedule (opt.py:126-133)
    N_voxel_init: int = 100 ** 3
    N_voxel_final: int = 300 ** 3
    upsamp_list: Tuple[int, ...] = (10000, 20000, 30000, 40000)
    update_AlphaMask_list: Tuple[int, ...] = (10000, 15000)

    idx_view: int = 0
    N_vis: int = 5
    vis_every: int = 10000

    # relighting (opt.py:146-198)
    rgb_brdf_weight: float = 0.1
    # Linear BRDF-weight warmup over the first N relight iterations
    # (0 = off, reference-exact). Collapse guard for compressed schedules
    # where relight starts on a soft density (train/step.py LossWeights).
    rgb_brdf_warmup_iters: int = 0
    # Relight-cap curriculum (0 = off): until the fast_march_start flip,
    # relight only this many highest-acc rays (the clean core surface);
    # the flip grows the cap to relight_ray_cap = full reference pressure.
    # The r4 multilight-collapse fix (train/loop.py build_step).
    relight_cap_start: int = 0
    scene_bbox: Optional[Tuple[float, ...]] = None
    second_near: float = 0.05
    second_far: float = 1.5
    second_nSample: int = 96
    light_sample_train: str = "stratified_sampling"
    light_kind: str = "sg"
    numLgtSGs: int = 128
    light_name: str = "sunset"
    light_name_list: Tuple[str, ...] = ()
    light_rotation: Tuple[str, ...] = ("000",)
    acc_thre: float = 0.5
    geo_buffer_train: int = 0
    geo_buffer_test: int = 0
    geo_buffer_path: str = "."
    echo_every: int = 10
    relight_chunk_size: int = 160000
    batch_size_test: int = 4096
    normals_diff_weight: float = 0.0002
    normals_orientation_weight: float = 0.001
    BRDF_loss_enhance_ratio: float = 1.0
    normals_loss_enhance_ratio: float = 1.0
    albedo_smoothness_loss_weight: float = 0.0002
    roughness_smoothness_loss_weight: float = 0.0002
    normals_kind: str = "derived_plus_predicted"

    # environment-map resolution used for incident-light sampling
    # (reference TensorBase ctor defaults, tensorBase_rotated_lights.py:362-363)
    envmap_w: int = 32
    envmap_h: int = 16
    fixed_fresnel: float = 0.04

    # eval-only knobs the reference hardcodes (scripts/relight_importance.py:354-365)
    vis_equation: str = "nerv"
    acc_mask_threshold: float = 0.5

    # ---- TPU-native additions (not present in the reference) ----
    # Fixed per-ray cap of shading samples (top-k compaction replaces the
    # reference's dynamic `weight > thres` boolean compaction,
    # tensorBase_rotated_lights.py:924-926). 0 = dense (shade every sample).
    app_cap_per_ray: int = 32
    # Occupancy-culled marching caps: evaluate the VM field only on the
    # first k alpha-mask-occupied samples per ray (0 = dense). Primary cull
    # activates once the alpha mask exists (the relight phase).
    march_cap_primary: int = 192
    march_cap_secondary: int = 32
    # March secondary visibility rays against a per-step baked dense sigma
    # grid (pure einsum bake, trilinear lookups) instead of exact VM gathers.
    secondary_use_baked: bool = True
    # coarse visibility-bake resolution cap (0 = bake at full grid reso);
    # smaller gather tables march faster at a small shadow-softness cost
    secondary_bake_reso: int = 0
    # Interval-culled secondary march: coarse-occupancy prepass bounds the
    # occupied span, fine march gathers only this many canonical samples
    # (0 = full second_nSample march).
    second_window: int = 0
    # Back-anchored portion of second_window (covers the far interval of
    # two-interval spans, e.g. object + ground plane).
    second_window_back: int = 0
    # Coarse-occupancy prepass sample count for the windowed march. Must
    # keep half the prepass spacing <= the coarse dilation margin
    # (field.bake_coarse_occupancy docstring).
    second_prepass_n: int = 18
    # Coarse-occupancy dilation in coarse cells. A larger dilate legally
    # buys a smaller prepass (margin = dilate * cell) at the cost of wider
    # detected spans.
    coarse_dilate: int = 2
    # Primary occupied-sample selection: 'scatter' (cumsum+scatter,
    # default — bit-identical to 'topk' and faster on TPU) or 'topk'.
    march_select: str = "scatter"
    # Grouped primary march (0=off, 2/4): density on the march-selected
    # samples reads ONE 16-corner block row per group of g depth-adjacent
    # samples instead of g corner-packed rows — exact, ~g x fewer rows on
    # the row-count-bound density fwd gather + bwd scatter. Contract
    # (g-1)*step <= 2 cells per axis — re-checked against the live aabb at
    # every phase rebuild, auto-downgraded 4 -> 2 -> off with a log line.
    march_group: int = 0
    # Relighting benchmark: march visibility against the baked+windowed
    # fast path instead of the exact VM march (default off = reference
    # protocol, scripts/relight_importance.py:135-152).
    relight_fast_vis: bool = False
    # Hemisphere-pair compaction: march only cosine-valid (point, dir)
    # pairs, compacted to ceil(P*L*frac) rows (0 = dense+mask). The
    # reference likewise computes visibility only for unmasked pairs
    # (relight_utils.py:439-450).
    secondary_compact_frac: float = 0.0
    # Grouped fine march: one 27-corner block row gather per this many
    # consecutive window samples (0 = off; 2/4). Requires the grouped-march
    # contract (group-1)*fine_step <= bake cell — checked at phase build,
    # auto-disabled (with a log line) when the aabb/bake violate it.
    second_march_group: int = 0
    # Bake resolution for the grouped-march 27-pack (0 = secondary_bake_reso).
    group_bake_reso: int = 0
    # Baked secondary appearance feature (per-light radiance-feature grids,
    # one row gather per app sample instead of three packed plane gathers);
    # 0 = exact VM query.
    app_bake_reso: int = 0
    # Global (cross-tile) secondary appearance stage: hoists the app
    # gather+MLP out of the per-tile lax.map into one 36x-bigger batch
    # (exact; tests/test_eval_fast_march.py::test_secondary_app_hoist_exact)
    secondary_app_hoist: int = 0
    # App samples evaluated per selected secondary pair (top-k by weight;
    # the reference evaluates every weight>thres sample,
    # relight_utils.py:822-825 — this is the fixed-capacity analog).
    second_app_cap: int = 16
    # Per-tile cap on pairs that reach the app stage, as a fraction of the
    # tile (0 = auto: tile/2 compacted, tile/4 dense). Telemetry for
    # tightening: sec/app_pair_occupancy + sec/app_pair_overflow_frac.
    app_pair_frac: float = 0.0
    # Log sec/* cap occupancy/overflow telemetry from the secondary stage
    # (the app-cap adoption signal; small extra reductions per tile).
    secondary_stats: int = 0
    # Iteration at which the LOSSY fast-march knobs (interval-culled
    # window, baked app feature) activate; before it the secondary runs
    # the exact full march. 0 = from the start. Rationale: on a SOFT
    # (early-relight) density the window truncates real mid-span
    # transmittance/indirect (measured 0.58 rel indirect error on a soft
    # toy field, tests/test_app_caps.py) — the window approximation is
    # only tight once transmittance saturates inside the front window.
    # -1 = AUTO: the exact march measures, every step, the weight mass the
    # configured window WOULD truncate (sec/window_resid_rel probe,
    # secondary.py) and the loop flips the fast knobs on at the first
    # progress refresh where it falls below fast_march_auto_thres — the
    # hand-tuned iteration becomes a measured density-hardness criterion.
    fast_march_start: int = 0
    # Exact-finish (0 = off): at this iteration the lossy fast-march knobs
    # flip back OFF for the remainder of the run while the relight cap
    # stays at FULL reference pressure — i.e. the final phase trains under
    # the reference's exact forward model (renderer.py:225-250 semantics).
    # Motivation: the r5 CPU protocol A/B measured a distributed ~-0.9 dB
    # albedo tax from training under the lossy secondary forward
    # (BASELINE.md knob isolation); an exact final phase is the candidate
    # recovery. Composes with fast_march_start (fast window in between)
    # and with auto mode (past fast_march_end the knobs are off whether or
    # not the auto flip ever fired, and the cap is full regardless).
    fast_march_end: int = 0
    # Auto-flip threshold on sec/window_resid_rel (collapsed multilight
    # runs measured 0.58; hardened single-light densities read ~0).
    fast_march_auto_thres: float = 0.02
    # PLATEAU criterion for the auto flip (r4 finding: a ground plane
    # keeps ~3% of marched weight outside the window, so the residual
    # floors at ~0.031-0.034 — above thres — and the absolute criterion
    # never fires). If the residual has not improved on its running best
    # by rel_improve for `patience` ITERATIONS, the current value sits at
    # that best (within the same band), and the best is below `ceiling`,
    # the density is judged as hard as this scene gets and the flip
    # fires. The ceiling guards the soft-density collapse regime (0.58
    # measured); patience 0 disables the plateau path entirely.
    fast_march_auto_patience: int = 500
    fast_march_auto_rel_improve: float = 0.02
    fast_march_auto_ceiling: float = 0.15
    # Spike guard for the plateau flip: the current residual must be
    # within this factor of the MIN over the trailing patience window —
    # "typical of the recent signal, not a transient spike". Replaces the
    # original current≈since-reset-best guard, which the r5 on-chip run
    # (log/ml_autoflip_r5) proved too strict: the residual dipped to
    # 0.0204 once then settled at its true 0.031-0.043 floor, and the
    # poisoned best blocked the flip forever on a healthy plateau.
    fast_march_auto_spike_tol: float = 1.5
    # Fixed cap of surface rays fed to the relighting branch per batch
    # (replaces dynamic `acc_mask` selection, renderer.py:86-107).
    relight_ray_cap: int = 1024
    # Secondary (surface-point x light-dir) pairs processed per tile.
    secondary_tile: int = 16384
    # Device-mesh data-parallel axis size (1 = single chip).
    mesh_data: int = 1
    # Compute dtype for MLP/matmul heavy ops ("float32" or "bfloat16").
    compute_dtype: str = "float32"
    seed: int = 20211202

    @property
    def light_num(self) -> int:
        if self.light_name_list:
            return len(self.light_name_list)
        return len(self.light_rotation)

    def replace(self, **kw) -> "TensoIRConfig":
        return dataclasses.replace(self, **kw)


_LIST_RE = re.compile(r"^\[(.*)\]$")


def _parse_value(raw: str) -> Any:
    raw = raw.strip()
    m = _LIST_RE.match(raw)
    if m:
        inner = m.group(1).strip()
        if not inner:
            return ()
        return tuple(_parse_value(v) for v in inner.split(","))
    low = raw.lower()
    if low in ("true", "false"):
        return low == "true"
    try:
        return int(raw)
    except ValueError:
        pass
    try:
        return float(raw)
    except ValueError:
        pass
    # strip quotes: list entries like ["sunset", "snow"]
    if len(raw) >= 2 and raw[0] == raw[-1] and raw[0] in "\"'":
        return raw[1:-1]
    return raw


def parse_config_text(text: str) -> dict:
    """Parse a reference-style key = value config file into a dict."""
    out: dict = {}
    for line in text.splitlines():
        line = line.split("#", 1)[0].strip()
        if not line:
            continue
        if "=" not in line:
            continue
        key, _, raw = line.partition("=")
        out[key.strip()] = _parse_value(raw)
    return out


# keys whose reference semantics are append-type string lists even for single
# entries (opt.py:164-166) — normalize scalars to 1-tuples of str
_STR_LIST_KEYS = {"light_rotation", "light_name_list"}
_INT_LIST_KEYS = {"n_lamb_sigma", "n_lamb_sh", "upsamp_list", "update_AlphaMask_list"}


def _coerce(key: str, val: Any, cfg_fields: dict) -> Any:
    if key in _STR_LIST_KEYS:
        if not isinstance(val, tuple):
            val = (val,)
        # rotations like 000 parse as int 0 — re-render as zero-padded strings
        return tuple(f"{v:03d}" if isinstance(v, int) else str(v) for v in val)
    if key in _INT_LIST_KEYS:
        if not isinstance(val, tuple):
            val = (val,)
        return tuple(int(v) for v in val)
    f = cfg_fields.get(key)
    if f is not None:
        if f.type in ("float", float) and isinstance(val, int):
            return float(val)
    return val


def load_config(path: Optional[str] = None, overrides: Optional[dict] = None) -> TensoIRConfig:
    """Load a TensoIRConfig from a reference-format .txt file plus overrides.

    Unknown keys are ignored with a warning (the reference's parser would
    reject them; being lenient lets us read configs from future variants).
    """
    cfg_fields = {f.name: f for f in dataclasses.fields(TensoIRConfig)}
    data: dict = {}
    if path is not None:
        with open(path) as fh:
            raw = parse_config_text(fh.read())
        for k, v in raw.items():
            if k == "config":
                continue
            if k not in cfg_fields:
                print(f"[config] ignoring unknown key: {k}")
                continue
            data[k] = _coerce(k, v, cfg_fields)
    if overrides:
        for k, v in overrides.items():
            if k not in cfg_fields:
                raise KeyError(f"unknown config key: {k}")
            data[k] = _coerce(k, v, cfg_fields)
    return TensoIRConfig(**data)


def field_config_from(cfg: TensoIRConfig, near_far) -> FieldConfig:
    """The field's static config for a run of ``cfg`` on a dataset with
    the given near/far planes."""
    per_light_sg = bool(cfg.light_name_list)
    rotations = tuple(int(r) for r in cfg.light_rotation)
    return FieldConfig(
        decomp={"TensorCP": "cp", "TensorVM": "vm_stacked"}.get(
            cfg.model_name, "vm"),
        density_n_comp=tuple(cfg.n_lamb_sigma),
        app_n_comp=tuple(cfg.n_lamb_sh),
        app_dim=cfg.data_dim_color,
        shading_mode=cfg.shadingMode,
        normals_kind=cfg.normals_kind,
        light_kind=cfg.light_kind,
        per_light_sg=per_light_sg,
        light_num=cfg.light_num,
        light_rotations=rotations if not per_light_sg else
        tuple(0 for _ in range(cfg.light_num)),
        num_sgs=cfg.numLgtSGs,
        envmap_h=cfg.envmap_h,
        envmap_w=cfg.envmap_w,
        fea2dense=cfg.fea2denseAct,
        density_shift=cfg.density_shift,
        distance_scale=cfg.distance_scale,
        raymarch_weight_thres=cfg.rm_weight_mask_thre,
        alpha_mask_thres=cfg.alpha_mask_thre,
        step_ratio=cfg.step_ratio,
        pos_pe=cfg.pos_pe, view_pe=cfg.view_pe, fea_pe=cfg.fea_pe,
        feature_c=cfg.featureC,
        fixed_fresnel=cfg.fixed_fresnel,
        near_far=tuple(near_far),
        compute_dtype=cfg.compute_dtype,
    )
