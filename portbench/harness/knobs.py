"""A configuration file's keys (TensoIRConfig's names) -> the keyword
arguments of FieldConfig, StepStatic, LossWeights and the optimizer, as
``train/loop.py`` builds them for the relight phase. The program's classes
and the reference's frozen copies take the same names, so both sides are
built from one dict."""
from __future__ import annotations

import numpy as np

# data/tensoir.py's near/far planes of the TensoIR-Synthetic scenes
NEAR_FAR = (2.0, 6.0)
# the scene box of the synthetic scenes before any shrink
AABB = np.array([[-1.5, -1.5, -1.5], [1.5, 1.5, 1.5]], np.float32)


def field_kwargs(c: dict) -> dict:
    """FieldConfig's fields (``config.field_config_from``) for one light."""
    return dict(
        decomp={"TensorCP": "cp", "TensorVM": "vm_stacked"}.get(
            c["model_name"], "vm"),
        density_n_comp=tuple(c["n_lamb_sigma"]),
        app_n_comp=tuple(c["n_lamb_sh"]),
        app_dim=c["data_dim_color"], shading_mode=c["shadingMode"],
        normals_kind=c["normals_kind"], light_kind=c["light_kind"],
        per_light_sg=False, light_num=1, light_rotations=(0,),
        num_sgs=c["numLgtSGs"], envmap_h=c["envmap_h"],
        envmap_w=c["envmap_w"], fea2dense=c["fea2denseAct"],
        density_shift=c["density_shift"],
        distance_scale=c["distance_scale"],
        raymarch_weight_thres=c["rm_weight_mask_thre"],
        alpha_mask_thres=c["alpha_mask_thre"], step_ratio=c["step_ratio"],
        pos_pe=c["pos_pe"], view_pe=c["view_pe"], fea_pe=c["fea_pe"],
        feature_c=c["featureC"], fixed_fresnel=c["fixed_fresnel"],
        near_far=NEAR_FAR, compute_dtype=c["compute_dtype"])


def lr_factor(c: dict) -> float:
    """``train/optim.py:decay_factor``."""
    iters = c["lr_decay_iters"] if c["lr_decay_iters"] > 0 else c["n_iters"]
    return c["lr_decay_target_ratio"] ** (1.0 / iters)


def step_kwargs(c: dict, n_samples: int) -> dict:
    """StepStatic's fields of the relight phase with the fast knobs on
    (``train/loop.py:build_step`` past ``fast_march_start``)."""
    return dict(
        n_samples=n_samples, is_relight=True, white_bg=True,
        sample_method=c["light_sample_train"], app_cap=c["app_cap_per_ray"],
        march_cap=c["march_cap_primary"],
        second_march_cap=c["march_cap_secondary"],
        secondary_use_baked=c["secondary_use_baked"],
        secondary_bake_reso=c["secondary_bake_reso"],
        second_window=c["second_window"],
        second_window_back=c["second_window_back"],
        second_prepass_n=c["second_prepass_n"],
        coarse_dilate=c["coarse_dilate"], march_select=c["march_select"],
        secondary_compact_frac=c["secondary_compact_frac"],
        app_bake_reso=c["app_bake_reso"], second_app_cap=c["second_app_cap"],
        app_pair_frac=c["app_pair_frac"],
        relight_ray_cap=c["relight_ray_cap"],
        second_n_sample=c["second_nSample"], second_near=c["second_near"],
        second_far=c["second_far"], secondary_tile=c["secondary_tile"])


def loss_kwargs(c: dict) -> dict:
    """LossWeights' fields of the relight phase (past the first alpha-mask
    update: the rest L1 weight, no TV)."""
    return dict(
        ortho=c["Ortho_weight"], l1=c["L1_weight_rest"], tv_density=0.0,
        tv_app=0.0, rgb_brdf=c["rgb_brdf_weight"],
        normals_diff=c["normals_diff_weight"],
        normals_ori=c["normals_orientation_weight"],
        albedo_sm=c["albedo_smoothness_loss_weight"],
        rough_sm=c["roughness_smoothness_loss_weight"],
        normals_enhance_ratio=c["normals_loss_enhance_ratio"],
        brdf_enhance_ratio=c["BRDF_loss_enhance_ratio"],
        n_iters=c["n_iters"], relight_start=c["update_AlphaMask_list"][0],
        lr_factor=lr_factor(c),
        rgb_brdf_warmup_iters=c["rgb_brdf_warmup_iters"])


def optimizer_args(c: dict) -> tuple:
    """``make_optimizer``'s (lr_init, lr_basis, factor, lr_light) right
    after an upsample (``lr_upsample_reset``: the rates start over)."""
    return (c["lr_init"], c["lr_basis"], lr_factor(c), c["lr_light"])


def eval_kwargs(c: dict, n_samples: int) -> dict:
    """``make_eval_chunk_fn``'s options as the CLI's ``render_test`` passes
    them: the exact full secondary march at the config's sizes."""
    return dict(n_samples=n_samples, chunk=c["batch_size_test"],
                second_n_sample=c["second_nSample"],
                secondary_tile=c["secondary_tile"])
