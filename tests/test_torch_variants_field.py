"""The port's model variants against the JAX package's, on the CPU: the SH
bases, the TensorCP and stacked TensorVM fields (features, gradients,
bakes, init), the bf16 products, and the lifecycle, optimizer groups and
checkpoints of both decompositions.

Same numpy inputs, JAX's parameters carried over with ``params_from_numpy``.
Tolerances, f32 on the CPU where the two packages sum in other orders:
- SH bases, features and bakes 1e-6 relative and 1e-6 absolute (the
  largest difference seen is 1.5e-8);
- gradients 1e-5 relative and 1e-6 absolute (sums over every point); the
  coordinates' gradients 1e-5 absolute: each is a sum over components of
  differences of neighbouring factor values times the grid's half size,
  which cancels to a few thousandths where the field is flat (largest
  seen 1.4e-6);
- bf16 products: the port rounds the operands to bf16 as JAX does and sums
  the exact products in f32, so the values hold at 1e-5 relative; their
  gradients are rounded to bf16 on both sides, and a sum that lands
  within f32 rounding of a bf16 tie rounds to neighbouring bf16 values,
  so gradients hold at 1e-2 relative (one bf16 ulp is 7.8e-3);
- ``upsample`` 1e-6 relative and 5e-7 absolute (test_torch_lifecycle.py's
  reason), ``shrink`` and the checkpoints equal, the alpha mask equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensoir_tpu.models import field as JF
from tensoir_tpu.models import lifecycle as JLC
from tensoir_tpu.models import mlps as JM
from tensoir_tpu.ops.interp import lerp_line as j_lerp_line
from tensoir_tpu.ops.sh import eval_sh_bases as j_sh
from tensoir_tpu.train import optim as JO
from tensoir_tpu.train import losses as JLS
from tensoir_tpu.utils import ckpt as JCK

from tensoir_tpu_torch.models import field as TF
from tensoir_tpu_torch.models import lifecycle as TLC
from tensoir_tpu_torch.models import mlps as TM
from tensoir_tpu_torch.ops.interp import lerp_line_matmul
from tensoir_tpu_torch.ops.sh import eval_sh_bases as t_sh
from tensoir_tpu_torch.train import losses as TLS
from tensoir_tpu_torch.train import optim as TO
from tensoir_tpu_torch.utils import ckpt as TCK

from torch_parity import (AABB, as_np, jax_field,  # noqa: F401
                          one_torch_thread, port_cfg, port_field, small_cfg,
                          t, to_numpy)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

VAL = dict(rtol=1e-6, atol=1e-6)
GRAD = dict(rtol=1e-5, atol=1e-6)
GRID = (24, 20, 16)
DECOMPS = ("cp", "vm_stacked")


def _coords(n, seed, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, (n, 3)).astype(
        np.float32)


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_eval_sh_bases_matches_jax(deg):
    d = np.random.default_rng(deg).normal(size=(200, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    want = np.asarray(j_sh(deg, jnp.asarray(d)))
    got = t_sh(deg, t(d))
    assert got.shape == want.shape == (200, (deg + 1) ** 2)
    np.testing.assert_allclose(as_np(got), want, **VAL)
    with pytest.raises(ValueError):
        t_sh(5, t(d))


def test_line_product_forms_match_jaxs_gathering_lerp_line():
    """CP's line lookup is the product form with lerp_line's taps: its
    value and its gradients in the line and in z equal JAX's gathering
    ``lerp_line``, also outside [-1, 1] (the linear extension below the
    first node, flat past the last). The clipped form of the VM lines
    agrees with it inside [-1, 1]."""
    rng = np.random.default_rng(3)
    line = rng.normal(size=(17, 5)).astype(np.float32)
    z = rng.uniform(-1.3, 1.3, 300).astype(np.float32)
    z[:4] = (-1.0, 1.0, -1.25, 1.25)
    up = rng.normal(size=(300, 5)).astype(np.float32)

    def j_loss(ln, zz):
        return jnp.sum(j_lerp_line(ln, zz) * up)

    jv = np.asarray(j_lerp_line(jnp.asarray(line), jnp.asarray(z)))
    jg_line, jg_z = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(line),
                                                      jnp.asarray(z))
    tl, tz = t(line).requires_grad_(True), t(z).requires_grad_(True)
    tv = lerp_line_matmul(tl, tz, extrapolate=True)
    (tv * t(up)).sum().backward()
    np.testing.assert_allclose(as_np(tv), jv, **VAL)
    np.testing.assert_allclose(as_np(tl.grad), np.asarray(jg_line), **GRAD)
    np.testing.assert_allclose(as_np(tz.grad), np.asarray(jg_z), **GRAD)
    inside = np.abs(z) <= 1.0
    clipped = lerp_line_matmul(t(line), t(z))
    np.testing.assert_allclose(as_np(clipped)[inside], jv[inside], **VAL)


@pytest.fixture(scope="module", params=DECOMPS)
def variant(request):
    """(jax cfg, jax params, jax scene) of a blob field of ``decomp``."""
    jcfg = small_cfg(decomp=request.param, envmap_h=4, envmap_w=8)
    jp, js = jax_field(jcfg, grid=GRID)
    return jcfg, jp, js


def test_features_and_their_gradients_match_jax(variant):
    """density_feature and both_features, their values and the gradients of
    every parameter and of the coordinates, on points inside the box and
    a little outside it."""
    jcfg, jp, _ = variant
    tp, _ = port_field(jp, {})
    c = _coords(120, 1, -1.1, 1.1)
    lidx = np.zeros((120,), np.int32)
    rng = np.random.default_rng(2)
    w_d = rng.normal(size=120).astype(np.float32)
    w_r = rng.normal(size=(120, jcfg.app_dim)).astype(np.float32)
    w_i = rng.normal(size=(120, jcfg.app_dim)).astype(np.float32)

    def j_loss(p, cc):
        rad, intr = JF.both_features(jcfg, p, cc, jnp.asarray(lidx))
        return (jnp.sum(JF.density_feature(jcfg, p, cc) * w_d)
                + jnp.sum(rad * w_r) + jnp.sum(intr * w_i))

    jd = np.asarray(JF.density_feature(jcfg, jp, jnp.asarray(c)))
    jr, ji = JF.both_features(jcfg, jp, jnp.asarray(c), jnp.asarray(lidx))
    jg, jgc = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(jp, jnp.asarray(c))
    keys = [k for k in tp if k.startswith(("density", "app", "stack"))]
    leaves = dict(tp)
    for k in keys + ["basis_mat", "light_line"]:
        leaves[k] = tp[k].detach().clone().requires_grad_(True)
    tc = t(c).requires_grad_(True)
    tcfg = port_cfg(jcfg)
    td = TF.density_feature(tcfg, leaves, tc)
    tr, ti = TF.both_features(tcfg, leaves, tc, t(lidx, torch.int32))
    ((td * t(w_d)).sum() + (tr * t(w_r)).sum()
     + (ti * t(w_i)).sum()).backward()
    np.testing.assert_allclose(as_np(td), jd, **VAL)
    np.testing.assert_allclose(as_np(tr), np.asarray(jr), **VAL)
    np.testing.assert_allclose(as_np(ti), np.asarray(ji), **VAL)
    np.testing.assert_allclose(as_np(tc.grad), np.asarray(jgc), rtol=1e-5,
                               atol=1e-5)
    for k in keys + ["basis_mat", "light_line"]:
        np.testing.assert_allclose(as_np(leaves[k].grad), np.asarray(jg[k]),
                                   err_msg=k, **GRAD)
    if jcfg.decomp == "cp":
        assert not any("plane" in k for k in tp)
        assert tuple(tp["basis_mat"].shape) == (jcfg.app_n_comp[0],
                                                jcfg.app_dim)
    else:
        assert set(keys) == {f"stack_{k}_{i}" for k in ("plane", "line")
                             for i in range(3)}
        np.testing.assert_array_equal(as_np(tp["light_line"]), 1.0)


@pytest.mark.parametrize("max_reso", [0, 12])
def test_bakes_match_jax(variant, max_reso):
    """The masked dense sigma bake (CP's outer product of lines, the
    stacked slices re-keyed; with max_reso the factors resized first, CP's
    lines only), its bf16 corner pack, and the stacked field's
    appearance bake."""
    jcfg, jp, js = variant
    js1, _ = JLC.update_alpha_mask(jcfg, jp, js, GRID)
    tp, ts = port_field(jp, js1)
    tcfg = port_cfg(jcfg)
    jd = np.asarray(JF._bake_masked_dense(jcfg, jp, js1, max_reso))
    td = TF._bake_masked_dense(tcfg, tp, ts, max_reso)
    np.testing.assert_allclose(as_np(td), jd, **VAL)
    assert (jd == -1e4).any() and (jd > -1e4).any()
    jpk = as_np(JF.bake_packed_sigma_grid(jcfg, jp, js1, max_reso=max_reso))
    tpk = as_np(TF.bake_packed_sigma_grid(tcfg, tp, ts, max_reso=max_reso))
    assert tpk.shape == jpk.shape
    # bf16: equal, or one bf16 ulp apart where the f32 values straddle a
    # rounding boundary
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(jpk), 1e-30))) - 7)
    assert (np.abs(tpk - jpk) <= ulp).all()
    if jcfg.decomp == "vm_stacked":
        ja = as_np(JF.bake_app_feature_grid(jcfg, jp, js1, dtype=jnp.float32,
                                          max_reso=max_reso))
        ta = as_np(TF.bake_app_feature_grid(tcfg, tp, dtype=torch.float32,
                                          max_reso=max_reso))
        np.testing.assert_allclose(ta, ja, rtol=1e-5, atol=1e-6)
    else:
        with pytest.raises(ValueError):
            TF.bake_app_feature_grid(tcfg, tp, max_reso=max_reso)


@pytest.mark.parametrize("decomp,shading,normals", [
    ("cp", "MLP", "gt_normals"),
    ("vm_stacked", "MLP_PE", "residue_prediction"),
    ("vm", "SH", "purely_predicted")])
def test_init_builds_the_jax_parameter_set(decomp, shading, normals):
    """Keys, shapes and dtypes of every decomposition, shading mode and
    normals kind; the initial scale of the factors as JAX draws them; the
    input widths of every decoder."""
    for args in ((27, 2, 2), (8, 3, 1), (5, 0, 4)):
        for name in ("render_fea_in_dim", "render_pe_in_dim",
                     "brdf_pe_fea_in_dim", "normal_residue_in_dim"):
            assert getattr(TM, name)(*args) == getattr(JM, name)(*args)
        assert TM.render_plain_in_dim(*args[:2]) == \
            JM.render_plain_in_dim(*args[:2])
    app_dim = 27 if shading == "SH" else 8
    jcfg = small_cfg(decomp=decomp, shading_mode=shading,
                     normals_kind=normals, app_dim=app_dim)
    jp, js = jax_field(jcfg, blob=False)
    tp, ts = TF.init_field_params(torch.Generator().manual_seed(0),
                                  port_cfg(jcfg), GRID, AABB, device="cpu")

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict)
                else (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in tree.items()}
    assert shapes(tp) == shapes(to_numpy(jp))
    assert shapes(ts) == shapes(to_numpy(js))
    for k, v in tp.items():
        if k.endswith(("plane_0", "line_0")):
            want = float(np.std(np.asarray(jp[k])))
            assert abs(float(v.std()) - want) < 0.25 * want, k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mlp_matches_jax_with_gradients(dtype):
    """apply_mlp in each compute dtype: values and the gradients of the
    weights and of the input."""
    rng = np.random.default_rng(5)
    p = JM.init_mlp(jax.random.PRNGKey(1), 21, 32, 4)
    x = rng.normal(size=(64, 21)).astype(np.float32)
    up = rng.normal(size=(64, 4)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32

    def j_loss(pp, xx):
        return jnp.sum(JM.apply_mlp(pp, xx, jdt) * up)

    jv = np.asarray(JM.apply_mlp(p, jnp.asarray(x), jdt))
    jg, jgx = jax.grad(j_loss, argnums=(0, 1))(p, jnp.asarray(x))
    tp = {k: t(np.asarray(v)).requires_grad_(True) for k, v in p.items()}
    tx = t(x).requires_grad_(True)
    tv = TM.apply_mlp(tp, tx, dtype)
    (tv * t(up)).sum().backward()
    assert tv.dtype == torch.float32
    np.testing.assert_allclose(as_np(tv), jv, rtol=1e-5, atol=1e-6)
    g_tol = (dict(rtol=1e-2, atol=1e-4) if dtype == "bfloat16"
             else GRAD)
    np.testing.assert_allclose(as_np(tx.grad), np.asarray(jgx), **g_tol)
    for k in tp:
        np.testing.assert_allclose(as_np(tp[k].grad), np.asarray(jg[k]),
                                   err_msg=k, **g_tol)
    if dtype == "bfloat16":
        # the bf16 path really rounds: it differs from the f32 one
        assert not np.allclose(jv, np.asarray(JM.apply_mlp(
            p, jnp.asarray(x), jnp.float32)), rtol=1e-6, atol=0)


# ------------------------------------------------------------- lifecycle

def test_lifecycle_matches_jax(variant):
    """update_alpha_mask, shrink (CP slices lines only) and upsample of the
    decomposition, against JAX's."""
    jcfg, jp, js = variant
    tp, ts = port_field(jp, js)
    tcfg = port_cfg(jcfg)
    js1, j_aabb = JLC.update_alpha_mask(jcfg, jp, js, (20, 18, 16))
    ts1, t_aabb = TLC.update_alpha_mask(tcfg, tp, ts, (20, 18, 16))
    np.testing.assert_array_equal(t_aabb, np.asarray(j_aabb, np.float32))
    for k in ("alpha_volume", "alpha_volume_dilated", "alpha_aabb"):
        np.testing.assert_array_equal(as_np(ts1[k]), as_np(js1[k]), err_msg=k)
    assert (np.asarray(js1["alpha_volume"]) == 0).any()
    jp2, js2 = JLC.shrink(jcfg, jp, js1, j_aabb)
    tp2, ts2 = TLC.shrink(tcfg, tp, ts1, t_aabb)
    np.testing.assert_array_equal(as_np(ts2["aabb"]), as_np(js2["aabb"]))
    assert set(tp2) == set(jp2)
    for k in tp2:
        if k.startswith(("density", "app", "stack")):
            np.testing.assert_array_equal(as_np(tp2[k]), as_np(jp2[k]),
                                          err_msg=k)
    assert TF.grid_size_of(tp2) == JF.grid_size_of(jp2) != GRID
    jp3, tp3 = JLC.upsample(jp2, (30, 28, 26)), TLC.upsample(tp2,
                                                              (30, 28, 26))
    assert TF.grid_size_of(tp3) == JF.grid_size_of(jp3) == (30, 28, 26)
    for k in tp3:
        if k.startswith(("density", "app", "stack")):
            np.testing.assert_allclose(as_np(tp3[k]), as_np(jp3[k]), rtol=1e-6,
                                       atol=5e-7, err_msg=k)
    # dense alpha of the shrunk field, as the mesh export and the next
    # mask read it
    np.testing.assert_allclose(
        as_np(TLC.dense_alpha(tcfg, tp2, ts2, (12, 10, 8))),
        np.asarray(JLC.dense_alpha(jcfg, jp2, js2, (12, 10, 8))), **VAL)


def test_regularizers_and_adam_groups_match_jax(variant):
    """The line orthogonality, density L1 and plane TV losses on the
    decomposition's factors, and one Adam lr group (spatial) for every
    factor: the stacked tensors hold density and appearance together."""
    jcfg, jp, _ = variant
    tp, _ = port_field(jp, {})
    tcfg = port_cfg(jcfg)
    for name in ("ortho_loss", "density_l1", "tv_loss_density",
                 "tv_loss_app"):
        want = float(getattr(JLS, name)(jp, jcfg))
        got = float(getattr(TLS, name)(tp, tcfg))
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=name)
    for k in tp:
        assert TO.param_group(k) == JO.param_group(k), k
        if k.startswith(("density", "app", "stack")):
            assert TO.param_group(k) == "spatial", k


def test_checkpoints_of_the_decomposition_round_trip(variant, tmp_path):
    """A checkpoint JAX wrote loads in the port (config, every tensor, the
    Adam moments in place), and the port's own loads back in JAX and in
    the port, equal."""
    jcfg, jp, js = variant
    js1, _ = JLC.update_alpha_mask(jcfg, jp, js, GRID)
    jopt = JO.make_optimizer(jp, 0.02, 1e-3, 0.999)
    jstate = jopt.init(jp)
    path = str(tmp_path / "jax.npz")
    JCK.save_checkpoint(path, jcfg, to_numpy(jp), to_numpy(js1),
                        extra={"iteration": 5}, opt_state=to_numpy(jstate))
    tcfg, tp, ts, t_extra = TCK.load_checkpoint(path, device="cpu")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert set(tp) == set(jp)
    for k, v in TO.flatten(tp).items():
        np.testing.assert_array_equal(
            as_np(v), as_np(_flat(jp)[k]), err_msg=k)
    state = TCK.restore_opt_state(
        TO.make_optimizer(tp, 0.02, 1e-3, 0.999).init(tp),
        t_extra["opt_leaves"], tp)
    assert set(state["mu"]) == set(TO.flatten(tp))

    path2 = str(tmp_path / "port.npz")
    TCK.save_checkpoint(path2, tcfg, tp, ts, extra={"iteration": 6},
                        opt_state=state)
    jcfg2, jp2, js2, _ = JCK.load_checkpoint(path2)
    assert dataclasses.asdict(jcfg2) == dataclasses.asdict(jcfg)
    _, tp3, ts3, _ = TCK.load_checkpoint(path2, device="cpu")
    for k, v in TO.flatten(tp).items():
        np.testing.assert_array_equal(as_np(_flat(jp2)[k]), as_np(v),
                                      err_msg=k)
        np.testing.assert_array_equal(as_np(TO.flatten(tp3)[k]), as_np(v),
                                      err_msg=k)
    for k in ("alpha_volume", "aabb", "alpha_aabb"):
        np.testing.assert_array_equal(as_np(ts3[k]), as_np(js2[k]), err_msg=k)


def _flat(tree, prefix=""):
    """A JAX parameter tree flattened as ``optim.flatten`` flattens the
    port's (``a/b`` keys)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out
