"""The port's lifecycle transforms, datasets and checkpoints against the JAX
package's, on the CPU.

Same field (made by tensoir_tpu, blob seeded, carried over as numpy).
Tolerances:
- ``shrink``: the AABB and the sliced factors bit-equal (the index box is
  numpy float64 arithmetic on both sides, and slicing moves no value);
- ``upsample``: 1e-6 relative and 5e-7 absolute: the same align-corners
  lerps, which XLA contracts into multiply-adds, so a value that two lerps
  of neighbours near 0.5 cancel to ~0.01 keeps their few ulps (largest
  seen 1.3e-7);
- both ray filters, the datasets and every checkpoint round trip: equal;
- ``render_rays`` from a loaded checkpoint: 2e-5 relative and 2e-6
  absolute, the tolerance of the render parity in test_torch_step.py.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensoir_tpu.data import synthetic as JD
from tensoir_tpu.models import lifecycle as JLC
from tensoir_tpu.models.field import grid_size_of as j_grid_size_of
from tensoir_tpu.train import optim as JO
from tensoir_tpu.utils import ckpt as JCK

from tensoir_tpu_torch import data as TDATA
from tensoir_tpu_torch.data import synthetic as TD
from tensoir_tpu_torch.models import lifecycle as TLC
from tensoir_tpu_torch.models.field import grid_size_of
from tensoir_tpu_torch.render.primary import render_rays as t_render_rays
from tensoir_tpu_torch.train import optim as TO
from tensoir_tpu_torch.utils import ckpt as TCK

from torch_parity import (assert_tree_close, j_render_rays, jax_field,
                          port_cfg, port_field, rays, small_cfg, t, to_numpy)

GRID = (24, 20, 16)
S = 48


@pytest.fixture(scope="module")
def field():
    """(jax cfg, jax params, jax scene) of the blob field."""
    jcfg = small_cfg()
    jp, js = jax_field(jcfg, grid=GRID)
    return jcfg, jp, js


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _assert_trees_equal(t_tree, j_tree, path=""):
    assert set(t_tree) == set(j_tree), path
    for k, v in t_tree.items():
        if isinstance(v, dict):
            _assert_trees_equal(v, j_tree[k], f"{path}{k}/")
            continue
        a, b = _np(v), _np(j_tree[k])
        assert a.shape == b.shape and np.array_equal(a, b), f"{path}{k}"


# ------------------------------------------------------- shrink, upsample


@pytest.mark.parametrize("mask_grid", [GRID, (12, 10, 8)],
                         ids=["mask_on_factor_grid", "aabb_correction"])
def test_shrink_and_upsample_match_jax(field, mask_grid):
    """The chain of the first alpha-mask event and the next upsample. With
    the mask on another grid than the factors (as the loop's cap at 256
    makes it past 256), the AABB is snapped onto the factor grid."""
    jcfg, jp, js = field
    tcfg = port_cfg(jcfg)
    tp, ts = port_field(jp, js)
    js1, jbox = JLC.update_alpha_mask(jcfg, jp, js, mask_grid)
    ts1, tbox = TLC.update_alpha_mask(tcfg, tp, ts, mask_grid)
    assert np.array_equal(tbox, jbox)
    full = np.asarray(js["aabb"])
    assert (jbox[0] > full[0]).any() and (jbox[1] < full[1]).any()

    jp2, js2 = JLC.shrink(jcfg, jp, js1, jbox)
    tp2, ts2 = TLC.shrink(tcfg, tp, ts1, tbox)
    aabb = ts2["aabb"].numpy()
    assert aabb.dtype == np.float32
    assert np.array_equal(aabb, np.asarray(js2["aabb"]))
    # the correction moves the box onto factor nodes only on another grid
    corrected = not np.array_equal(aabb, jbox.astype(np.float32))
    assert corrected == (mask_grid != GRID)
    _assert_trees_equal(tp2, to_numpy(jp2))
    assert grid_size_of(tp2) == tuple(j_grid_size_of(jp2))
    assert grid_size_of(tp2) != GRID

    n_vox = JLC.voxel_schedule(16 ** 3, 28 ** 3, 2)[0]
    reso = TLC.n_to_reso(n_vox, aabb)
    assert reso == JLC.n_to_reso(n_vox, np.asarray(js2["aabb"]))
    jp3 = JLC.upsample(jp2, reso)
    tp3 = TLC.upsample(tp2, reso)
    assert grid_size_of(tp3) == reso
    assert_tree_close(tp3, to_numpy(jp3), rtol=1e-6, atol=5e-7)


def test_ray_filters_match_jax(field, monkeypatch):
    jcfg, jp, js = field
    tcfg = port_cfg(jcfg)
    js1, box = JLC.update_alpha_mask(jcfg, jp, js, GRID)
    _, ts1 = port_field(jp, js1)
    ds = JD.SyntheticSphereDataset(split="train", n_views=3, img_wh=(20, 15))
    all_rays = np.concatenate([ds.all_rays, rays(300, seed=5, spread=0.6)])
    for aabb in (np.asarray(js["aabb"]), box):
        keep = TLC.filter_rays_bbox(all_rays, aabb)
        assert np.array_equal(keep, JLC.filter_rays_bbox(all_rays, aabb))
        assert keep.any() and not keep.all()
    # the port's 256 samples per ray; a ragged last chunk on both sides
    monkeypatch.setattr(TLC, "_FILTER_CHUNK", 500)
    t_keep = TLC.filter_rays_mask(tcfg, ts1, all_rays)
    j_keep = JLC.filter_rays_mask(jcfg, js1, all_rays, n_samples=256,
                                  chunk=500)
    assert t_keep.dtype == np.bool_ and t_keep.shape == (all_rays.shape[0],)
    assert np.array_equal(t_keep, j_keep)
    assert t_keep.any() and not t_keep.all()


# ------------------------------------------------------------- datasets


@pytest.mark.parametrize("cls", ["SyntheticSphereDataset",
                                 "SyntheticShadowDataset"])
@pytest.mark.parametrize("split", ["train", "test"])
def test_datasets_equal_jax(cls, split):
    kw = dict(split=split, n_views=3, img_wh=(20, 15), light_num=2)
    jds, tds = getattr(JD, cls)(**kw), getattr(TD, cls)(**kw)
    for name in ("all_rays", "all_rgbs", "all_normals", "all_depths",
                 "all_masks", "all_light_idx", "scene_bbox"):
        a, b = getattr(tds, name), getattr(jds, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert tds.near_far == jds.near_far and tds.white_bg == jds.white_bg
    assert len(tds) == len(jds)
    ti, ji = tds[1], jds[1]
    assert set(ti) == set(ji)
    for k in ti:
        assert np.array_equal(np.asarray(ti[k]), np.asarray(ji[k])), k


def test_registry_and_unported_parts():
    assert TDATA.get_dataset("synthetic_sphere") is TD.SyntheticSphereDataset
    from tensoir_tpu.data import dataset_dict as j_names
    assert set(TDATA.dataset_dict) == set(j_names)
    # the file loaders are ported; the relighting test sets are not
    for name in ("tensoIR_relighting_test", "tensoIR_material_editing_test"):
        with pytest.raises(NotImplementedError, match="item 6b"):
            TDATA.get_dataset(name)
    with pytest.raises(KeyError):
        TDATA.get_dataset("nope")
    ds = TD.SyntheticShadowDataset(split="test", n_views=1, img_wh=(4, 4))
    with pytest.raises(NotImplementedError, match="item 6"):
        ds.render_env_gt(ds.all_rays, np.ones((4, 8, 3), np.float32))


# ---------------------------------------------------------- checkpoints


def _jax_opt_state(jp, seed=0):
    """A JAX optimizer state for ``jp`` whose every leaf is distinct: random
    moments and counts 1, 2, 3, ... in leaf order."""
    jstate = JO.make_optimizer(jp, 0.02, 1e-3, 0.999).init(jp)
    leaves, treedef = jax.tree_util.tree_flatten(jstate)
    rng = np.random.default_rng(seed)
    new = [jnp.asarray(i + 1, leaf.dtype) if leaf.ndim == 0 else
           jnp.asarray(rng.normal(size=leaf.shape).astype(np.float32))
           for i, leaf in enumerate(leaves)]
    return jax.tree_util.tree_unflatten(treedef, new)


def _jax_layout(jstate):
    """(group, field, parameter path) of each leaf of a JAX optimizer state,
    in JAX's flatten order, read off its key paths."""
    out = []
    for kp, _ in jax.tree_util.tree_flatten_with_path(jstate)[0]:
        names = [getattr(k, "key", getattr(k, "name", getattr(k, "idx", None)))
                 for k in kp]
        # inner_states / <group> / inner_state / <0 adam, 1 schedule> /
        # <count, mu, nu> [/ parameter path]
        group, part, fld = names[1], names[3], names[4]
        if part == 1:
            out.append((group, "schedule_count", None))
        elif fld == "count":
            out.append((group, "count", None))
        else:
            out.append((group, fld, "/".join(str(n) for n in names[5:])))
    return out


def _at(tree, path):
    for p in path.split("/"):
        tree = tree[p]
    return tree


def _jax_moment(jstate, group, fld, path):
    return np.asarray(_at(
        getattr(jstate.inner_states[group].inner_state[0], fld), path))


def test_optax_leaf_order_is_read_off_jax(field):
    _, jp, _ = field
    jstate = _jax_opt_state(jp)
    tp, _ = port_field(jp, field[2])
    assert TCK._optax_layout(tp) == _jax_layout(jstate)


def test_jax_checkpoint_loads_in_the_port(field, tmp_path, capsys):
    jcfg, jp, js = field
    js1, _ = JLC.update_alpha_mask(jcfg, jp, js, GRID)
    jstate = _jax_opt_state(jp)
    path = str(tmp_path / "jax.npz")
    extra = {"iteration": 7, "train_state": {"iteration": 7,
                                             "voxel_list": [1, 2]}}
    JCK.save_checkpoint(path, jcfg, to_numpy(jp), to_numpy(js1), extra=extra,
                        opt_state=to_numpy(jstate),
                        rng_key=np.asarray(jax.random.PRNGKey(3)))
    tcfg, tp, ts, t_extra = TCK.load_checkpoint(path, device="cpu")
    jcfg2, jp2, js2, j_extra = JCK.load_checkpoint(path)
    assert "ignoring the JAX package's train/rng_key" in capsys.readouterr().out
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg2)
    _assert_trees_equal(tp, to_numpy(jp2))
    # alpha_volume_packed is rebuilt on load, on each side by its own code
    _assert_trees_equal(ts, to_numpy(js2))
    assert ts["alpha_volume_packed"].dtype == torch.bfloat16
    assert t_extra["train_state"] == j_extra["train_state"] == \
        extra["train_state"]
    assert "torch_rng_state" not in t_extra

    # the optimizer leaves go into the port's GroupAdam state
    template = TO.make_optimizer(tp, 0.02, 1e-3, 0.999).init(tp)
    state = TCK.restore_opt_state(template, t_extra["opt_leaves"], tp)
    for grp, fld, p in _jax_layout(jstate):
        if p is None:
            if fld == "count":
                assert state["count"][grp] == int(
                    jstate.inner_states[grp].inner_state[0].count)
            continue
        got = state[fld][p]
        assert got.dtype == torch.float32 and got.shape == _at(tp, p).shape
        assert np.array_equal(got.numpy(), _jax_moment(jstate, grp, fld, p))

    r = rays(64, seed=2)
    lidx = np.zeros((64,), np.int32)
    jout = j_render_rays(jcfg2, jp2, js2, jnp.asarray(r), jnp.asarray(lidx),
                         n_samples=S, key=None, is_relight=False,
                         white_bg=True, app_cap=8)
    tout = t_render_rays(tcfg, tp, ts, t(r), t(lidx, torch.int32),
                         n_samples=S, key=None, is_relight=False,
                         white_bg=True, app_cap=8)
    acc = np.asarray(jout["acc_map"])
    assert (acc > 0.5).any() and (acc < 0.5).any()
    for k in ("rgb_map", "depth_map", "acc_map"):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   rtol=2e-5, atol=2e-6, err_msg=k)


def test_port_checkpoint_loads_in_jax(field, tmp_path):
    jcfg, jp, js = field
    tcfg = port_cfg(jcfg)
    js1, _ = JLC.update_alpha_mask(jcfg, jp, js, GRID)
    tp, ts = port_field(jp, js1)
    # a GroupAdam state with distinct moments and counts
    state = TO.make_optimizer(tp, 0.02, 1e-3, 0.999).init(tp)
    gen = torch.Generator().manual_seed(4)
    for fld in ("mu", "nu"):
        for k, v in state[fld].items():
            v.copy_(torch.randn(v.shape, generator=gen))
    state["count"] = {"spatial": 5, "network": 6, "light": 7}
    gen_state = torch.Generator().manual_seed(9).get_state()
    sampler = {"total": 10, "curr": 4, "drawn": True,
               "rng": np.random.default_rng(1).bit_generator.state}
    path = str(tmp_path / "port.npz")
    TCK.save_checkpoint(path, tcfg, tp, ts, extra={"iteration": 3},
                        opt_state=state, rng_state=gen_state,
                        sampler_state=sampler)

    jcfg2, jp2, js2, j_extra = JCK.load_checkpoint(path)
    assert dataclasses.asdict(jcfg2) == dataclasses.asdict(jcfg)
    _assert_trees_equal(tp, to_numpy(jp2))
    _assert_trees_equal(ts, to_numpy(js2))
    assert j_extra["iteration"] == 3 and "rng_key" not in j_extra
    # the leaves restore into a fresh optax state, each where JAX keeps it
    jstate = JCK.restore_opt_state(
        JO.make_optimizer(jp2, 0.02, 1e-3, 0.999).init(jp2),
        j_extra["opt_leaves"])
    for grp, fld, p in _jax_layout(jstate):
        if p is None:
            inner = jstate.inner_states[grp].inner_state
            count = inner[1 if fld == "schedule_count" else 0].count
            assert int(count) == state["count"][grp]
            continue
        assert np.array_equal(_jax_moment(jstate, grp, fld, p),
                              state[fld][p].numpy()), (grp, fld, p)

    # and back into the port, with the generator and the sampler
    _, tp3, ts3, t_extra = TCK.load_checkpoint(path, device="cpu")
    _assert_trees_equal(tp3, tp)
    _assert_trees_equal(ts3, ts)
    assert torch.equal(t_extra["torch_rng_state"], gen_state)
    assert t_extra["sampler_state"] == sampler
    back = TCK.restore_opt_state(
        TO.make_optimizer(tp, 0.02, 1e-3, 0.999).init(tp),
        t_extra["opt_leaves"], tp)
    assert back["count"] == state["count"]
    for fld in ("mu", "nu"):
        for k in state[fld]:
            assert torch.equal(back[fld][k], state[fld][k]), (fld, k)
    assert os.path.getsize(path) > 0
