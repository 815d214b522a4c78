"""TensorCP as the ``armadillo_cp`` configuration runs it, at small sizes on
seeded weights: the port's CP field and the benchmark's frozen reference
held to a plain TensoRF-CP field in gather form
(``portbench/reference/models/cp_plain.py``); the benchmark's CP scene
through the program's and the reference's lifecycle; tiny runs of the two
cells ``armadillo_cp.eval_view`` and ``armadillo.radiance_train``, sound and
broken; the CP FLOP count; the ``line_matrix`` span in a lookup that takes a
gradient, and the ``line_taps`` span in one that does not and in every tile
of the secondary pass.

Marked ``cuda``: the TF32 control and the faults at the two cells' own
sizes and limits come out not ``correct``. Run on the card: ``python -m
pytest tests/test_torch_cp_published.py -m cuda --noconftest`` (the
suite's conftest needs JAX; this file imports none of it).
"""
import copy
import json
import sys
import time
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import control  # noqa: E402
from portbench.harness import check, flops, flops_cp, knobs, main  # noqa: E402
from portbench.harness import scene as bscene  # noqa: E402
from portbench.harness import scene_cp  # noqa: E402
from portbench.paths import eval_chunk, eval_chunk_cp  # noqa: E402
from portbench.paths import radiance_step  # noqa: E402
from portbench.reference.models import cp_plain  # noqa: E402
from portbench.reference.models import field as RF  # noqa: E402
from portbench.reference.models import lifecycle as RLC  # noqa: E402
from portbench.tests import tiny  # noqa: E402
from tensoir_tpu_torch.models import field as TF  # noqa: E402
from tensoir_tpu_torch.models import lifecycle as TLC  # noqa: E402
from tensoir_tpu_torch.ops import interp  # noqa: E402
from tensoir_tpu_torch.render import secondary as TSec  # noqa: E402

CP_CELL, RAD_CELL = "armadillo_cp.eval_view", "armadillo.radiance_train"
# the tiny CP widths: the sizes of portbench/tests/tiny.py, one component
# count for the three lines, as CP has
TINY_CP = dict(n_lamb_sigma=[4, 4, 4], n_lamb_sh=[6, 6, 6])
TINY_SCENE = dict(init_voxels=16 ** 3, final_voxels=24 ** 3)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cp_field(seed=0, grid=(14, 11, 9), r=5, ra=7, app_dim=4):
    """(FieldConfig, params) of a small CP field on seeded weights."""
    cfg = TF.FieldConfig(decomp="cp", density_n_comp=(r,) * 3,
                         app_n_comp=(ra,) * 3, app_dim=app_dim, feature_c=8,
                         num_sgs=4, envmap_h=2, envmap_w=4)
    params, _ = TF.init_field_params(torch.Generator().manual_seed(seed),
                                     cfg, grid, [[-1.5] * 3, [1.5] * 3],
                                     device="cpu")
    return cfg, params


def _coords(n=300, seed=1, reach=1.15):
    """Points over [-reach, reach]^3: inside the grid, and past either end
    of it, where the lines extend."""
    g = torch.Generator().manual_seed(seed)
    return (torch.rand((n, 3), generator=g) * 2.0 - 1.0) * reach


def _ref_cfg(cfg):
    return RF.FieldConfig(**{f: getattr(cfg, f) for f in
                             cfg.__dataclass_fields__})


# ---------------------------------------------------------------- the field

@pytest.mark.parametrize("side", ["port", "frozen_reference"])
def test_cp_density_and_appearance_equal_the_plain_field(side):
    cfg, params = _cp_field()
    coords = _coords()
    lidx = torch.zeros(coords.shape[0], dtype=torch.int32)
    mod, c = (TF, cfg) if side == "port" else (RF, _ref_cfg(cfg))
    with torch.no_grad():
        dens = mod.density_feature(c, params, coords)
        app = mod.app_feature(c, params, coords, lidx)
    # float32, the same two taps: the product form adds exact zeros, so
    # only the order of a few roundings differs
    torch.testing.assert_close(dens, cp_plain.density_feature(params, coords),
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(app, cp_plain.app_feature(params, coords, lidx),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("side", ["port", "frozen_reference"])
def test_cp_sigma_bake_equals_the_plain_field_on_its_nodes(side):
    cfg, params = _cp_field(seed=2)
    mod, c = (TF, cfg) if side == "port" else (RF, _ref_cfg(cfg))
    baked = mod.bake_sigma_feature_grid(c, params)
    plain = cp_plain.sigma_on_nodes(params)
    assert baked.shape == plain.shape == (9, 11, 14)
    torch.testing.assert_close(baked, plain, rtol=1e-5, atol=1e-6)
    # the nodes are where the gather form reads one tap exactly
    z, y, x = torch.meshgrid(*(torch.linspace(-1.0, 1.0, n)
                               for n in plain.shape), indexing="ij")
    at = torch.stack([x, y, z], -1).reshape(-1, 3)
    torch.testing.assert_close(cp_plain.density_feature(params, at),
                               plain.reshape(-1), rtol=1e-5, atol=1e-6)


def test_plain_lines_extend_below_the_first_node_and_stay_flat_past_the_last():
    line = torch.tensor([[1.0], [3.0], [4.0]])
    z = torch.tensor([-2.0, -1.0, 0.0, 1.0, 2.0])
    got = cp_plain.line_lookup(line, z)[:, 0]
    assert got.tolist() == [-1.0, 1.0, 3.0, 4.0, 4.0]
    torch.testing.assert_close(
        interp.lerp_line_matmul(line, z, extrapolate=True)[:, 0], got)


# ---------------------------------------------------------- the CP scene

def _tiny_cp_config():
    conf = json.loads((ROOT / "portbench/configs/armadillo_cp.json")
                      .read_text())
    conf["config"].update(tiny.CONFIG)
    conf["config"].update(TINY_CP)
    conf["scene"].update(TINY_SCENE)
    return conf


def test_scene_cp_gives_the_same_field_through_both_lifecycles():
    conf = _tiny_cp_config()
    c, recipe = conf["config"], conf["scene"]
    fk = knobs.field_kwargs(c)
    assert fk["decomp"] == "cp"
    seed = 2 ** 31 + 17
    prog = scene_cp.derive_field(TLC, TF.FieldConfig(**fk), fk, c, recipe,
                                 seed, "cpu")
    ref = scene_cp.derive_field(RLC, RF.FieldConfig(**fk), fk, c, recipe,
                                seed, "cpu")
    (pp, ps, pn), (rp, rs, rn) = prog, ref
    assert pn == rn > 0
    assert set(pp) == set(rp)
    assert not [k for k in pp if "plane" in k]
    for k in pp:
        if isinstance(pp[k], dict):
            for j in pp[k]:
                assert torch.equal(pp[k][j], rp[k][j]), (k, j)
        else:
            assert torch.equal(pp[k], rp[k]), k
    for k in ("aabb", "alpha_volume", "alpha_volume_packed", "alpha_aabb"):
        assert torch.equal(ps[k], rs[k]), k
    # the shrink cut the box, the upsample put 24^3 voxels on it, the
    # lines hold the grid, and the second mask is at that grid
    assert float(ps["has_alpha_mask"]) == 1.0
    grid = TF.grid_size_of(pp)
    assert grid == TLC.n_to_reso(recipe["final_voxels"],
                                 ps["aabb"].numpy())
    assert ps["alpha_volume"].shape == grid[::-1]
    assert (ps["aabb"][1] - ps["aabb"][0] < 3.0).all()
    # the blob: the density feature at the centre is the bump's product
    centre = torch.zeros((1, 3))
    with torch.no_grad():
        assert float(TF.density_feature(TF.FieldConfig(**fk), pp,
                                        centre)) > 10.0


def test_raw_cp_field_has_init_field_params_keys_and_shapes():
    conf = _tiny_cp_config()
    fk = knobs.field_kwargs(conf["config"])
    reso = (12, 10, 8)
    raw = scene_cp.raw_field(fk, reso, 5, "cpu")
    ref, _ = TF.init_field_params(torch.Generator().manual_seed(0),
                                  TF.FieldConfig(**fk), reso,
                                  [[-1.5] * 3, [1.5] * 3], device="cpu")
    assert set(raw) == set(ref)
    for k in raw:
        if isinstance(raw[k], dict):
            assert {j: v.shape for j, v in raw[k].items()} == {
                j: v.shape for j, v in ref[k].items()}, k
        else:
            assert raw[k].shape == ref[k].shape, k
    with pytest.raises(ValueError):
        scene_cp.raw_field(dict(fk, decomp="vm"), reso, 5, "cpu")
    # the same seed, the same field
    again = scene_cp.raw_field(fk, reso, 5, "cpu")
    assert torch.equal(raw["density_line_0"], again["density_line_0"])


# --------------------------------------------------------- the two cells

def _tiny_cell(name):
    """(cell entry, config, traffic) of a new cell at tiny sizes."""
    if name == RAD_CELL:
        entry, conf, traffic = main.cell_files(main.load_manifest(), name)
        conf["config"].update(tiny.CONFIG)
        conf["scene"].update(tiny.SCENE["armadillo"])
        traffic.update({k: v for k, v in tiny.TRAFFIC.items()
                        if k in traffic})
        return entry, conf, traffic
    m = main.load_manifest()
    entry = {w["name"]: w for w in m["workloads"]}[name]
    traffic = json.loads((ROOT / "portbench/traffic" /
                          f"{entry['traffic']}.json").read_text())
    traffic.update({k: v for k, v in tiny.TRAFFIC.items() if k in traffic})
    return entry, _tiny_cp_config(), traffic


def _variant(name, variant):
    """The path of ``name``'s traffic with ``variant`` in the program's
    place, as ``control.variant_class`` makes it. Its ``altered`` eval
    fault is written for ``eval_chunk.Path`` by identity: the CP path takes
    it through the MRO, the variant's ``_build`` calling the CP one."""
    if name == RAD_CELL:
        return control.variant_class(radiance_step.Path, variant)
    if variant == "altered":
        return type("AlteredCP", (control.variant_class(eval_chunk.Path,
                                                        variant),
                                  eval_chunk_cp.Path), {})
    return control.variant_class(eval_chunk_cp.Path, variant)


def read_variant(name, conf, traffic, variant, seed, seconds, device):
    """``control.read`` for the new cells' paths: one seed's numbers with
    ``variant`` in the program's place, against the cell's limits."""
    path = _variant(name, variant)(config=conf, traffic=traffic, seed=seed,
                                   device=device)
    path.setup()
    if name != RAD_CELL:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            path.units(1)
    path.release()
    control._tf32(False)
    if str(device).startswith("cuda"):
        torch.cuda.empty_cache()
    numbers = path.compare(check.load_limits(name))
    return check.verdict(numbers), numbers, path.extra()


@pytest.mark.parametrize("name", [CP_CELL, RAD_CELL])
def test_a_sound_run_of_a_new_cell_is_correct(name):
    entry, conf, traffic = _tiny_cell(name)
    m = main.load_manifest()
    res = main.run_cell(conf, traffic, seed=2 ** 31 + 11, seconds=0.5,
                        trace=False, device="cpu",
                        t_start=time.perf_counter(),
                        limits=check.load_limits(name),
                        metrics=main.metrics_of(m, entry, False))
    assert res["correct"], res["numbers"]
    # the program and the reference are the same arithmetic on the CPU
    assert all(v == 0.0 for _, v, _ in res["numbers"])
    assert set(res["metrics"]) >= {"setup_s"}
    assert res["attempted"] >= 1
    if name == CP_CELL:
        assert {n for n, _, _ in res["numbers"]} == {"map_gap"}
        assert res["extra"]["n_samples"] > 0
    else:
        assert {n for n, _, _ in res["numbers"]} == {
            "loss_gap", "grad_gap", "change_gap"}
        # the radiance phase: iteration 0, the raw 128^3 grid cut to tiny
        assert res["extra"]["n_samples"] == TLC.cal_n_samples(
            (16, 16, 16), conf["config"]["step_ratio"])


@pytest.mark.parametrize("name,variant", [(CP_CELL, "altered"),
                                          (RAD_CELL, "half_batch"),
                                          (RAD_CELL, "unchanged")])
def test_a_broken_new_cell_is_not_correct(name, variant):
    _, conf, traffic = _tiny_cell(name)
    ok, numbers, _ = read_variant(name, conf, traffic, variant,
                                  2 ** 31 + 13, 0.5, "cpu")
    assert not ok, numbers


def test_the_radiance_step_is_the_loops_iteration_0_step():
    _, conf, traffic = _tiny_cell(RAD_CELL)
    path = radiance_step.Path(config=conf, traffic=traffic, seed=3,
                              device="cpu")
    params, scn, n, state, flatten, fn = path._build(False)
    c = conf["config"]
    assert float(scn["has_alpha_mask"]) == 0.0
    assert TF.grid_size_of(params) == (16, 16, 16)
    assert "density_plane_0" in params
    assert traffic["start_iter"] == 0
    batch = {"rays": bscene.view_rays(bscene.camera_dirs(1, 0.1, "cpu"),
                                      8, 4.0, 0.4)[:32],
             "light_idx": torch.zeros(32, dtype=torch.int32)}
    batch["rgbs"] = bscene.ray_colours(batch["rays"])
    _, _, m = fn(params, state, scn, batch, torch.Generator(), 0)
    # the radiance phase's losses: L1 at its first weight and both TVs
    assert {"loss_l1", "loss_tv_density", "loss_tv_app"} <= set(m)
    assert "loss_rgb_brdf" not in m and "n_acc_masked" not in m
    assert c["L1_weight_inital"] != c["L1_weight_rest"]


# ------------------------------------------------------------- the counts

def test_flops_cp_per_point_is_its_docstrings_formula():
    fk = dict(density_n_comp=(96, 96, 96), app_n_comp=(288, 288, 288),
              app_dim=27, feature_c=128, view_pe=2, fea_pe=2, pos_pe=2,
              num_sgs=128)
    w = flops_cp.widths(fk)
    # 3 lines x (2 taps: 2 multiplies, 1 add, 1 complement) + the
    # three-way product + the sum (density) or the light factor (app)
    assert w["density"] == (3 * 4 + 2 + 1) * 96 == 1440
    assert w["app"] == 15 * 288 + 2 * 288 * 27
    base = flops.widths(fk)
    for k in ("render_mlp", "brdf_mlp", "normal_mlp", "sg_light",
              "app_baked"):
        assert w[k] == base[k]
    kw = dict(march_cap=256, app_cap=64, light_dirs=512, second_n_sample=96,
              second_app_cap=16)
    bare = flops.primary(w, 4096, 256, 64)
    assert flops_cp.eval_chunk(fk, 4096, 0, **kw) == bare
    one = flops_cp.eval_chunk(fk, 4096, 1, **kw) - bare
    assert one == 512 * (w["sg_light"] + flops.BRDF_PER_PAIR + 96 * 16
                         + 16 * (w["app"] + w["render_mlp"]))


def test_radiance_step_flops_by_hand():
    fk = dict(density_n_comp=(1, 1, 1), app_n_comp=(1, 1, 1), app_dim=2,
              feature_c=4, view_pe=0, fea_pe=0, pos_pe=0, num_sgs=2)
    w = flops.widths(fk)
    assert radiance_step.step_flops(fk, 3, 5, 2) == 3 * 3 * (
        5 * w["density"] + 2 * (w["app"] + w["render_mlp"]))


def _line_matrix_spans(fn, name="line_matrix"):
    """How many ``name`` spans (``line_matrix`` by default) ``fn()`` opens
    under a profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.no_grad():
            fn()
    return [e.name for e in prof.events()
            if getattr(e, "is_user_annotation", False)].count(name)


@pytest.mark.parametrize("extrapolate", [False, True])
def test_line_matrix_span_wraps_either_branch_once_a_call(extrapolate):
    line = torch.randn(7, 5)
    z = torch.rand(4, 3) * 2 - 1
    assert _line_matrix_spans(lambda: interp.lerp_line_matmul(
        line, z, extrapolate=extrapolate)) == 1
    # the span leaves the value alone
    torch.testing.assert_close(
        interp.lerp_line_matmul(line, z, extrapolate=extrapolate),
        interp.lerp_line(line, z), rtol=1e-6, atol=1e-6)


def test_line_matrix_span_opens_under_a_profiler():
    """Where a gradient can flow (here to the coordinates, as in derived
    normals) each of CP's three lines opens ``line_matrix``; without one
    the three lookups are one ``line_taps`` span and no matrix."""
    cfg, params = _cp_field()
    assert _line_matrix_spans(lambda: TF.density_feature(
        cfg, params, _coords(n=10)), "line_taps") == 1
    assert _line_matrix_spans(lambda: TF.density_feature(
        cfg, params, _coords(n=10))) == 0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        TF.density_feature(cfg, params, _coords(n=10).requires_grad_())
    evs = prof.events()
    names = [e.name for e in evs if getattr(e, "is_user_annotation", False)]
    assert names.count("line_matrix") == 3
    assert "field" in names
    # the matrix's product inside the span
    spans = [e for e in evs if e.name == "line_matrix"]
    mms = [e for e in evs if e.name in ("aten::matmul", "aten::mm")]
    assert any(s.time_range.start <= m.time_range.start
               and m.time_range.end <= s.time_range.end
               for s in spans for m in mms)


def test_an_eager_cp_pass_opens_line_matrix_in_every_tile():
    """The secondary pass on the CPU (eager tiles): no gradient flows, so
    each tile's app stage reads its three lines' taps in one ``line_taps``
    span and makes no line matrix; the bake makes neither (an einsum)."""
    cfg, params = _cp_field(grid=(12, 12, 12))
    scene = TF.init_field_params(torch.Generator().manual_seed(0), cfg,
                                 (12, 12, 12), [[-1.5] * 3, [1.5] * 3],
                                 device="cpu")[1]
    g = torch.Generator().manual_seed(4)
    P, L = 8, cfg.envmap_h * cfg.envmap_w
    pts = torch.rand((P, 3), generator=g) - 0.5
    dirs = torch.randn((P, L, 3), generator=g)
    dirs = dirs / dirs.norm(dim=-1, keepdim=True)
    mask = torch.ones((P, L), dtype=torch.bool)
    lidx = torch.zeros(P, dtype=torch.int32)
    tile = 16

    def run():
        TSec.reset_tile_graph_counts()
        return TSec.secondary_shading_tiled(
            cfg, params, scene, pts, dirs, lidx, mask, TSec.SecondaryKnobs(
                second_n_sample=8, second_near=0.05, second_far=1.5,
                secondary_tile=tile, second_app_cap=2))

    opened = {name: _line_matrix_spans(run, name)
              for name in ("line_matrix", "line_taps")}
    n_tiles = P * L // tile
    assert TSec.TILE_GRAPH["eager"] == n_tiles
    assert opened == {"line_matrix": 0, "line_taps": n_tiles}


# ------------------------------------------------ the control on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control is TF32, which only the "
                    "card computes, at the cells' own sizes")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name,variant", [(CP_CELL, "tf32"),
                                          (CP_CELL, "altered"),
                                          (RAD_CELL, "tf32"),
                                          (RAD_CELL, "half_batch"),
                                          (RAD_CELL, "unchanged")])
def test_control_and_faults_of_the_new_cells_are_not_correct(card, name,
                                                             variant):
    _, conf, traffic = main.cell_files(main.load_manifest(), name)
    ok, numbers, extra = read_variant(name, copy.deepcopy(conf), traffic,
                                      variant, 2 ** 31 + 21, 5.0, card)
    print(name, variant, numbers, extra)
    assert not ok, numbers
