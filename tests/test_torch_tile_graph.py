"""The secondary pass's tile graph (``render/secondary.py``): on CUDA one
tile of ``secondary_shading_tiled`` is captured as CUDA graphs per knob
set, in pieces that end at each K1 call, and replayed for every tile with
K1 launched between the pieces.

On the CPU: the tiles run eager and nothing is captured; the pass equals a
loop of eager per-tile ``compute_radiance`` bit for bit under every knob;
the graph key (plain Python) holds through an in-place parameter update and
a new bake and changes with a replaced parameter, a new shape or a knob.

Marked ``cuda``, the same equalities on the card, where the pass captures
and replays: bit for bit with the eager loop, the same K1 launches counted,
one capture per knob set, a replaced parameter recaptured with the old
graph freed; under ``torch.profiler`` the replays charge the
``secondary_march`` range what the eager tiles charge it, and make the
same K1 calls from Python. Run on the card: ``python -m pytest
tests/test_torch_tile_graph.py -m cuda --noconftest`` (the suite's conftest
needs JAX; this file imports only the port).
"""
import gc
import weakref

import pytest
import torch

from tensoir_tpu_torch.kernels import LAUNCHES, reset_launch_counts, rows
from tensoir_tpu_torch.models import field as TF
from tensoir_tpu_torch.models import lifecycle as LC
from tensoir_tpu_torch.render import primary
from tensoir_tpu_torch.render import secondary as TSec
from tensoir_tpu_torch.utils.bench_scene import seed_solid_blob

AABB = ((-1.5, -1.5, -1.5), (1.5, 1.5, 1.5))
DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]

# per device: the field's widths and grid, the pairs, the march, and the
# sizes of the fast knobs. On the card the armadillo cell's widths, tile
# and sample count (and 4 tiles); on the CPU small ones (4 tiles)
SIZES = {
    "cpu": dict(cfg=dict(density_n_comp=(4, 4, 4), app_n_comp=(6, 6, 6),
                         app_dim=8, feature_c=16, num_sgs=8, envmap_h=4,
                         envmap_w=8),
                grid=(24, 20, 16), points=64, tile=512, n_sample=16,
                window=8, window_back=4, reso=12),
    "cuda": dict(cfg=dict(), grid=(48, 44, 40), points=128, tile=16384,
                 n_sample=96, window=48, window_back=16, reso=32),
}

# the knob sets of ``secondary_shading_tiled`` each case runs (``W``,
# ``WB`` and ``R`` stand for the device's window, back window and bake
# resolution)
CASES = {
    "armadillo": dict(),
    "window": dict(second_window="W", second_window_back="WB",
                   second_prepass_n=18),
    "compaction": dict(secondary_compact_frac=0.5625),
    "grouped": dict(second_window="W", second_window_back="WB",
                    second_prepass_n=18, second_march_group=2,
                    group_bake_reso="R"),
    "hoist": dict(secondary_app_hoist=True),
    "stats": dict(secondary_stats=True, second_window_probe="W",
                  second_window_probe_back="WB"),
    "app_bake": dict(app_bake_reso="R"),
    "exact": dict(secondary_use_baked=False, second_march_cap=8),
    "cp": dict(),
}


def _knobs(case: str, dev: str) -> TSec.SecondaryKnobs:
    s = SIZES[dev]
    names = {"W": s["window"], "WB": s["window_back"], "R": s["reso"]}
    kw = {k: names.get(v, v) if isinstance(v, str) else v
          for k, v in CASES[case].items()}
    return TSec.SecondaryKnobs(second_n_sample=s["n_sample"],
                               second_near=0.05, second_far=1.5,
                               secondary_tile=s["tile"], **kw)


def _field(dev: str, decomp: str = "vm"):
    """(cfg, params, scene): a blob field, masked at its grid."""
    s = SIZES[dev]
    cfg = TF.FieldConfig(decomp=decomp, **s["cfg"])
    gen = torch.Generator().manual_seed(0)
    params, scene = TF.init_field_params(gen, cfg, s["grid"], AABB,
                                         device=dev)
    with torch.no_grad():
        if decomp == "vm":
            seed_solid_blob(params, amp=4.0, sharp=0.2)
        else:
            for i in range(3):
                ln = params[f"density_line_{i}"]
                z = torch.linspace(-1.0, 1.0, ln.shape[0], device=ln.device)
                ln[:, 0] += 4.0 * torch.exp(-z ** 2 / 0.2)
    scene, _ = LC.update_alpha_mask(cfg, params, scene, s["grid"])
    return cfg, params, scene


def _pairs(cfg, dev: str, seed: int = 1):
    """(surface points [P, 3], light dirs [P, L, 3], light indices [P],
    the cosine mask [P, L]): points in the blob's shell, the fixed
    directions, random normals."""
    g = torch.Generator().manual_seed(seed)
    P, L = SIZES[dev]["points"], cfg.envmap_h * cfg.envmap_w
    d = torch.randn(P, 3, generator=g)
    pts = d / d.norm(dim=-1, keepdim=True) * (0.2 + 0.5 * torch.rand(
        P, 1, generator=g))
    dirs = torch.randn(L, 3, generator=g)
    dirs = dirs / dirs.norm(dim=-1, keepdim=True)
    normals = torch.randn(P, 3, generator=g)
    surf2l = dirs[None].expand(P, L, 3).contiguous()
    mask = (surf2l * normals[:, None]).sum(-1) > 1e-6
    lidx = torch.zeros(P, dtype=torch.int32)
    return tuple(x.to(dev) for x in (pts, surf2l, lidx, mask))


@torch.no_grad()
def eager_pass(cfg, params, scene, surf_pts, surf2light, light_idx,
               pair_mask, k):
    """The pass on the knobs ``k`` as a loop of eager ``compute_radiance``
    calls, one a tile, each tile's results collected and joined after the
    loop."""
    tile = k.secondary_tile
    baked = coarse = baked27 = app_baked = None
    if k.secondary_use_baked:
        baked = TF.bake_packed_sigma_grid(cfg, params, scene,
                                          max_reso=k.secondary_bake_reso)
        if 0 < k.second_window < k.second_n_sample:
            coarse = TF.bake_coarse_occupancy(baked, dilate=k.coarse_dilate)
            if k.second_march_group > 1:
                baked27 = TF.bake_pair_packed_sigma_grid(
                    cfg, params, scene,
                    max_reso=k.group_bake_reso or k.secondary_bake_reso)
        if k.app_bake_reso > 0 and cfg.decomp in ("vm", "vm_stacked"):
            app_baked = (TF.bake_app_feature_grid(cfg, params,
                                                  max_reso=k.app_bake_reso),
                         TF.app_bake_cells(cfg, params, k.app_bake_reso))
    P, L, _ = surf2light.shape
    pts = surf_pts[:, None, :].expand(P, L, 3).reshape(-1, 3)
    dirs = surf2light.reshape(-1, 3)
    lidx = light_idx[:, None].expand(P, L).reshape(-1)
    mask = pair_mask.reshape(-1)
    total = P * L
    compact = 0.0 < k.secondary_compact_frac < 1.0
    compact_overflow = None
    if compact:
        cap = -(-int(total * k.secondary_compact_frac) // tile) * tile
        cidx, cvalid = primary.compact_nonzero(mask, cap)
        src = cidx.clamp(max=total - 1)
        pts, dirs, lidx = pts[src], dirs[src], lidx[src]
        if k.secondary_stats:
            n_in = mask.sum(dtype=torch.float32)
            compact_overflow = ((n_in - cvalid.sum(dtype=torch.float32))
                                .clamp_min(0.0) / n_in.clamp_min(1.0))
        mask, n_rows, app_pair_cap = cvalid, cap, tile // 2
    else:
        n_rows, app_pair_cap = total, tile // 4
    if 0.0 < k.app_pair_frac <= 1.0:
        app_pair_cap = max(1, int(tile * k.app_pair_frac))
    n_tiles = -(-n_rows // tile)
    pad = n_tiles * tile - n_rows
    if pad:
        pts = torch.cat([pts, pts.new_zeros((pad, 3))])
        dirs = torch.cat([dirs, dirs.new_ones((pad, 3))])
        lidx = torch.cat([lidx, lidx.new_zeros((pad,))])
        mask = torch.cat([mask, mask.new_zeros((pad,))])
    vis, ind, tile_stats, payloads = [], [], [], []
    app_hoist = k.secondary_app_hoist
    stats_on = k.secondary_stats and not app_hoist
    for t0 in range(0, n_tiles * tile, tile):
        sl = slice(t0, t0 + tile)
        m = mask[sl]
        out = TSec.compute_radiance(
            cfg, params, scene, pts[sl], dirs[sl], lidx[sl],
            n_sample=k.second_n_sample, vis_near=k.second_near,
            vis_far=k.second_far, app_cap=k.second_app_cap,
            app_pair_cap=app_pair_cap, march_cap=k.second_march_cap,
            baked=baked, coarse=coarse, baked27=baked27,
            march_group=max(k.second_march_group, 2), app_baked=app_baked,
            window=k.second_window, window_back=k.second_window_back,
            prepass_n=k.second_prepass_n, return_app_payload=app_hoist,
            return_stats=stats_on, pair_ok=m,
            probe_window=k.second_window_probe,
            probe_window_back=k.second_window_probe_back)
        mf = m.to(out[0].dtype)
        vis.append(out[0] * mf)
        if app_hoist:
            payloads.append(out[2])
        else:
            ind.append(out[2] * mf[:, None])
        if stats_on:
            tile_stats.append(out[3])
    vis = torch.cat(vis)
    if app_hoist:
        payload = {k: torch.stack([p[k] for p in payloads])
                   for k in payloads[0]}
        ind = TSec._app_stage_global(cfg, params, payload, app_baked, tile)
        ind = ind.reshape(-1, 3) * mask.to(ind.dtype)[:, None]
    else:
        ind = torch.cat(ind)
    if compact:
        both = torch.cat([vis[:cap, None], ind[:cap]], -1)
        out = both.new_zeros((total + 1, 4)).index_copy(0, cidx, both)
        vis, ind = out[:total, :1], out[:total, 1:]
    else:
        vis, ind = vis[:total, None], ind[:total]
    vis, ind = vis.reshape(P, L, 1), ind.reshape(P, L, 3)
    if not k.secondary_stats:
        return vis, ind
    if app_hoist:
        return vis, ind, {}
    ts = {k: torch.stack([s[k] for s in tile_stats]) for k in tile_stats[0]}
    return vis, ind, TSec._reduce_stats(ts, n_tiles=n_tiles,
                                        app_pair_cap=app_pair_cap,
                                        compact_overflow=compact_overflow)


def _need(dev: str) -> None:
    if dev == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")


def _run(fn, *args):
    """(fn's result, the K1/K2 launches it counted)."""
    reset_launch_counts()
    out = fn(*args)
    if out[0].is_cuda:
        torch.cuda.synchronize()
    return out, dict(LAUNCHES)


def _assert_equal(got, want) -> None:
    """Every output bit for bit: visibility, indirect light, stats."""
    assert len(got) == len(want)
    for g, w in zip(got[:2], want[:2]):
        assert g.shape == w.shape and torch.equal(g, w)
    if len(want) == 3:
        assert sorted(got[2]) == sorted(want[2])
        for k in want[2]:
            assert torch.equal(got[2][k], want[2][k]), k


def _tiles(pairs, kw) -> int:
    n, tile = pairs[3].numel(), kw.secondary_tile
    if 0.0 < kw.secondary_compact_frac < 1.0:
        n = -(-int(n * kw.secondary_compact_frac) // tile) * tile
    return -(-n // tile)


def _check_pass(dev, cfg, params, scene, pairs, kw, counts) -> None:
    """The pass against the eager loop, bit for bit and launch for launch,
    and the tile counts it adds to ``TILE_GRAPH`` (captures, replays)."""
    want, want_launches = _run(eager_pass, cfg, params, scene, *pairs, kw)
    TSec.reset_tile_graph_counts()
    got, got_launches = _run(TSec.secondary_shading_tiled, cfg, params,
                             scene, *pairs, kw)
    _assert_equal(got, want)
    assert got_launches == want_launches
    n = _tiles(pairs, kw)
    if dev == "cpu":
        counts = (0, 0)
    assert TSec.TILE_GRAPH == {"captures": counts[0], "replays": counts[1],
                               "eager": n - sum(counts)}


@pytest.mark.parametrize("dev", DEVICES)
@pytest.mark.parametrize("case", list(CASES))
def test_pass_equals_the_eager_loop(dev, case):
    """Each knob set: the first pass captures one tile and replays the
    rest, the second replays every tile; both equal the eager loop bit for
    bit and count its K1 launches. On the CPU every tile is eager."""
    _need(dev)
    TSec._GRAPHS.clear()
    cfg, params, scene = _field(dev, "cp" if case == "cp" else "vm")
    pairs = _pairs(cfg, dev)
    kw = _knobs(case, dev)
    n = _tiles(pairs, kw)
    assert n >= 2
    _check_pass(dev, cfg, params, scene, pairs, kw, (1, n - 1))
    _check_pass(dev, cfg, params, scene, pairs, kw, (0, n))
    assert len(TSec._GRAPHS) == (1 if dev == "cuda" else 0)


@pytest.mark.parametrize("dev", DEVICES)
def test_skipped_tiles_capture_on_the_first_marched_tile(dev):
    """With ``ray_used`` marking points of tiles 1 and 3 only, the pass
    skips tiles 0 and 2 (zeros there), captures on tile 1 and replays tile
    3, then replays both; the marched tiles equal the eager loop bit for
    bit."""
    _need(dev)
    TSec._GRAPHS.clear()
    cfg, params, scene = _field(dev)
    pairs = _pairs(cfg, dev)
    kw = _knobs("armadillo", dev)
    P = pairs[0].shape[0]
    assert _tiles(pairs, kw) == 4
    used = torch.zeros(P, dtype=torch.bool, device=dev)
    used[[P // 4 + 1, 3 * P // 4 + 5]] = True
    want, _ = _run(eager_pass, cfg, params, scene, *pairs, kw)
    tile = kw.secondary_tile
    for counts in ((1, 1), (0, 2)):
        TSec.reset_tile_graph_counts()
        TSec.reset_march_counts()
        got, _ = _run(lambda: TSec.secondary_shading_tiled(
            cfg, params, scene, *pairs, kw, ray_used=used))
        if dev == "cpu":
            counts = (0, 0)
        assert TSec.TILE_GRAPH == {"captures": counts[0],
                                   "replays": counts[1],
                                   "eager": 2 - sum(counts)}
        assert TSec.MARCHED == {"pairs": 2 * tile, "tiles": 2,
                                "skipped": 2}
        for g, w in zip(got, want):
            g, w = g.reshape(4, tile, -1), w.reshape(4, tile, -1)
            assert torch.equal(g[1::2], w[1::2])
            assert not g[0::2].any()


@pytest.mark.parametrize("dev", DEVICES)
def test_in_place_update_and_new_bake_replay(dev):
    """After Adam-like in-place updates (and so a new bake) the pass
    replays the graph it has, and equals the eager loop on the new
    values."""
    _need(dev)
    TSec._GRAPHS.clear()
    cfg, params, scene = _field(dev)
    pairs = _pairs(cfg, dev)
    kw = _knobs("armadillo", dev)
    n = _tiles(pairs, kw)
    _check_pass(dev, cfg, params, scene, pairs, kw, (1, n - 1))
    with torch.no_grad():
        for i, (_, p) in enumerate(TSec._tensors(params)):
            p.mul_(1.0 + 0.01 * ((i % 3) - 1))
    _check_pass(dev, cfg, params, scene, pairs, kw, (0, n))


@pytest.mark.parametrize("dev", DEVICES)
def test_replaced_parameter_recaptures_and_frees_the_old_graph(dev):
    """A parameter replaced by a new tensor (as a mask, shrink or upsample
    replaces them) recaptures: the knob set then holds one graph, and the
    old one is gone."""
    _need(dev)
    TSec._GRAPHS.clear()
    cfg, params, scene = _field(dev)
    pairs = _pairs(cfg, dev)
    kw = _knobs("armadillo", dev)
    n = _tiles(pairs, kw)
    _check_pass(dev, cfg, params, scene, pairs, kw, (1, n - 1))
    old = [weakref.ref(p) for g in TSec._GRAPHS.values() for p in g.pieces]
    assert bool(old) == (dev == "cuda")
    params = dict(params)
    params["density_plane_0"] = params["density_plane_0"] * 1.01
    _check_pass(dev, cfg, params, scene, pairs, kw, (1, n - 1))
    gc.collect()
    assert len(TSec._GRAPHS) == (1 if dev == "cuda" else 0)
    assert all(r() is None for r in old)


@pytest.mark.cuda
def test_profiler_sees_the_replayed_tiles(monkeypatch):
    """Under ``torch.profiler`` the replayed pass charges the
    ``secondary_march`` range the device time of its kernels, as the eager
    tiles do (within 5 %: the copies into the graph), and makes the same K1
    calls from Python, one per launch, on indices of the same sizes."""
    from torch.profiler import ProfilerActivity, profile
    _need("cuda")
    TSec._GRAPHS.clear()
    cfg, params, scene = _field("cuda")
    pairs = _pairs(cfg, "cuda")
    kw = _knobs("armadillo", "cuda")
    TSec.secondary_shading_tiled(cfg, params, scene, *pairs, kw)
    graphed = TSec._tile_runner

    def eager(cfg, params, scene, tables, knobs, first):
        # the tile itself, as the CPU runs it
        return lambda *xs: TSec._tile(cfg, params, scene, *xs, tables, knobs)

    gather = rows.row_gather
    got = {}
    for name, runner in (("graph", graphed), ("eager", eager)):
        calls = []

        def counted(table, idx):
            calls.append(idx.numel())
            return gather(table, idx)

        monkeypatch.setattr(TSec, "_tile_runner", runner)
        monkeypatch.setattr(rows, "row_gather", counted)
        monkeypatch.setattr(TF, "row_gather", counted)
        TSec.reset_tile_graph_counts()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            TSec.secondary_shading_tiled(cfg, params, scene, *pairs, kw)
            torch.cuda.synchronize()
        march_us = sum(e.device_time_total for e in prof.events()
                       if e.name == "secondary_march"
                       and not str(e.device_type).endswith("CUDA"))
        got[name] = (march_us, calls, dict(TSec.TILE_GRAPH))
    n = _tiles(pairs, kw)
    assert got["graph"][2] == {"captures": 0, "replays": n, "eager": 0}
    assert got["graph"][1] == got["eager"][1] and got["eager"][1]
    assert got["eager"][0] > 0
    assert abs(got["graph"][0] / got["eager"][0] - 1.0) < 0.05


def test_cpu_tiles_never_capture():
    """CPU tensors take the eager tile: no capture, no graph, every tile
    counted eager."""
    TSec._GRAPHS.clear()
    cfg, params, scene = _field("cpu")
    pairs = _pairs(cfg, "cpu")
    kw = _knobs("armadillo", "cpu")
    TSec.reset_tile_graph_counts()
    for _ in range(2):
        TSec.secondary_shading_tiled(cfg, params, scene, *pairs, kw)
    n = _tiles(pairs, kw)
    assert TSec.TILE_GRAPH == {"captures": 0, "replays": 0, "eager": 2 * n}
    assert not TSec._GRAPHS


def _key_inputs(cfg, params, scene, tile=512, **knobs):
    """``tile_graph_key``'s arguments as the pass builds them on the
    armadillo knobs: the tile, a fresh bake, a tile of inputs."""
    tables = (TF.bake_packed_sigma_grid(cfg, params, scene), None, None,
              None)
    k = dict(n_sample=16, vis_near=0.05, vis_far=1.5, app_cap=16,
             app_pair_cap=tile // 4, march_cap=32, march_group=2, window=0,
             window_back=0, prepass_n=18, return_app_payload=False,
             return_stats=False, probe_window=0, probe_window_back=0,
             app_cells=None)
    k.update(knobs)
    inputs = (torch.zeros(tile, 3), torch.ones(tile, 3),
              torch.zeros(tile, dtype=torch.int32),
              torch.ones(tile, dtype=torch.bool))
    return TSec._tile, cfg, params, scene, tables, k, inputs


@pytest.mark.parametrize("change,same_knobs,same_tensors", [
    ("in_place_and_bake", True, True),
    ("replaced", True, False),
    ("new_shape", True, False),
    ("knob", False, True)])
def test_graph_key(change, same_knobs, same_tensors):
    """The key holds through an in-place update and a new bake; a replaced
    tensor or a new shape changes its tensor part (the knob set's graph is
    replaced), a knob its knob set (another graph)."""
    cfg, params, scene = _field("cpu")
    knob0, tensors0 = TSec.tile_graph_key(*_key_inputs(cfg, params, scene))
    knobs = {}
    with torch.no_grad():
        if change == "in_place_and_bake":
            for _, p in TSec._tensors(params):
                p.add_(0.01)
        elif change == "replaced":
            params = dict(params, density_line_1=params["density_line_1"]
                          .clone())
        elif change == "new_shape":
            params = LC.upsample(params, (26, 22, 18))
        else:
            knobs = dict(app_cap=8)
    knob1, tensors1 = TSec.tile_graph_key(*_key_inputs(cfg, params, scene,
                                                       **knobs))
    assert (knob1 == knob0) == same_knobs
    assert (tensors1 == tensors0) == same_tensors
