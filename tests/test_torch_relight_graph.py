"""The relight chunk's graphs (``render/relight_pipeline.py``): on CUDA
the chunk's G-buffer pass and each of its visibility tiles replay CUDA
graphs captured at the first call (``secondary.graph_runner``), K1
launched from Python between the graphs' pieces.

On the CPU: the chunk runs eager and captures nothing, ``RELIGHT_GRAPH``
counting only eager stages; the graph key of each stage, as the chunk
builds it, holds through an in-place parameter update and changes with a
replaced parameter or a new input shape.

Marked ``cuda``: the graphed chunk's eight outputs equal the eager
chunk's bit for bit on both visibility routes: five lights and two chunks
in turn (the first call's outputs unchanged by the later calls), and kept
counts of 0, one tile and one tile plus one; one capture per stage and
knob set, a replay for every later call; the same K1 calls from Python
and the same launches as the eager chunk; under ``torch.profiler`` the
``primary`` and ``visibility`` spans charged what the eager chunk charges
them. Run on the card: ``python -m pytest tests/test_torch_relight_graph.py
-m cuda --noconftest`` (the suite's conftest needs JAX).
"""
import contextlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from tensoir_tpu_torch.kernels import LAUNCHES, reset_launch_counts  # noqa
from tensoir_tpu_torch.kernels import rows  # noqa: E402
from tensoir_tpu_torch.models import field as TF  # noqa: E402
from tensoir_tpu_torch.models import lifecycle as LC  # noqa: E402
from tensoir_tpu_torch.models.env_light import EnvironmentLight  # noqa
from tensoir_tpu_torch.render import relight_pipeline as TRP  # noqa: E402
from tensoir_tpu_torch.render import secondary as TSec  # noqa: E402
from tensoir_tpu_torch.utils.bench_scene import seed_solid_blob  # noqa

AABB = ((-1.5, -1.5, -1.5), (1.5, 1.5, 1.5))
ROUTES = [False, True]
LIGHTS = [f"held_out_{i}" for i in range(5)]

# per device: the field's widths and grid, the chunk's rays and light
# samples, the visibility march and tile, the maps' size. On the card the
# relight_view cell's chunk, samples and tile on the armadillo widths; on
# the CPU small ones
SIZES = {
    "cpu": dict(cfg=dict(density_n_comp=(4, 4, 4), app_n_comp=(6, 6, 6),
                         app_dim=8, feature_c=16, num_sgs=8, envmap_h=4,
                         envmap_w=8),
                grid=(24, 20, 16), rays=32, light_samples=16, n_sample=96,
                tile=64, env_hw=(8, 16)),
    "cuda": dict(cfg=dict(), grid=(96, 88, 80), rays=800, light_samples=512,
                 n_sample=96, tile=16384, env_hw=(64, 128)),
}


def _need(dev: str) -> None:
    if dev == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")


def _setup(dev: str):
    """cfg, params, scene, n_samples, the held-out lights and the fast
    route's bakes: a blob field masked at its grid, five random maps."""
    s = SIZES[dev]
    cfg = TF.FieldConfig(**s["cfg"])
    gen = torch.Generator().manual_seed(0)
    params, scene = TF.init_field_params(gen, cfg, s["grid"], AABB,
                                         device=dev)
    with torch.no_grad():
        seed_solid_blob(params, amp=4.0, sharp=0.2)
    scene, _ = LC.update_alpha_mask(cfg, params, scene, s["grid"])
    n = TF.num_samples_for(np.asarray(AABB), s["grid"], cfg.step_ratio)
    env = EnvironmentLight(None, device=dev)
    rng = np.random.default_rng(1)
    for name in LIGHTS:
        img = rng.random(s["env_hw"] + (3,), dtype=np.float32)
        # a bright sun in each map, so that shadows matter
        img[rng.integers(s["env_hw"][0] // 2), rng.integers(
            s["env_hw"][1])] = 500.0
        env.add_light(name, img)
    return dict(cfg=cfg, params=params, scene=scene, n=n, env=env,
                bakes=TRP.bake_visibility(cfg, params, scene))


def _rays(dev: str, seed: int = 0, away: bool = False) -> torch.Tensor:
    """A chunk of rays from one camera across the blob: some hit it, some
    miss it; ``away`` turns them from it (no ray hits)."""
    g = torch.Generator().manual_seed(seed)
    n = SIZES[dev]["rays"]
    o = torch.tensor([0.3, -0.2, 4.0]).expand(n, 3)
    target = torch.cat([(torch.rand(n, 2, generator=g) - 0.5) * 1.6,
                        torch.zeros(n, 1)], 1)
    d = target - o
    d = d / d.norm(dim=-1, keepdim=True)
    return torch.cat([o, -d if away else d], 1).to(dev)


def _fns(s, dev: str, fast_vis: bool, vis_tile=None):
    z = SIZES[dev]
    return {name: TRP.make_relight_chunk_fn(
        s["cfg"], s["env"], name, n_samples=s["n"],
        n_light_samples=z["light_samples"], second_n_sample=z["n_sample"],
        vis_tile=vis_tile or z["tile"], fast_vis=fast_vis)
        for name in LIGHTS}


def _call(s, fn, rays, fast_vis, key=None, draws=None):
    return fn(s["params"], s["scene"], rays, key,
              torch.ones((3,), device=rays.device), draws=draws,
              vis_bakes=s["bakes"] if fast_vis else None)


def _eager_runner(fn, cfg, params, scene, tables, knobs, first, counts,
                  prefix=""):
    """``graph_runner`` as it runs on the CPU: ``fn`` itself."""
    def run(*xs):
        counts["eager"] += 1
        return fn(*xs, tables)
    return run


def _assert_equal(got, want):
    assert len(got) == len(want) == 8
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and a.dtype == b.dtype, i
        assert torch.equal(a, b), (i, (a - b).abs().max().item())


@pytest.fixture(scope="module")
def cpu_side():
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield _setup("cpu")
    torch.set_num_threads(n_threads)


@pytest.mark.parametrize("fast_vis", ROUTES, ids=["exact", "fast"])
def test_cpu_chunk_runs_eager(cpu_side, fast_vis):
    """On the CPU every stage runs eager: nothing is captured, no graph is
    kept, and ``RELIGHT_GRAPH`` counts one eager stage per G-buffer pass
    and per visibility tile."""
    s = cpu_side
    graphs = dict(TSec._GRAPHS)
    fns = _fns(s, "cpu", fast_vis)
    TRP.reset_relight_graph_counts()
    TSec.reset_march_counts()
    key = torch.Generator().manual_seed(3)
    outs = [_call(s, fns[name], _rays("cpu"), fast_vis, key)
            for name in LIGHTS[:2]]
    tiles = TSec.MARCHED["tiles"]
    assert tiles >= 2
    assert TRP.RELIGHT_GRAPH == {
        "gbuffer_captures": 0, "gbuffer_replays": 0, "vis_captures": 0,
        "vis_replays": 0, "eager": 2 + tiles}
    assert TSec._GRAPHS == graphs
    assert (outs[0][2] > 0.5).any() and (outs[0][2] <= 0.5).any()
    TRP.reset_relight_graph_counts()
    assert set(TRP.RELIGHT_GRAPH.values()) == {0}


def _stage_keys(s, monkeypatch, rays, fast_vis=True, vis_tile=None):
    """{stage counter prefix: ``tile_graph_key`` of the arguments the chunk
    hands ``graph_runner``} of one chunk call on the CPU."""
    keys = {}

    def recording(fn, cfg, params, scene, tables, knobs, first, counts,
                  prefix=""):
        keys[prefix] = TSec.tile_graph_key(fn, cfg, params, scene, tables,
                                           knobs, first)
        return _eager_runner(fn, cfg, params, scene, tables, knobs, first,
                             counts, prefix)

    monkeypatch.setattr(TSec, "graph_runner", recording)
    fn = _fns(s, "cpu", fast_vis, vis_tile)[LIGHTS[0]]
    _call(s, fn, rays, fast_vis, torch.Generator().manual_seed(3))
    return keys


@pytest.mark.parametrize("change,same_knobs,same_tensors", [
    ("in_place", True, True),
    ("replaced", True, False),
    ("new_shape", False, True)])
@pytest.mark.parametrize("stage", ["gbuffer_", "vis_"])
def test_graph_key(cpu_side, monkeypatch, stage, change, same_knobs,
                   same_tensors):
    """Each stage's key, as the chunk builds it: it holds through an
    in-place update of the parameters; a replaced parameter changes its
    tensor part (the graph is recaptured), a new input shape (more rays,
    or another tile) its knob set. The two stages never share a knob
    set."""
    s = dict(cpu_side)
    rays = _rays("cpu")
    keys0 = _stage_keys(s, monkeypatch, rays)
    assert set(keys0) == {"gbuffer_", "vis_"}
    assert keys0["gbuffer_"][0] != keys0["vis_"][0]
    vis_tile = None
    params = s["params"]
    if change == "in_place":
        with torch.no_grad():
            for _, p in TSec._tensors(params):
                p.add_(0.01)
    elif change == "replaced":
        s["params"] = dict(params, density_line_1=params["density_line_1"]
                           .clone())
    elif stage == "gbuffer_":
        rays = torch.cat([rays, rays[:1]])
    else:
        vis_tile = SIZES["cpu"]["tile"] // 2
    try:
        keys1 = _stage_keys(s, monkeypatch, rays, vis_tile=vis_tile)
    finally:
        if change == "in_place":
            with torch.no_grad():
                for _, p in TSec._tensors(params):
                    p.sub_(0.01)
    assert (keys1[stage][0] == keys0[stage][0]) == same_knobs
    assert (keys1[stage][1] == keys0[stage][1]) == same_tensors


# ---------------------------------------------------------------- the card

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return _setup("cuda")


@pytest.fixture
def eager(monkeypatch):
    """A switch to the eager stages on the card: ``with eager(): ...``."""
    @contextlib.contextmanager
    def switch():
        with monkeypatch.context() as m:
            m.setattr(TSec, "graph_runner", _eager_runner)
            yield
    return switch


def _fresh():
    TSec._GRAPHS.clear()
    TRP.reset_relight_graph_counts()
    TSec.reset_march_counts()


@pytest.mark.cuda
@pytest.mark.parametrize("fast_vis", ROUTES, ids=["exact", "fast"])
def test_five_lights_two_chunks_equal_the_eager_chunk(card, eager,
                                                      fast_vis):
    """Two chunks in turn, each under the five lights in turn, one light
    generator: every output equals the eager chunk's bit for bit, one
    capture per stage, a replay for every later call, and the first call's
    outputs are unchanged by the nine calls after it."""
    _need("cuda")
    s = card
    fns = _fns(s, "cuda", fast_vis)
    chunks = [_rays("cuda", 0), _rays("cuda", 1)]
    _fresh()
    key = torch.Generator(device="cuda").manual_seed(5)
    got = [_call(s, fns[name], r, fast_vis, key)
           for r in chunks for name in LIGHTS]
    first = [o.clone() for o in got[0]]
    torch.cuda.synchronize()
    tiles = TSec.MARCHED["tiles"]
    assert tiles > 10
    assert TRP.RELIGHT_GRAPH == {
        "gbuffer_captures": 1, "gbuffer_replays": 9, "vis_captures": 1,
        "vis_replays": tiles - 1, "eager": 0}
    with eager():
        key = torch.Generator(device="cuda").manual_seed(5)
        want = [_call(s, fns[name], r, fast_vis, key)
                for r in chunks for name in LIGHTS]
    for g, w in zip(got, want):
        _assert_equal(g, w)
    _assert_equal(got[0], first)
    acc = want[0][2]
    assert (acc > 0.5).any() and (acc <= 0.5).any()
    TSec._GRAPHS.clear()


def _kept(s, fn, rays, fast_vis, draws):
    """The kept pairs of one eager call: the ``VIS_PACK`` count."""
    TRP.reset_vis_pack_counts()
    _call(s, fn, rays, fast_vis, draws=draws)
    return TRP.VIS_PACK["kept"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["kept_0", "kept_is_tile",
                                  "kept_is_tile_plus_one"])
@pytest.mark.parametrize("fast_vis", ROUTES, ids=["exact", "fast"])
def test_kept_counts_at_the_tile_edges(card, eager, fast_vis, case):
    """A chunk that keeps no pair replays no tile; one that keeps exactly
    one tile replays one, one tile plus one two; the outputs equal the
    eager chunk's bit for bit, twice in turn."""
    _need("cuda")
    s = card
    z = SIZES["cuda"]
    g = torch.Generator().manual_seed(9)
    draws = torch.rand((z["rays"], z["light_samples"]), generator=g).cuda()
    rays = _rays("cuda", 2, away=case == "kept_0")
    vis_tile = z["tile"]
    if case != "kept_0":
        with eager():
            kept = _kept(s, _fns(s, "cuda", fast_vis)[LIGHTS[0]], rays,
                         fast_vis, draws)
        vis_tile = kept if case == "kept_is_tile" else kept - 1
    fn = _fns(s, "cuda", fast_vis, vis_tile)[LIGHTS[0]]
    with eager():
        want = _call(s, fn, rays, fast_vis, draws=draws)
    _fresh()
    got = [_call(s, fn, rays, fast_vis, draws=draws) for _ in range(2)]
    for o in got:
        _assert_equal(o, want)
    n_tiles = {"kept_0": 0, "kept_is_tile": 1,
               "kept_is_tile_plus_one": 2}[case]
    assert TSec.MARCHED["tiles"] == 2 * n_tiles
    assert TRP.RELIGHT_GRAPH == {
        "gbuffer_captures": 1, "gbuffer_replays": 1,
        "vis_captures": int(n_tiles > 0),
        "vis_replays": max(2 * n_tiles - 1, 0), "eager": 0}
    if case == "kept_0":
        assert (want[2] <= 0.5).all()
    TSec._GRAPHS.clear()


@pytest.mark.cuda
@pytest.mark.parametrize("fast_vis", ROUTES, ids=["exact", "fast"])
def test_same_k1_calls_launches_and_spans(card, eager, monkeypatch,
                                          fast_vis):
    """A replayed call makes the eager call's K1 calls from Python, in
    order, on indices of the same sizes, counts its launches, and under
    ``torch.profiler`` charges the ``primary`` and ``visibility`` spans
    the device time the eager call charges them (the harness's own
    attribution, the backward of the derived normals included; within
    5 %: the copies into the graphs)."""
    from torch.profiler import ProfilerActivity, profile

    from portbench.harness.spans import reduce_spans
    _need("cuda")
    s = card
    fn = _fns(s, "cuda", fast_vis)[LIGHTS[0]]
    rays = _rays("cuda", 3)
    g = torch.Generator().manual_seed(4)
    draws = torch.rand((rays.shape[0], SIZES["cuda"]["light_samples"]),
                       generator=g).cuda()
    _fresh()
    _call(s, fn, rays, fast_vis, draws=draws)     # the captures
    gather = rows.row_gather
    got = {}
    for name in ("graph", "eager"):
        calls = []

        def counted(table, idx):
            calls.append(idx.numel())
            return gather(table, idx)

        monkeypatch.setattr(rows, "row_gather", counted)
        monkeypatch.setattr(TF, "row_gather", counted)
        reset_launch_counts()
        TRP.reset_relight_graph_counts()
        ctx = eager() if name == "eager" else contextlib.nullcontext()
        with ctx:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                _call(s, fn, rays, fast_vis, draws=draws)
                torch.cuda.synchronize()
        spans = reduce_spans(prof.events())["span_ms"]
        got[name] = dict(
            calls=calls, launches=dict(LAUNCHES),
            counts=dict(TRP.RELIGHT_GRAPH),
            ms={k: spans[k]["forward"] + spans[k]["backward"]
                for k in ("primary", "visibility")})
    graph, eager_ = got["graph"], got["eager"]
    assert graph["counts"]["eager"] == 0
    assert graph["counts"]["gbuffer_replays"] == 1
    assert graph["counts"]["vis_replays"] >= 1
    assert eager_["counts"]["eager"] == 1 + graph["counts"]["vis_replays"]
    assert graph["calls"] == eager_["calls"] and eager_["calls"]
    assert graph["launches"] == eager_["launches"]
    for k in ("primary", "visibility"):
        assert eager_["ms"][k] > 0
        assert abs(graph["ms"][k] / eager_["ms"][k] - 1.0) < 0.05, (
            k, graph["ms"], eager_["ms"])
    TSec._GRAPHS.clear()
