"""Line lookups with no gradient through two taps (``ops/interp.py``:
``line_taps``, ``line_product``; ``csrc/line_taps.cu``).

On the CPU: the plain version against the two-tap matrix route
(``lerp_line_matmul``) in both tap modes, one line and CP's three, at the
widths and node counts of the port's configs, on coordinates at +-1, on
nodes, between them and beyond [-1, 1], and on a ``vm_stacked`` channel
slice: within one rounding of each tap's scale, and equal where the
matrix's row has one nonzero. The plain version against the JAX package's
line lookups (``lerp_line_matmul`` for the clipped taps, the gathering
``lerp_line`` for CP's), imported inside that test only, so that the card
can run this file without JAX; the card holds the kernel to the plain
version. The routing, read from ``LINE_ROUTE``: taps
where no gradient can flow, the matrix where a line or the coordinates
take one, and in ``derived_normals`` under ``no_grad``. An eval chunk of
each decomposition against the same chunk on the matrix route.

Marked ``cuda``: the kernel against its plain version and the matrix route
at the main path's shapes (the largest gap printed in ulps), empty input,
a secondary pass whose tile graph captures the kernel inside its pieces
against the same tiles run eagerly, launch for launch
(``kernels.LAUNCHES``), and a refused launch raising. Run on
the card: ``python -m pytest tests/test_torch_line_taps.py -m cuda -q -s
--noconftest`` (this file imports only the port).
"""
import numpy as np
import pytest
import torch

from tensoir_tpu_torch.kernels import LAUNCHES, reset_launch_counts
from tensoir_tpu_torch.models import field as TF
from tensoir_tpu_torch.models import lifecycle as LC
from tensoir_tpu_torch.ops import interp
from tensoir_tpu_torch.ops.interp import (LINE_ROUTE, line_matrix_product,
                                          line_product, line_taps,
                                          line_taps_plain,
                                          reset_line_route_counts)
from tensoir_tpu_torch.render import eval as TE
from tensoir_tpu_torch.render import secondary as TSec

EPS = 2.0 ** -23
AABB = ((-1.5, -1.5, -1.5), (1.5, 1.5, 1.5))


def _need_cuda() -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")


def _coords(n: int, d: int, gen: torch.Generator) -> torch.Tensor:
    """[n, 3]: each column +-1, 0, the nodes of a d-node line, points
    between them and beyond [-1, 1], in another order per column."""
    fixed = torch.tensor([-1.0, 1.0, 0.0, -1.3, 1.3, -1.0001, 1.0001])
    nodes = torch.arange(d, dtype=torch.float32) * (2.0 / (d - 1)) - 1.0
    cols = []
    for _ in range(3):
        rest = torch.rand(n, generator=gen) * 2.6 - 1.3
        c = torch.cat([fixed, nodes, rest])[:n]
        cols.append(c[torch.randperm(c.shape[0], generator=gen)])
    return torch.stack(cols, -1).contiguous()


def _tap_scale(lines, coords, axes, extrapolate):
    """prod_a (|w0 l0| + |w1 l1|): the scale of each output before its
    roundings, and whether the matrix's row has one nonzero in every
    line."""
    scale, single = None, None
    for line, axis in zip(lines, axes):
        i0, i1, w0, w1 = interp._taps(line, coords[..., axis], extrapolate)
        s = (w0[..., None] * line[i0]).abs() + (w1[..., None]
                                                 * line[i1]).abs()
        one = (w1 == 0) | (w0 == 0) | (i0 == i1)
        scale = s if scale is None else scale * s
        single = one if single is None else single & one
    return scale, single


def _assert_close_to_matrix(got, lines, coords, axes, extrapolate):
    """Within one rounding of the taps' scale a lookup (k lookups and k - 1
    products: (2k - 1) eps), equal where every row is one tap; returns the
    largest gap in ulps of that scale."""
    want = line_matrix_product(lines, coords, axes, extrapolate)
    scale, single = _tap_scale(lines, coords, axes, extrapolate)
    gap = (got.double() - want.double()).abs()
    ulps = gap / (EPS * scale.double()).clamp_min(1e-300)
    assert float(ulps.max()) <= 2 * len(lines) - 1, float(ulps.max())
    assert torch.equal(got[single], want[single])
    return float(ulps.max())


@pytest.mark.parametrize("extrapolate", [False, True])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("R", [16, 48, 96, 288])
@pytest.mark.parametrize("D", [2, 300, 500])
def test_plain_taps_match_the_matrix(D, R, k, extrapolate):
    gen = torch.Generator().manual_seed(D * 1000 + R + k)
    lines = tuple(torch.randn(D, R, generator=gen) for _ in range(k))
    coords = _coords(640, D, gen)
    axes = (2, 1, 0)[:k]
    got = line_taps_plain(lines, coords, axes, extrapolate)
    assert got.shape == (640, R) and got.dtype == torch.float32
    _assert_close_to_matrix(got, lines, coords, axes, extrapolate)
    # the wrapper takes the plain version for CPU tensors
    assert torch.equal(line_taps(lines, coords, axes, extrapolate), got)


@pytest.mark.parametrize("extrapolate", [False, True])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("D,R", [(300, 48), (500, 288)])
def test_plain_taps_match_jax(D, R, k, extrapolate):
    """The JAX package's lookups of the same lines at the same coordinates:
    VM's two-tap matrix product, CP's gathering ``lerp_line``, multiplied
    left to right. The plain version is within one rounding of each tap's
    scale a lookup (the fma's product and its sum) and JAX's within 1.5
    (two products and their sum), plus one half for each of the k - 1
    products on either side: (3.5 k - 1) ulps of the taps' scale. Beyond
    the last node CP's taps fall on one node, where JAX sums the two
    weights' products (w0 = 1 - w1 < 0) and the plain version the weights
    first, so the scale there is (|w0| + |w1|) |l|, not |w0 + w1| |l|."""
    import jax.numpy as jnp
    from tensoir_tpu.ops import interp as JI
    gen = torch.Generator().manual_seed(D * 10 + k)
    lines = tuple(torch.randn(D, R, generator=gen) for _ in range(k))
    coords = _coords(2048, D, gen)
    axes = (2, 1, 0)[:k]
    got = line_taps_plain(lines, coords, axes, extrapolate)
    want = None
    for line, axis in zip(lines, axes):
        ln, z = jnp.asarray(line.numpy()), jnp.asarray(coords[:, axis].numpy())
        v = JI.lerp_line(ln, z) if extrapolate else JI.lerp_line_matmul(ln, z)
        want = v if want is None else want * v
    want = torch.from_numpy(np.asarray(want))
    scale = None
    for line, axis in zip(lines, axes):
        i0, i1, w0, w1 = interp._taps(line, coords[..., axis], extrapolate)
        if extrapolate:     # JAX's weights, never merged
            w1 = interp._unnormalize(coords[..., axis], D, True) - i0
            w0 = 1.0 - w1
        s = (w0[..., None] * line[i0]).abs() + (w1[..., None]
                                                 * line[i1]).abs()
        scale = s if scale is None else scale * s
    ulps = ((got.double() - want.double()).abs()
            / (EPS * scale.double()).clamp_min(1e-300))
    assert float(ulps.max()) <= 3.5 * k - 1, float(ulps.max())


@pytest.mark.parametrize("part", ["app", "density"])
def test_plain_taps_on_a_stacked_slice(part):
    """A ``vm_stacked`` line is a channel slice of [D, A + Dn]: no copy,
    its row stride the wide table's."""
    gen = torch.Generator().manual_seed(3)
    stack = torch.randn(300, 48 + 16, generator=gen)
    line = stack[:, :48] if part == "app" else stack[:, 48:]
    assert not line.is_contiguous()
    coords = _coords(512, 300, gen)
    got = line_taps((line,), coords, (1,))
    _assert_close_to_matrix(got, (line,), coords, (1,), False)
    assert torch.equal(got, line_taps((line.contiguous(),), coords, (1,)))


def test_wrapper_refuses_what_the_kernel_does_not_take():
    line = torch.randn(8, 4)
    c = torch.zeros(5, 3)
    with pytest.raises(ValueError):
        line_taps((line, line), c, (0, 1))          # two lines
    with pytest.raises(ValueError):
        line_taps((line.double(),), c, (0,))        # not float32
    with pytest.raises(ValueError):
        line_taps((line.t(),), c, (0,))             # column stride 8
    with pytest.raises(ValueError):
        line_taps((torch.randn(1, 4),), c, (0,))    # one node
    with pytest.raises(ValueError):
        line_taps((line,), torch.zeros(5, 2), (0,))  # not [..., 3]
    with pytest.raises(ValueError):
        line_taps((line,), c, (3,))                 # no such axis
    with pytest.raises(ValueError):
        line_taps((line,), c.to("meta"), (0,))      # neither CPU nor CUDA


def test_leading_shape_and_empty_input():
    gen = torch.Generator().manual_seed(5)
    lines = tuple(torch.randn(20, 8, generator=gen) for _ in range(3))
    c = torch.rand(4, 6, 3, generator=gen) * 2 - 1
    got = line_taps(lines, c, (2, 1, 0), True)
    assert got.shape == (4, 6, 8)
    assert torch.equal(got.reshape(24, 8),
                       line_taps(lines, c.reshape(24, 3), (2, 1, 0), True))
    assert line_taps(lines, torch.zeros(0, 3), (2, 1, 0)).shape == (0, 8)


def _routes(fn):
    reset_line_route_counts()
    out = fn()
    return out, dict(LINE_ROUTE)


@pytest.mark.parametrize("k", [1, 3])
def test_routing_follows_the_gradient(k):
    """Taps where no gradient can flow (no_grad, or nothing that takes
    one); the matrix where a line or the coordinates take one, with the
    matrix route's value and gradients."""
    gen = torch.Generator().manual_seed(7)
    lines = [torch.randn(30, 12, generator=gen) for _ in range(k)]
    c = torch.rand(50, 3, generator=gen) * 2 - 1
    axes = (2, 1, 0)[:k]
    ext = k == 3
    want = line_matrix_product(lines, c, axes, ext)
    with torch.no_grad():
        _, n = _routes(lambda: line_product(lines, c, axes, ext))
    assert n == {"taps": k, "matrix": 0}
    _, n = _routes(lambda: line_product(lines, c, axes, ext))
    assert n == {"taps": k, "matrix": 0}
    for which in ("line", "coords"):
        ls = [ln.clone().requires_grad_(which == "line") for ln in lines]
        cc = c.clone().requires_grad_(which == "coords")
        out, n = _routes(lambda: line_product(ls, cc, axes, ext))
        assert n == {"taps": 0, "matrix": k}
        assert torch.equal(out, want)
        g = torch.autograd.grad(out.square().sum(),
                                ls[0] if which == "line" else cc)[0]
        ls2 = [ln.clone().requires_grad_(which == "line") for ln in lines]
        cc2 = c.clone().requires_grad_(which == "coords")
        ref = line_matrix_product(ls2, cc2, axes, ext)
        g2 = torch.autograd.grad(ref.square().sum(),
                                 ls2[0] if which == "line" else cc2)[0]
        assert torch.equal(g, g2)
        with torch.no_grad():
            _, n = _routes(lambda: line_product(ls, cc, axes, ext))
        assert n == {"taps": k, "matrix": 0}


def _blob_field(decomp: str, dev: str = "cpu", grid=(24, 20, 16), **kw):
    """(cfg, params, scene): a small field of ``decomp`` with a solid blob
    in component 0 of its density factors, masked at its grid."""
    cfg = TF.FieldConfig(decomp=decomp, **(kw or dict(
        density_n_comp=(4, 4, 4), app_n_comp=(6, 6, 6), app_dim=8,
        feature_c=16, num_sgs=8, envmap_h=4, envmap_w=8)))
    params, scene = TF.init_field_params(torch.Generator().manual_seed(0),
                                         cfg, grid, AABB, device=dev)
    with torch.no_grad():
        for i in range(3):
            plane, line = TF.density_factors(cfg, params, i)
            z = torch.linspace(-1.0, 1.0, line.shape[0], device=dev)
            line[:, 0] += (4.0 if plane is None else 1.0) * torch.exp(
                -z ** 2 / 0.2)
            if plane is not None:
                yy = torch.linspace(-1.0, 1.0, plane.shape[0], device=dev)
                xx = torch.linspace(-1.0, 1.0, plane.shape[1], device=dev)
                plane[..., 0] += 4.0 * torch.exp(
                    -(yy[:, None] ** 2 + xx[None] ** 2) / 0.2)
    scene, _ = LC.update_alpha_mask(cfg, params, scene, grid)
    return cfg, params, scene


@pytest.mark.parametrize("decomp", ["vm", "vm_stacked", "cp"])
def test_derived_normals_keep_the_matrix_under_no_grad(decomp):
    cfg, params, _ = _blob_field(decomp)
    pts = torch.rand(40, 3, generator=torch.Generator().manual_seed(2)) - 0.5
    with torch.no_grad():
        n, routes = _routes(lambda: TF.derived_normals(cfg, params, pts))
    assert routes["matrix"] > 0 and routes["taps"] == 0
    assert torch.equal(n, TF.derived_normals(cfg, params, pts))
    with torch.no_grad():
        _, routes = _routes(lambda: TF.density_feature(cfg, params, pts))
    assert routes == {"taps": 3, "matrix": 0}


def _eval_rays(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    o = np.zeros((n, 3), np.float32)
    o[:, :2] = rng.uniform(-0.6, 0.6, size=(n, 2))
    o[:, 2] = -4.0
    d = rng.normal(size=(n, 3)).astype(np.float32) * 0.15
    d[:, 2] = 1.0
    return np.concatenate([o, d], -1)


@pytest.mark.parametrize("decomp", ["vm", "vm_stacked", "cp"])
def test_eval_chunk_equals_the_matrix_route(decomp, monkeypatch):
    """One eval chunk, every ray relit under the fixed directions on the
    exact march: the taps route against the same chunk with every line
    lookup on the matrix, each map within test_torch_eval.py's 1e-4."""
    cfg, params, scene = _blob_field(decomp)
    fn, chunk = TE.make_eval_chunk_fn(cfg, n_samples=48, chunk=24,
                                      second_n_sample=16, secondary_tile=384)
    rays, lidx = _eval_rays(24, 12), np.zeros((24,), np.int32)
    got, taps = _routes(lambda: TE.render_image(fn, chunk, params, scene,
                                                rays, lidx))
    monkeypatch.setattr(TF, "line_product", line_matrix_product)
    want, matrix = _routes(lambda: TE.render_image(fn, chunk, params, scene,
                                                   rays, lidx))
    assert taps["taps"] > 0 and matrix["taps"] == 0
    assert taps["matrix"] > 0     # the derived normals keep the matrix
    assert 3 < (want["acc_map"] > 0.5).sum() < 24
    assert set(got) == set(want)
    for k, v in want.items():
        d = np.abs(got[k].astype(np.float64) - v.astype(np.float64)).max()
        assert d <= 1e-4, (k, d)


# -------------------------------------------------------------- on the card

# (name, k, D, R, N, extrapolate): CP's app stage of a secondary tile, VM's
# appearance line of the same, the visibility march's density line
CARD_SHAPES = [("cp_app", 3, 500, 288, 65536, True),
               ("vm_app", 1, 300, 48, 65536, False),
               ("vis_density", 1, 300, 16, 1048576, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("name,k,D,R,N,ext", CARD_SHAPES)
def test_cuda_kernel_matches_plain_and_matrix(name, k, D, R, N, ext):
    _need_cuda()
    gen = torch.Generator().manual_seed(11)
    lines = tuple(torch.randn(D, R, generator=gen) for _ in range(k))
    coords = _coords(N, D, gen)
    axes = (2, 1, 0)[:k]
    reset_launch_counts()
    got = line_taps(tuple(t.cuda() for t in lines), coords.cuda(), axes, ext)
    torch.cuda.synchronize()
    assert LAUNCHES["line_taps"] == 1
    got = got.cpu()
    plain = line_taps_plain(lines, coords, axes, ext)
    gap_plain = (got - plain).abs()
    scale, _ = _tap_scale(lines, coords, axes, ext)
    ulps_plain = float((gap_plain.double() / (EPS * scale.double())
                        .clamp_min(1e-300)).max())
    ulps = _assert_close_to_matrix(got, lines, coords, axes, ext)
    # the matrix route on the card (its GEMM in ascending node order)
    on_card = line_matrix_product(tuple(t.cuda() for t in lines), coords.cuda(),
                              axes, ext).cpu()
    card_ulps = float(((got.double() - on_card.double()).abs()
                       / (EPS * scale.double()).clamp_min(1e-300)).max())
    print(f"{name}: ulps vs plain {ulps_plain}, vs CPU matrix {ulps}, "
          f"vs card matrix {card_ulps}, equal to plain "
          f"{float((gap_plain == 0).double().mean())}")
    assert ulps_plain <= 1.0 and card_ulps <= 2 * k - 1


@pytest.mark.cuda
def test_cuda_stacked_slice_and_misaligned_rows():
    """A ``vm_stacked`` slice (row stride 64, offset 48 floats) and rows
    that cannot be read as float4 (R 6, an odd column offset)."""
    _need_cuda()
    gen = torch.Generator().manual_seed(12)
    stack = torch.randn(300, 64, generator=gen).cuda()
    coords = _coords(4096, 300, gen).cuda()
    for line in (stack[:, 48:], stack[:, :48], stack[:, 1:7], stack[:, 3:51]):
        got = line_taps((line,), coords, (0,))
        want = line_taps_plain((line.cpu(),), coords.cpu(), (0,))
        assert float((got.cpu() - want).abs().max()) <= 1e-6
        _assert_close_to_matrix(got.cpu(), (line.cpu(),), coords.cpu(),
                                (0,), False)


@pytest.mark.cuda
def test_cuda_empty_input_launches_nothing():
    _need_cuda()
    lines = tuple(torch.randn(10, 16, device="cuda") for _ in range(3))
    reset_launch_counts()
    out = line_taps(lines, torch.zeros(0, 3, device="cuda"), (2, 1, 0), True)
    torch.cuda.synchronize()
    assert out.shape == (0, 16) and LAUNCHES["line_taps"] == 0


@pytest.mark.cuda
def test_cuda_refused_launch_raises(monkeypatch):
    """The C entry returns the launch's error (k = 2 is refused, and so is
    a call of 2^32 work items, before it launches), and the wrapper raises
    on any error it returns."""
    _need_cuda()
    from tensoir_tpu_torch.kernels import build
    line = torch.randn(10, 16, device="cuda")
    c = torch.zeros(4, 3, device="cuda")
    out = torch.empty(4, 16, device="cuda")
    fn = build.kernel("line_taps_f32")
    stream = torch.cuda.current_stream().cuda_stream
    ptr = line.data_ptr()
    err = fn(ptr, ptr, ptr, 16, 16, 16, 10, 10, 10, 0, 0, 0, 2, 0,
             c.data_ptr(), out.data_ptr(), 4, 16, stream)
    assert err != 0
    # 2^30 rows of 16 floats: 2^32 float4 stores, over the 32-bit limit
    err = fn(ptr, ptr, ptr, 16, 16, 16, 10, 10, 10, 0, 0, 0, 1, 0,
             c.data_ptr(), out.data_ptr(), 2 ** 30, 16, stream)
    assert err == 1                 # cudaErrorInvalidValue
    monkeypatch.setattr(build, "kernel", lambda symbol: lambda *a: 9)
    with pytest.raises(RuntimeError, match="cudaError 9"):
        line_taps((line,), c, (0,))


@pytest.mark.cuda
def test_cuda_tile_graph_captures_the_kernel(monkeypatch):
    """A secondary pass on a CP field (its app stage three line lookups a
    tile, no gradient): the tiles replayed from the graph, the kernel
    inside its pieces, equal bit for bit to the same tiles run eagerly and
    counted launch for launch: the capture launches nothing, each replay
    counts the launches captured in its pieces."""
    _need_cuda()
    cfg, params, scene = _blob_field("cp", "cuda", grid=(48, 44, 40),
                                     density_n_comp=(16, 16, 16),
                                     app_n_comp=(48, 48, 48))
    g = torch.Generator().manual_seed(1)
    P, L = 128, cfg.envmap_h * cfg.envmap_w
    d = torch.randn(P, 3, generator=g)
    pts = d / d.norm(dim=-1, keepdim=True) * (0.2 + 0.5 * torch.rand(
        P, 1, generator=g))
    dirs = torch.randn(L, 3, generator=g)
    dirs = dirs / dirs.norm(dim=-1, keepdim=True)
    surf2l = dirs[None].expand(P, L, 3).contiguous()
    mask = (surf2l * torch.randn(P, 1, 3, generator=g)).sum(-1) > 1e-6
    args = tuple(x.cuda() for x in (pts, surf2l, torch.zeros(
        P, dtype=torch.int32), mask))
    knobs = TSec.SecondaryKnobs(second_n_sample=96, second_near=0.05,
                                second_far=1.5, secondary_tile=16384)
    n_tiles = -(-P * L // 16384)
    assert n_tiles >= 3
    TSec._GRAPHS.clear()
    TSec.reset_tile_graph_counts()
    reset_launch_counts()
    graphed, routes = _routes(lambda: TSec.secondary_shading_tiled(
        cfg, params, scene, *args, knobs))
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    assert TSec.TILE_GRAPH["captures"] == 1
    assert TSec.TILE_GRAPH["replays"] == n_tiles - 1
    assert routes["taps"] > 0 and routes["matrix"] == 0
    monkeypatch.setattr(TSec, "_tile_runner",
                        lambda cfg, params, scene, tables, knobs, first:
                        lambda *xs: TSec._tile(cfg, params, scene, *xs,
                                               tables, knobs))
    reset_launch_counts()
    eager, _ = _routes(lambda: TSec.secondary_shading_tiled(
        cfg, params, scene, *args, knobs))
    torch.cuda.synchronize()
    assert dict(LAUNCHES) == launches
    assert launches["line_taps"] > 0 and launches["line_taps"] % n_tiles == 0
    for a, b in zip(graphed, eager):
        assert torch.equal(a, b)
    TSec._GRAPHS.clear()
