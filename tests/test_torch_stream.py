"""Kernel #2, the stencil SpMV with x staged in shared memory
(`stencil_op.stencil_spmv_stream`), and its route.

On the CPU the port's #2 runs its plain version (#1's, `stencil_spmv_plain`),
held here against the JAX package's Pallas ring kernel
(`stencil_spmv_stream`) run in interpret mode, with its row tile shrunk as
the JAX package's own tests shrink it so that the ring turns several
times.  The JAX vectors are decoded from its planar layout by its own
`from_planar_vec` (its row tile is patched) and come across with
`convert.vector_from_numpy`.  The route (`spmv_route`) is a static rule on
the legs and is checked without a card; the kernel's arithmetic (staged
zeros in place of #1's bounds checks) is emulated in NumPy against #1's;
the launches themselves are checked on a card by test_torch_cuda.py.
"""
import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from basic_iterative_solvers_tpu import stencil_op as jso
from basic_iterative_solvers_tpu.ops import pallas_env

import basic_iterative_solvers_tpu_torch as bt
from basic_iterative_solvers_tpu_torch import convert
from basic_iterative_solvers_tpu_torch import stencil_op as tso

CPU = "cpu"
REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture
def interpret():
    pallas_env.INTERPRET = True
    try:
        yield
    finally:
        pallas_env.INTERPRET = False


def _port_op(Aj, dtype=torch.float32):
    diag = (None if Aj.diag is None
            else np.asarray(jso.from_planar_vec(Aj, Aj.diag)))
    return convert.stencil_from_numpy(Aj.legs, Aj.coeff_values, Aj.dims,
                                      diag, dtype=dtype, device=CPU)


def _carried(Aj, yp, At):
    """A planar JAX vector as the port's flat tensor."""
    return convert.vector_from_numpy(np.asarray(jso.from_planar_vec(Aj, yp)),
                                     At)


@pytest.mark.parametrize("dots", [(), ("x",), ("self",), ("aux",),
                                  ("x", "self", "aux")])
def test_stream_matches_jax_ring_kernel(interpret, rng, monkeypatch, dots):
    """hpcg:8x6x62 with the JAX row tile at 64: the ring spans 8 grid
    steps.  y at the JAX test's own tolerance against its oracle (rtol
    2e-6, atol 1e-5: the Pallas kernel groups equal coefficients, the plain
    version sums leg by leg); the dots at rtol 1e-5."""
    monkeypatch.setattr(jso, "_ROW_TILE_2D", 64)
    Aj = jso.to_planar_matrix(jso.from_source_operator("hpcg:8x6x62",
                                                       dtype=np.float32))
    x = rng.standard_normal(Aj.n_rows).astype(np.float32)
    a = rng.standard_normal(Aj.n_rows).astype(np.float32)
    xp, ap = jso.to_planar_vec(Aj, jnp.asarray(x)), jso.to_planar_vec(
        Aj, jnp.asarray(a))
    assert xp.shape[0] // 64 == 8
    out_j = jso.stencil_spmv_stream(Aj, xp, dots=dots, aux=ap)
    out_j = out_j if dots else (out_j,)
    At = _port_op(Aj)
    out_t = tso.stencil_spmv_stream(At, torch.from_numpy(x), dots,
                                    torch.from_numpy(a))
    out_t = out_t if dots else (out_t,)
    y_j = _carried(Aj, out_j[0], At)
    np.testing.assert_allclose(out_t[0].numpy(), y_j.numpy(), rtol=2e-6,
                               atol=1e-5)
    for dj, dt in zip(out_j[1:], out_t[1:]):
        np.testing.assert_allclose(float(dt), float(dj), rtol=1e-5)


def test_stream_diag_matches_jax(interpret, rng, monkeypatch):
    """A 7-leg stencil with a dense diagonal (Anderson's form), 8x6x30."""
    monkeypatch.setattr(jso, "_ROW_TILE_2D", 64)
    nx, ny, nz = 8, 6, 30
    n = nx * ny * nz
    d = rng.standard_normal(n).astype(np.float32)
    legs = [((0, 0, 0), 1.0)] + [
        (off, -1.0) for off in [(1, 0, 0), (-1, 0, 0), (0, 1, 0),
                                (0, -1, 0), (0, 0, 1), (0, 0, -1)]]
    Aj = jso.to_planar_matrix(jso.make_stencil(legs, nx, ny, nz,
                                               diag=jnp.asarray(d)))
    x = rng.standard_normal(n).astype(np.float32)
    xp = jso.to_planar_vec(Aj, jnp.asarray(x))
    y_j, dself_j = jso.stencil_spmv_stream(Aj, xp, dots=("self",))
    At = _port_op(Aj)
    assert At.diag is not None
    y_t, dself_t = tso.stencil_spmv_stream(At, torch.from_numpy(x),
                                           ("self",))
    np.testing.assert_allclose(
        y_t.numpy(), _carried(Aj, y_j, At).numpy(),
        rtol=2e-6, atol=1e-5)
    np.testing.assert_allclose(float(dself_t), float(dself_j), rtol=1e-5)


def test_stream_wide_x_matches_jax(interpret, rng, monkeypatch):
    """hpcg:160x6x14: nx > 128 (two lane tiles in the JAX layout; five
    32-wide tiles of #2), the JAX row tile at 32."""
    monkeypatch.setattr(jso, "_ROW_TILE_2D", 32)
    Aj = jso.to_planar_matrix(jso.from_source_operator("hpcg:160x6x14",
                                                       dtype=np.float32))
    x = rng.standard_normal(Aj.n_rows).astype(np.float32)
    xp = jso.to_planar_vec(Aj, jnp.asarray(x))
    assert xp.shape[1] == 256 and xp.shape[0] // 32 >= 4
    y_j, dx_j = jso.stencil_spmv_stream(Aj, xp, dots=("x",))
    At = _port_op(Aj)
    y_t, dx_t = tso.stencil_spmv_stream(At, torch.from_numpy(x), ("x",))
    np.testing.assert_allclose(
        y_t.numpy(), _carried(Aj, y_j, At).numpy(),
        rtol=2e-6, atol=1e-4)
    np.testing.assert_allclose(float(dx_t), float(dx_j), rtol=1e-5)


_REACH_CASES = {
    "hpcg": ("hpcg:8x6x5", True),
    "fdm": ("fdm:9", True),
    "anderson": ("anderson:Lx=4,Ly=5,Lz=3,t=1.2,ranpot=4.0,seed=6", True),
    "dx2": ([((0, 0, 0), 4.0), ((2, 0, 0), -1.0)], False),
    "dy2": ([((0, 0, 0), 4.0), ((0, 2, 0), -1.0), ((0, -2, 0), -1.0)], True),
    "dy3": ([((0, 0, 0), 4.0), ((0, 3, 0), -1.0)], False),
    "dz2": ([((0, 0, 0), 4.0), ((0, 0, -2), -1.0)], False),
}


@pytest.mark.parametrize("case", sorted(_REACH_CASES))
@pytest.mark.parametrize("stream", [False, True])
def test_route_rule(case, stream, monkeypatch):
    """With STREAM set, #2 inside its reach (|dx| <= 1, |dy| <= 2,
    |dz| <= 1) and #1 outside it; with STREAM unset, #1 everywhere."""
    src, inside = _REACH_CASES[case]
    A = (tso.from_source_operator(src, torch.float64, device=CPU)
         if isinstance(src, str)
         else tso.make_stencil(src, 7, 8, 6, dtype=torch.float64,
                               device=CPU))
    monkeypatch.setattr(tso, "STREAM", stream)
    assert tso.stream_reach(A) == inside
    assert tso.spmv_route(A) == ("stream" if stream and inside
                                 else "resident")


def test_mg_levels_lie_within_reach():
    """Every level of the multigrid hierarchy (HPCG's 27-leg Galerkin
    levels, FDM's 9-leg ones) is within #2's reach."""
    for spec in ("hpcg:32x24x20", "fdm:64"):
        A = tso.from_source_operator(spec, torch.float64, device=CPU)
        M = bt.precond.setup_preconditioner_dia(
            A, bt.SolverConfig(preconditioner=bt.PrecondType.MULTIGRID))
        assert len(M.mg_data) >= 2
        assert all(tso.stream_reach(lev.A) for lev in M.mg_data)


def test_cpu_tensors_take_the_plain_version_with_stream(monkeypatch, rng):
    """STREAM set: a CPU tensor still takes the plain version, launching
    neither kernel, and an operator outside #2's reach is not counted."""
    monkeypatch.setattr(tso, "STREAM", True)
    A = tso.from_source_operator("hpcg:8x6x5", torch.float64, device=CPU)
    x = torch.from_numpy(rng.standard_normal(A.n_rows))
    before = (tso.stencil_spmv.launches, tso.stencil_spmv_stream.launches,
              tso.stencil_spmv_stream.outside_reach)
    y = tso.stencil_spmv(A, x)
    assert torch.equal(y, tso.stencil_spmv_plain(A, x))
    assert torch.equal(tso.stencil_spmv_stream(A, x), y)
    assert (tso.stencil_spmv.launches, tso.stencil_spmv_stream.launches,
            tso.stencil_spmv_stream.outside_reach) == before


def test_tile_constants_match_the_source():
    """STREAM_TILE and STREAM_HALO are the BIS_STREAM_* of the CUDA source
    (the library checks the same at load time on a card)."""
    src = (REPO / "basic_iterative_solvers_tpu_torch" / "csrc"
           / "stencil_spmv.cu").read_text()
    got = {k: int(v) for k, v in
           re.findall(r"#define BIS_STREAM_(TX|TY|HX|HY) (\d+)", src)}
    assert (got["TX"], got["TY"]) == tso.STREAM_TILE
    assert (got["HX"], got["HY"]) == tso.STREAM_HALO[:2]


@pytest.mark.parametrize("dims", [(128, 128, 128), (384, 384, 384),
                                  (2048, 2048, 1), (8, 8, 8), (37, 21, 5),
                                  (160, 6, 14)])
def test_stream_grid_covers_the_operator(dims):
    """The launch grid covers every row: tiles over (x, y), z chunks of zc
    planes, the last chunk not empty; about _STREAM_BLOCKS blocks where
    the grid allows."""
    gx, gy, gz, zc = tso._stream_grid(dims)
    tx, ty = tso.STREAM_TILE
    assert gx * tx >= dims[0] > (gx - 1) * tx
    assert gy * ty >= dims[1] > (gy - 1) * ty
    assert gz * zc >= dims[2] > (gz - 1) * zc
    if dims[2] >= 8:
        assert gx * gy * gz >= min(tso._STREAM_BLOCKS // 2,
                                   gx * gy * dims[2])


def _emulate_stream(args, x, diag, dims, dtype):
    """#2's arithmetic in NumPy at `dtype`: every leg read from x staged
    with zeros outside the grid (no bounds check), each group's legs summed
    in table order, times its coefficient, rounded per operation."""
    nx, ny, nz = dims
    hx, hy, hz = tso.STREAM_HALO
    x3 = np.zeros((nz + 2 * hz, ny + 2 * hy, nx + 2 * hx), dtype)
    x3[hz:hz + nz, hy:hy + ny, hx:hx + nx] = x.reshape(nz, ny, nx)
    acc = np.zeros((nz, ny, nx), dtype)
    for g in range(args.n_groups):
        s = np.zeros((nz, ny, nx), dtype)
        for l in range(args.group_begin[g], args.group_begin[g + 1]):
            dx, dy, dz = args.dx[l], args.dy[l], args.dz[l]
            s = s + x3[hz + dz:hz + dz + nz, hy + dy:hy + dy + ny,
                       hx + dx:hx + dx + nx]
        acc = acc + dtype(args.group_coeff[g]) * s
    if diag is not None:
        acc = acc + diag.reshape(nz, ny, nx) * x.reshape(nz, ny, nx)
    return acc.reshape(-1)


def _emulate_resident(args, x, diag, dims, dtype):
    """#1's arithmetic in NumPy at `dtype`: in-bounds legs only."""
    nx, ny, nz = dims
    gz, gy, gx = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx),
                             indexing="ij")
    gx, gy, gz = gx.ravel(), gy.ravel(), gz.ravel()
    i = np.arange(x.size)
    acc = np.zeros_like(x)
    for g in range(args.n_groups):
        s = np.zeros_like(x)
        for l in range(args.group_begin[g], args.group_begin[g + 1]):
            px, py, pz = gx + args.dx[l], gy + args.dy[l], gz + args.dz[l]
            ok = ((px >= 0) & (px < nx) & (py >= 0) & (py < ny)
                  & (pz >= 0) & (pz < nz))
            s[ok] = s[ok] + x[i[ok] + args.off[l]]
        acc = acc + dtype(args.group_coeff[g]) * s
    if diag is not None:
        acc = acc + diag * x
    return acc


@pytest.mark.parametrize("spec", ["hpcg:37x21x5", "fdm:40", "anderson"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_staged_zeros_equal_bounds_checks(spec, dtype, rng):
    """Reading a staged zero where #1 skips an out-of-grid leg gives #1's
    y bit for bit (s + 0 is s), with the launch table both kernels share."""
    if spec == "anderson":
        spec = _REACH_CASES["anderson"][0]
    A = tso.from_source_operator(spec, torch.float64, device=CPU)
    use_diag = A.diag is not None
    args, _ = tso._launch_table(A.legs, A.coeff_values, A.dims, use_diag, ())
    x = rng.standard_normal(A.n_rows).astype(dtype)
    diag = A.diag.numpy().astype(dtype) if use_diag else None
    y2 = _emulate_stream(args, x, diag, A.dims, dtype)
    y1 = _emulate_resident(args, x, diag, A.dims, dtype)
    np.testing.assert_array_equal(y2, y1)
    ref = tso.stencil_spmv_plain(A, torch.from_numpy(x.astype(np.float64)))
    np.testing.assert_allclose(y2, ref.numpy(), rtol=1e-5 if dtype ==
                               np.float32 else 1e-12, atol=1e-5)


# ---------------------------------------------------------------------------
# #2's box route: the staged slabs, the route rule, the arithmetic
# ---------------------------------------------------------------------------

from tests.test_torch_stencil import (_operator, emulate_box,  # noqa: E402
                                      emulate_legs)


@pytest.mark.parametrize("dims", [(128, 128, 128), (384, 384, 384),
                                  (64, 33, 17), (4, 3, 3), (2048, 1, 2048),
                                  (40, 1, 40)])
@pytest.mark.parametrize("vec", [2, 4])
def test_box_slabs_cover_each_block_within_a_slot(dims, vec):
    """Each block's slab [lo, hi) of a plane (one bulk copy) starts and
    ends on a 16-byte vector, lies in the plane, fits a ring slot, and
    holds every element its chunks read: their own lines, the lines above
    and below, and one value beyond each end."""
    nx, ny, _ = dims
    gx, _gy, _zr = tso._box_grid(dims, vec)
    plane, slot = nx * ny, tso._box_slot(dims, vec)
    assert slot % vec == 0
    for bx in range(gx):
        lo, hi = tso._box_slab(dims, vec, bx)
        assert lo % vec == 0 and hi % vec == 0 and 0 <= lo < hi <= plane
        assert hi - lo <= slot
        cb = bx * tso.BOX_THREADS
        ce = min(cb + tso.BOX_THREADS, plane // vec)
        first = max(0, cb * vec - nx - 1)
        last = min(plane - 1, ce * vec - 1 + nx + 1)
        assert lo <= first and last < hi


@pytest.mark.parametrize("case,route", [("hpcg:16x12x10", "box"),
                                        ("fdm:40", "box"),
                                        ("galerkin", "box"),
                                        ("hpcg:37x21x5", "legs"),
                                        ("dy2", "legs")])
@pytest.mark.parametrize("stream", [False, True])
def test_stream_box_route_rule(case, route, stream, monkeypatch):
    """With STREAM set, route_for names #2's route by default: "box" for
    legs within the box on lines of whole 16-byte vectors, else "legs"
    (|dy| = 2 lies in #2's reach, not in the box); unset, #1's route,
    which is "box" for every operator within the box."""
    A = _operator(case)
    x = torch.zeros(A.n_rows, dtype=torch.float32)
    monkeypatch.setattr(tso, "STREAM", stream)
    assert tso.spmv_route(A) == ("stream" if stream else "resident")
    want = route if stream else ("box" if tso.in_box(A) else "legs")
    assert tso.route_for(A, x) == want


@pytest.mark.parametrize("np_dt", [np.float32, np.float64])
@pytest.mark.parametrize("case", ["hpcg:16x12x10", "hpcg:8x40x9", "fdm:40",
                                  "galerkin",
                                  "anderson:Lx=8,Ly=7,Lz=6,t=1.0,ranpot=4.0,"
                                  "seed=1"])
def test_stream_box_from_staged_slabs_equals_the_leg_loop(case, np_dt):
    """#2's box route, emulated thread by thread with every line read from
    its block's staged slab (a read outside the slab fails), gives the leg
    loop's y bit for bit, with short z runs (an H100's grid) and long ones
    (a card of one SM)."""
    A = _operator(case)
    rng = np.random.default_rng(9)
    x = rng.standard_normal(A.n_rows).astype(np_dt)
    diag = None if A.diag is None else A.diag.numpy().astype(np_dt)
    ref = emulate_legs(A, x, diag)
    vec = 16 // np.dtype(np_dt).itemsize
    for sms in (132, 1):
        np.testing.assert_array_equal(
            emulate_box(A, x, diag, staged=True, vec=vec, sms=sms), ref)


def test_box_constants_match_the_source():
    """BOX_THREADS, BOX_STAGES and BOX_RESIDENT are the BIS_BOX_* of the
    CUDA source (the library checks the same at load time on a card)."""
    src = (REPO / "basic_iterative_solvers_tpu_torch" / "csrc"
           / "stencil_spmv.cu").read_text()
    got = {k: int(v) for k, v in re.findall(
        r"#define BIS_BOX_(THREADS|STAGES|MIN_BLOCKS|STREAM_MIN_BLOCKS) "
        r"(\d+)", src)}
    assert (got["THREADS"], got["STAGES"]) == (tso.BOX_THREADS,
                                               tso.BOX_STAGES)
    assert (got["MIN_BLOCKS"], got["STREAM_MIN_BLOCKS"]) == tso.BOX_RESIDENT


@pytest.mark.parametrize("dims,vec,itemsize,want", [
    ((128, 128, 128), 4, 4, 3), ((384, 384, 384), 4, 4, 3),
    ((128, 128, 128), 2, 8, 2), ((384, 384, 384), 2, 8, 2),
    ((2048, 1, 2048), 4, 4, 3),
    ((3072, 3072, 4), 4, 4, 1), ((4096, 4096, 4), 4, 4, 0)])
def test_stream_box_resident_blocks_fit_shared_memory(dims, vec, itemsize,
                                                      want):
    """#2's box blocks resident on an SM, as the grid planner counts them:
    in float32 three where the ring fits the SM's 227 KB three times, in
    float64 two, fewer where it does not (0: not once, and route_for names
    the leg loop); #1's two."""
    assert tso._box_resident(True, dims, vec, itemsize) == want
    assert tso._box_resident(False, dims, vec, itemsize) == 2
