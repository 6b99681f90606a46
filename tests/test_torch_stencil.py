"""The port's stencil operator against the JAX package's.

Both packages build the same generator specs; inputs come from
`numpy.random.default_rng` and reach each package as numpy arrays.  The
hand-written CUDA kernel cannot run here; its plain PyTorch version is
held against the JAX package's plain path (float64) and against the
Pallas kernel it replaces, run in interpret mode (float32).
"""
import numpy as np
import pytest
import torch

from basic_iterative_solvers_tpu import stencil_op as jso
from basic_iterative_solvers_tpu.ops import pallas_env

from basic_iterative_solvers_tpu_torch import stencil_op as tso

#: the port's entry points run on the card unless asked; these tests
#: run on the CPU
CPU = "cpu"

SPECS = ["hpcg:8x6x4", "hpcg:16x16x16", "fdm:16",
         "anderson:Lx=4,Ly=5,Lz=3,t=1.2,ranpot=4.0,seed=6"]
DOTS = [(), ("x",), ("self",), ("aux",)]


@pytest.fixture
def interpret():
    pallas_env.INTERPRET = True
    try:
        yield
    finally:
        pallas_env.INTERPRET = False


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n), rng.standard_normal(n)


@pytest.mark.parametrize("spec", SPECS)
def test_builders_match_jax(spec):
    for np_dt, t_dt in ((np.float64, torch.float64),
                        (np.float32, torch.float32)):
        Aj = jso.from_source_operator(spec, dtype=np_dt)
        At = tso.from_source_operator(spec, t_dt, device=CPU)
        assert At.legs == Aj.legs
        assert At.dims == Aj.dims
        assert (At.n_rows, At.n_cols) == (Aj.n_rows, Aj.n_cols)
        # coefficients and diagonal stored in the same dtype: bitwise equal
        np.testing.assert_array_equal(At.coeffs.numpy(), np.asarray(Aj.coeffs))
        if np_dt == np.float64:
            assert At.coeff_values == Aj.coeff_values
        assert (At.diag is None) == (Aj.diag is None)
        if Aj.diag is not None:
            np.testing.assert_array_equal(
                At.diag.numpy(), np.asarray(Aj.diag)[:Aj.n_rows])


@pytest.mark.parametrize("dots", DOTS, ids=lambda d: "+".join(d) or "none")
@pytest.mark.parametrize("spec", SPECS)
def test_plain_spmv_f64_matches_jax(spec, dots):
    """Same leg order in both, so only summation rounding differs: rtol
    1e-12 (and 1e-12·max|y| absolute for entries that cancel to ~0)."""
    Aj = jso.from_source_operator(spec, dtype=np.float64)
    At = tso.from_source_operator(spec, torch.float64, device=CPU)
    x, aux = _inputs(At.n_rows, 1)
    yj = np.asarray(jso.stencil_spmv_xla(Aj, np.asarray(x)))
    out = tso.stencil_spmv_plain(At, torch.from_numpy(x), dots,
                                 torch.from_numpy(aux))
    out = out if dots else (out,)
    y = out[0].numpy()
    np.testing.assert_allclose(y, yj, rtol=1e-12,
                               atol=1e-12 * np.abs(yj).max())
    partner = {"x": x, "self": yj, "aux": aux}
    for kind, d in zip(dots, out[1:]):
        np.testing.assert_allclose(float(d), np.dot(yj, partner[kind]),
                                   rtol=1e-12)


@pytest.mark.parametrize("dots", DOTS, ids=lambda d: "+".join(d) or "none")
@pytest.mark.parametrize("spec", SPECS)
def test_plain_spmv_f32_matches_pallas_kernel(interpret, spec, dots):
    """The TPU kernel (interpret mode) groups equal-coefficient legs, the
    plain version does not, and the two reduce in different orders: y to
    rtol 2e-6 / atol 1e-5, the dots to rtol 1e-5."""
    Ap = jso.to_planar_matrix(jso.from_source_operator(spec,
                                                       dtype=np.float32))
    At = tso.from_source_operator(spec, torch.float32, device=CPU)
    x, aux = (v.astype(np.float32) for v in _inputs(At.n_rows, 2))
    outs = jso.stencil_spmv_resident(Ap, jso.to_planar_vec(Ap, x), dots=dots,
                                     aux=jso.to_planar_vec(Ap, aux))
    outs = outs if dots else (outs,)
    yk = np.asarray(jso.from_planar_vec(Ap, outs[0]))
    out = tso.stencil_spmv_plain(At, torch.from_numpy(x), dots,
                                 torch.from_numpy(aux))
    out = out if dots else (out,)
    np.testing.assert_allclose(out[0].numpy(), yk, rtol=2e-6, atol=1e-5)
    for d, dk in zip(out[1:], outs[1:]):
        np.testing.assert_allclose(float(d), float(dk), rtol=1e-5)



# ---------------------------------------------------------------------------
# The box routes of #1 and #2 (csrc/stencil_spmv.cu): the route rule, the
# box masks of the launch table, the tile and z-run planner, and the
# kernels' arithmetic run block by block in NumPy against the leg loop's
# ---------------------------------------------------------------------------

ANDERSON = "anderson:Lx=9,Ly=7,Lz=6,t=1.0,ranpot=4.0,seed=1"


def _galerkin_level(spec="hpcg:32x24x16", dtype=torch.float64):
    """The first coarse level of a multigrid hierarchy (27 Galerkin legs
    on HPCG 16x12x8, four coefficient groups)."""
    import basic_iterative_solvers_tpu_torch as bt
    from basic_iterative_solvers_tpu_torch import mg
    A = tso.from_source_operator(spec, dtype, device=CPU)
    levels = mg.build_mg_hierarchy(A, bt.SolverConfig(
        preconditioner=bt.PrecondType.MULTIGRID, dtype=dtype))
    return levels[1].A


def _operator(case, dtype=torch.float64):
    if case == "galerkin":
        return _galerkin_level(dtype=dtype)
    if case in ("dx2", "dy2", "dz2"):
        d = {"dx2": (2, 0, 0), "dy2": (0, 2, 0), "dz2": (0, 0, 2)}[case]
        return tso.make_stencil([((0, 0, 0), 4.0), (d, -1.0),
                                 (tuple(-v for v in d), -1.0)], 8, 7, 6,
                                dtype=dtype, device=CPU)
    return tso.from_source_operator(case, dtype, device=CPU)


#: (operator, #1's route, #2's route) for float32 vectors
_ROUTE_CASES = {
    "hpcg:16x12x10": ("box", "box"),
    "hpcg:37x21x5": ("box", "legs"),       # 37 x values: no 16-byte lines
    "fdm:40": ("box", "box"),              # 2-D, nz = 1
    "galerkin": ("box", "box"),            # 27 legs, several groups
    ANDERSON: ("box", "legs"),             # nx = 9
    "anderson:Lx=8,Ly=7,Lz=6,t=1.0,ranpot=4.0,seed=1": ("box", "box"),
    "dx2": ("legs", "legs"),
    "dy2": ("legs", "legs"),               # within #2's reach, not the box
    "dz2": ("legs", "legs"),
}


@pytest.mark.parametrize("case", sorted(_ROUTE_CASES))
def test_box_route_rule(case):
    """route_for: "box" for legs within the 3x3x3 box (for #2 also x in
    whole 16-byte vectors of a line), "legs" for anything else; an
    Anderson operator with a bfloat16 diagonal routes as its float32
    form; STREAM picks the kernel whose route is asked by default."""
    A = _operator(case)
    want1, want2 = _ROUTE_CASES[case]
    for dt in (torch.float32,) + ((torch.bfloat16,) * (A.diag is not None)):
        Ad = tso.stencil_astype(A, dt)
        x = torch.zeros(A.n_rows, dtype=torch.float32)
        assert tso.in_box(Ad) == (want1 == "box")
        assert tso.route_for(Ad, x, stream=False) == want1
        assert tso.route_for(Ad, x, stream=True) == want2
    x64 = torch.zeros(A.n_rows, dtype=torch.float64)
    # float64 lines need an even nx
    assert tso.route_for(A, x64, stream=True) == (
        "box" if want1 == "box" and A.dims[0] % 2 == 0 else "legs")
    # a vector that does not start on 16 bytes takes the scalar form (#1)
    # or the leg loop (#2)
    off = torch.zeros(A.n_rows + 1, dtype=torch.float32)[1:]
    assert tso.box_vec(A, off) == 1
    assert tso.route_for(A, off, stream=True) == "legs"


@pytest.mark.parametrize("case", ["hpcg:16x12x10", "fdm:40", "galerkin",
                                  ANDERSON])
def test_box_masks_follow_the_launch_table(case):
    """Each group's box mask holds exactly its legs, and its set bits in
    ascending order are the group's legs in launch-table order (z, y, x):
    the order of the box route's sums is the leg loop's.  A 2-D operator
    reaches the box route with y as z (`box_form`): the same flat offsets
    and order."""
    A = _operator(case)
    legs, dims = tso.box_form(A)
    use_diag = A.diag is not None
    args, _ = tso._launch_table(legs, A.coeff_values, dims, use_diag, ())
    for g in range(args.n_groups):
        table = [(args.dx[l], args.dy[l], args.dz[l])
                 for l in range(args.group_begin[g], args.group_begin[g + 1])]
        bits = [b for b in range(27) if args.box_mask[g] >> b & 1]
        assert bits == [tso._box_bit(leg) for leg in table]
        assert bits == sorted(bits)
    assert not any(args.box_mask[args.n_groups:])
    if A.dims[2] == 1:
        nx, ny, _ = A.dims
        assert dims == (nx, 1, ny)
        assert sorted(dx + nx * dz for (dx, _, dz) in legs) == sorted(
            dx + nx * dy for (dx, dy, _) in A.legs)
    else:
        assert (legs, dims) == (A.legs, A.dims)


@pytest.mark.parametrize("resident", [2, 3])
@pytest.mark.parametrize("dims", [(128, 128, 128), (384, 384, 384),
                                  (65, 33, 17), (3, 3, 3), (2048, 2048, 1)])
def test_box_planner_covers_every_row_once(dims, resident):
    """The box grid (tiles of BOX_THREADS chunks over a plane, runs of zr
    planes over z) covers every row exactly once, with no empty block, at
    each vector width the dims allow; 2-D dims as `box_form` gives them.
    zr minimises waves of resident blocks (two or three an SM of 132)
    times zr + 2, the shortest run on a tie."""
    nx, ny, nz = dims
    if nz == 1:
        dims = (nx, 1, ny)
        nx, ny, nz = dims
    wave = resident * 132
    for vec in (1, 2, 4):
        if nx % vec:
            continue
        gx, gy, zr = tso._box_grid(dims, vec, 132, resident)
        chunks = nx * ny // vec
        starts = np.arange(gx) * tso.BOX_THREADS
        ends = np.minimum(starts + tso.BOX_THREADS, chunks)
        assert (ends > starts).all() and ends[-1] == chunks
        assert (starts[1:] == ends[:-1]).all()
        z0 = np.arange(gy) * zr
        z1 = np.minimum(z0 + zr, nz)
        assert (z1 > z0).all() and z1[-1] == nz and (z0[1:] == z1[:-1]).all()
        assert int((ends - starts).sum()) * vec * int((z1 - z0).sum()) == (
            nx * ny * nz)
        cost = [-(-(gx * -(-nz // r)) // wave) * (r + 2)
                for r in range(1, nz + 1)]
        assert cost[zr - 1] == min(cost) and cost.index(min(cost)) == zr - 1


def _window(x3, nx, ny, nz):
    """x on the grid with a zero border (the box route's zeros)."""
    w = np.zeros((nz + 2, ny + 2, nx + 2), x3.dtype)
    w[1:-1, 1:-1, 1:-1] = x3
    return w


def emulate_legs(A, x, diag):
    """The leg loop's arithmetic (#1's first port) in NumPy at x's dtype:
    in-bounds legs only, each group's legs in table order, rounded per
    operation."""
    use_diag = diag is not None
    args, _ = tso._launch_table(A.legs, A.coeff_values, A.dims, use_diag, ())
    nx, ny, nz = A.dims
    dtype = x.dtype.type
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
    if use_diag:
        acc = acc + diag * x
    return acc


def _lanes(v, up):
    """__shfl_up_sync / __shfl_down_sync(v, 1) over the warps of a block
    (a lane with no source keeps its own value)."""
    w = v.reshape(-1, 32).copy()
    if up:
        w[:, 1:] = v.reshape(-1, 32)[:, :-1]
    else:
        w[:, :-1] = v.reshape(-1, 32)[:, 1:]
    return w.reshape(-1)


def emulate_box(A, x, diag, staged=False, vec=None, sms=132):
    """The box route's kernel (#1, or #2 with `staged`) block by block in
    NumPy at x's dtype, its threads as array lanes: the chunk of each
    thread, its window of three planes loaded three lines at a time (x
    neighbours by the lane shuffles, direct loads at a warp's edge, zeros
    outside the grid), the march with its rotating windows, the sums over
    each group's mask bits.  With `staged`, every line is read from the
    block's slab [lo, hi) of the plane (an index outside it fails).
    The grid is the one `_box_grid` plans for a card of `sms`
    multiprocessors.  Returns y (rows no block wrote stay NaN)."""
    legs, dims = tso.box_form(A)
    args, _ = tso._launch_table(legs, A.coeff_values, dims, diag is not None,
                                ())
    nx, ny, nz = dims
    dtype = x.dtype.type
    if vec is None:
        vec = 16 // x.itemsize if nx % (16 // x.itemsize) == 0 else 1
    gx, gy, zr = tso._box_grid(dims, vec, sms)
    plane, cpl, nt = nx * ny, nx // vec, tso.BOX_THREADS
    y = np.full(x.size, np.nan, x.dtype)
    lane = np.arange(nt) % 32
    for bx in range(gx):
        c = bx * nt + np.arange(nt)
        live = c < plane // vec
        gyy = np.where(live, c // cpl, 0)
        x0 = np.where(live, (c - gyy * cpl) * vec, 0)
        e0 = np.where(live, c * vec, 0)
        has_l, has_r = live & (x0 > 0), live & (x0 + vec < nx)
        rows_ok = (live & (gyy > 0), live, live & (gyy + 1 < ny))
        lo, hi = (tso._box_slab(dims, vec, bx) if staged else (0, plane))
        assert hi - lo <= (tso._box_slot(dims, vec) if staged else plane)

        def load(q):
            P = np.zeros((nt, 3, vec + 2), x.dtype)
            if not 0 <= q < nz:
                return P
            src = x[q * plane + lo:q * plane + hi]

            def at(e, ok):
                assert ((e[ok] - lo >= 0) & (e[ok] - lo < hi - lo)).all()
                out = np.zeros(nt, x.dtype)
                out[ok] = src[e[ok] - lo]
                return out
            for dy in range(3):
                e = e0 + (dy - 1) * nx
                ok = rows_ok[dy]
                v = np.stack([at(e + r, ok) for r in range(vec)], axis=1)
                left = _lanes(v[:, vec - 1], up=True)
                right = _lanes(v[:, 0], up=False)
                left = np.where(lane == 0, at(e - 1, ok & has_l & (lane == 0)),
                                left)
                right = np.where(lane == 31,
                                 at(e + vec, ok & has_r & (lane == 31)), right)
                P[:, dy, 0] = np.where(has_l, left, 0)
                P[:, dy, 1:vec + 1] = v
                P[:, dy, vec + 1] = np.where(has_r, right, 0)
            return P

        def out(z, planes):
            acc = np.zeros((nt, vec), x.dtype)
            for g in range(args.n_groups):
                m = args.box_mask[g]
                s = np.zeros((nt, vec), x.dtype)
                for b in range(27):
                    if m >> b & 1:
                        dz, dy, dx = b // 9, b // 3 % 3, b % 3
                        s = s + planes[dz][:, dy, dx:dx + vec]
                acc = acc + dtype(args.group_coeff[g]) * s
            i = z * plane + e0[live][:, None] + np.arange(vec)
            if diag is not None:
                acc[live] = acc[live] + diag[i] * planes[1][live, 1, 1:vec + 1]
            assert np.isnan(y[i]).all()       # each row written once
            y[i] = acc[live]

        for by in range(gy):
            z0, z1 = by * zr, min(by * zr + zr, nz)
            win = [load(z0 - 1), load(z0)]
            for z in range(z0, z1):
                win.append(load(z + 1))
                out(z, win)
                win.pop(0)
    return y


@pytest.mark.parametrize("sms", [132, 1])
@pytest.mark.parametrize("np_dt", [np.float32, np.float64])
@pytest.mark.parametrize("case", ["hpcg:16x12x10", "hpcg:37x21x5",
                                  "hpcg:8x40x9", "fdm:40", "galerkin",
                                  "anderson:Lx=8,Ly=7,Lz=6,t=1.0,ranpot=4.0,"
                                  "seed=1"])
def test_box_route_equals_the_leg_loop(case, np_dt, sms):
    """#1's box route, emulated thread by thread, gives the leg loop's y
    bit for bit (a leg outside the grid adds a staged zero), at the
    vector width of the dtype and at width 1, on the grid of an H100
    (short z runs at these sizes) and of a card of one SM (long runs: the
    march's rotating windows turn)."""
    A = _operator(case)
    rng = np.random.default_rng(5)
    x = rng.standard_normal(A.n_rows).astype(np_dt)
    diag = None if A.diag is None else A.diag.numpy().astype(np_dt)
    ref = emulate_legs(A, x, diag)
    for vec in sorted({1, 16 // np.dtype(np_dt).itemsize}):
        if A.dims[0] % vec == 0:
            np.testing.assert_array_equal(
                emulate_box(A, x, diag, vec=vec, sms=sms), ref)
    plain = tso.stencil_spmv_plain(A, torch.from_numpy(x.astype(np.float64)))
    np.testing.assert_allclose(ref, plain.numpy(), rtol=1e-5 if np_dt ==
                               np.float32 else 1e-12, atol=1e-5)


def test_stencil_args_mirror_the_kernel_struct():
    """StencilArgs (the ctypes mirror in _build.py) lists the fields of
    BisStencilArgs in csrc/stencil_spmv.cu in order, with the same types
    and array lengths (box_mask beside the legs), so every kernel reads
    what the wrapper wrote; the library checks the size again when it
    loads."""
    import ctypes
    import pathlib
    import re
    from basic_iterative_solvers_tpu_torch import _build
    src = (pathlib.Path(_build.__file__).parent / "csrc" /
           "stencil_spmv.cu").read_text()
    body = re.search(r"struct BisStencilArgs \{(.*?)\};", src, re.S).group(1)
    size = {"BIS_MAX_LEGS": _build.MAX_LEGS, "BIS_MAX_DOTS": _build.MAX_DOTS}
    c_fields = []
    for decl in re.sub(r"//[^\n]*", "", body).split(";"):
        m = re.match(r"\s*(long long|double|int)\s+(.*)", decl, re.S)
        if not m:
            continue
        for f in m.group(2).split(","):
            name, _, n = f.strip().partition("[")
            n = n.rstrip("]").replace(" ", "")
            count = sum(size[t] if t in size else int(t)
                        for t in n.split("+")) if n else 1
            c_fields.append((m.group(1), name, count))
    mirror = _build.StencilArgs._fields_
    assert [f for _t, f, _n in c_fields] == [f for f, _t in mirror]
    nbytes = {"long long": 8, "double": 8, "int": 4}
    for (ctype, _f, count), (_n, ptype) in zip(c_fields, mirror):
        assert ctypes.sizeof(ptype) == nbytes[ctype] * count
    assert "box_mask" in [f for f, _t in mirror]
