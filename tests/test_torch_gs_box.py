"""Kernel #3's "box" route (csrc/stencil_spmv.cu:
stencil_gs_color_step_box_kernel, single-device and shard form) emulated
thread by thread in NumPy from its launch table and grid, held bit for
bit against the leg loop's step (`emulate_legs` with the step's
epilogue), and the route pickers' rules.

The kernel cannot run here.  Each thread of a block is an array lane: its
chunk of VEC rows, its window of three planes (lines read only inside the
grid and the x window, x neighbours by the lane shuffles), the march over
its run of planes, the colour of its rows worked out once a chunk and
plane, x' = x + (rhs - A x)·dinv on them, each operation rounded in the
working dtype.
"""
import numpy as np
import pytest
import torch

from basic_iterative_solvers_tpu_torch import coloring as tcol
from basic_iterative_solvers_tpu_torch import stencil_op as tso
from tests.test_torch_stencil import _lanes, emulate_legs

CPU = "cpu"


def emulate_gs_box(A, spec, color, xw, rhs, dinv, diag, row0, rows, hneg,
                   sms=132):
    """The box route's launch over rows [row0, row0 + rows) from the
    window xw (global row i at xw[hneg + i - row0]; the single-device
    step: row0 = 0, rows = n, hneg = 0, xw = x), block by block on the
    grid `_gs_box_launch` plans for a card of `sms` multiprocessors.
    Returns x' of the launch's rows (rows no block wrote stay NaN)."""
    legs, dims = tso.box_form(A)
    args, _ = tso._launch_table(legs, A.coeff_values, dims, diag is not None,
                                ())
    kind, p0, p1, p2 = tso._gs_color_params(A, spec, box=True)
    nx, ny, nz = dims
    plane, dtype = nx * ny, xw.dtype.type
    vec = 16 // xw.itemsize
    qa, qb = row0 // plane, -(-(row0 + rows) // plane)
    zr, gx, gy = tso._gs_box_grid(dims, vec, row0, rows, sms)
    wlen, nt, cpl = xw.size, tso.BOX_THREADS, nx // vec
    full = (1 << vec) - 1
    out = np.full(rows, np.nan, xw.dtype)
    lane = np.arange(nt) % 32
    lanes = np.arange(vec)
    for bx in range(gx):
        c = bx * nt + np.arange(nt)
        live = c < plane // vec
        gyy = np.where(live, c // cpl, 0)
        x0 = np.where(live, (c - gyy * cpl) * vec, 0)
        e0 = np.where(live, c * vec, 0)
        has_l, has_r = live & (x0 > 0), live & (x0 + vec < nx)
        rows_ok = (live & (gyy > 0), live, live & (gyy + 1 < ny))
        xm = np.zeros(nt, np.int64)
        if kind == 1:
            for r in range(vec):
                xm |= (((x0 + r) % p0) == color % p0).astype(np.int64) << r

        def load(q, z1):
            P = np.zeros((nt, 3, vec + 2), xw.dtype)
            q_ok = 0 <= q < nz and q <= z1

            def at(e, ok):
                v = np.zeros(nt, xw.dtype)
                v[ok] = xw[e[ok]]
                return v
            for j in range(3):
                ew = hneg - row0 + q * plane + e0 + (j - 1) * nx
                ok = q_ok & rows_ok[j] & (ew >= 0) & (ew + vec <= wlen)
                v = np.stack([at(ew + r, ok) for r in range(vec)], axis=1)
                left = np.where(
                    lane == 0, at(ew - 1, ok & has_l & (ew > 0) & (lane == 0)),
                    _lanes(v[:, vec - 1], up=True))
                right = np.where(
                    lane == 31, at(ew + vec, ok & has_r & (ew + vec < wlen)
                                   & (lane == 31)),
                    _lanes(v[:, 0], up=False))
                P[:, j, 0] = np.where(has_l, left, 0)
                P[:, j, 1:vec + 1] = v
                P[:, j, vec + 1] = np.where(has_r, right, 0)
            return P

        def step(z, planes):
            t = z * plane + e0 - row0
            own = live & (t >= 0) & (t < rows)
            idx = t[own][:, None] + lanes
            assert np.isnan(out[idx]).all()       # each row written once
            if z >= nz:                           # inert: x through
                out[idx] = xw[hneg + idx]
                return
            o = planes[1][own, 1, 1:vec + 1]
            if kind == 0:
                m = np.where((x0 + gyy + z + color) & 1, 0xAA & full,
                             0x55 & full)
            else:
                m = np.where(gyy % p1 + p1 * (z % p2) == color // p0, xm, 0)
            acc = np.zeros((nt, vec), xw.dtype)
            for g in range(args.n_groups):
                s = np.zeros((nt, vec), xw.dtype)
                for b in range(27):
                    if args.box_mask[g] >> b & 1:
                        dz, dy, dx = b // 9, b // 3 % 3, b % 3
                        s = s + planes[dz][:, dy, dx:dx + vec]
                acc = acc + dtype(args.group_coeff[g]) * s
            acc = acc[own]
            if diag is not None:
                acc = acc + diag[idx] * o
            with np.errstate(all="ignore"):
                new = o + (rhs[idx] - acc) * dinv[idx]
            bits = (m[own][:, None] >> lanes) & 1
            out[idx] = np.where(bits == 1, new, o)

        for by in range(gy):
            z0, z1 = qa + by * zr, min(qa + by * zr + zr, qb)
            win = [load(z0 - 1, z1), load(z0, z1)]
            for z in range(z0, z1):
                win.append(load(z + 1, z1))
                step(z, win)
                win.pop(0)
    return out


def legs_step(A, spec, color, x, rhs, dinv, diag):
    """The leg loop's step (the legs route's arithmetic) on the whole
    grid: A x by `emulate_legs`, then x + (rhs - A x)·dinv on the
    colour's rows, each operation rounded in x's dtype."""
    ax = emulate_legs(A, x, diag)
    ids = tcol.color_ids_of(spec, torch.arange(A.n_rows)).numpy()
    with np.errstate(all="ignore"):
        new = x + (rhs - ax) * dinv
    return np.where(ids == color, new, x)


def _five_point(nx, ny, dtype=torch.float64):
    return tso.make_stencil([((0, 0, 0), 4.0), ((-1, 0, 0), -1.0),
                             ((1, 0, 0), -1.0), ((0, -1, 0), -1.0),
                             ((0, 1, 0), -1.0)], nx, ny, 1, dtype=dtype,
                            device=CPU)


def _operator(case, bf16=False):
    if case == "five:40x37":
        return _five_point(40, 37)
    A = tso.from_source_operator(case, torch.float64, device=CPU)
    if bf16:
        A = tso.stencil_astype(A, torch.bfloat16)
    return A


def _specs(A):
    """The operator's own colouring and the other kind (parity or a 2x2x2
    grid): the step's arithmetic holds for either."""
    nx, ny, nz = A.dims
    own = tcol.spec_for_device(A)
    other = (tcol.ColorSpec("parity", 2, (nx, ny, nz))
             if own.kind == "grid" else
             tcol.ColorSpec("grid", 4 * (1 + (nz > 1)),
                            (nx, ny, nz, 2, 2, 1 + (nz > 1))))
    return own, other


def _inputs(A, np_dt, seed):
    rng = np.random.default_rng(seed)
    n = A.n_rows
    x = rng.standard_normal(n).astype(np_dt)
    rhs = rng.standard_normal(n).astype(np_dt)
    dinv = (1.0 / (4.0 + rng.random(n))).astype(np_dt)
    diag = None
    if A.diag is not None:
        diag = A.diag.to(torch.float64).numpy().astype(np_dt)
    return x, rhs, dinv, diag


ANDERSON = "anderson:Lx=8,Ly=7,Lz=6,t=1.0,ranpot=4.0,seed=1"


@pytest.mark.parametrize("sms", [132, 1])
@pytest.mark.parametrize("np_dt", [np.float32, np.float64])
@pytest.mark.parametrize("case", ["hpcg:16x12x10", "fdm:40", ANDERSON,
                                  "bf16:" + ANDERSON])
def test_box_step_equals_the_leg_loop(case, np_dt, sms):
    """The single-device box route, emulated thread by thread, gives the
    leg loop's x' bit for bit on every colour of the operator's own
    colouring and of the other kind (parity, grid), on HPCG, FDM (2-D,
    the march along y) and Anderson (a dense diagonal; in bfloat16,
    widened exactly), on the grid of an H100 and of a card of one SM
    (long runs: the march's windows turn); within TOL of plain."""
    bf16 = case.startswith("bf16:")
    A = _operator(case.removeprefix("bf16:"), bf16)
    x, rhs, dinv, diag = _inputs(A, np_dt, 11)
    for spec in _specs(A):
        for c in range(spec.n_colors):
            ref = legs_step(A, spec, c, x, rhs, dinv, diag)
            got = emulate_gs_box(A, spec, c, x, rhs, dinv, diag, 0,
                                 A.n_rows, 0, sms)
            np.testing.assert_array_equal(got, ref)
            if np_dt == np.float64 and not bf16 and sms == 132:
                plain = tso.stencil_gs_color_step_plain(
                    A, torch.from_numpy(x), torch.from_numpy(rhs),
                    torch.from_numpy(dinv), spec, c)
                np.testing.assert_allclose(got, plain.numpy(), rtol=1e-12,
                                           atol=1e-12)


def _windows(v, R, n_dev, hneg, hpos):
    """Each shard's window of v (padded to n_dev·R): its left neighbour's
    last hneg rows, its own R, its right neighbour's first hpos, zeros at
    the global edges (parallel/sharded._halo_exchange's layout)."""
    vp = np.concatenate([np.zeros(hneg, v.dtype), v,
                         np.zeros(n_dev * R - v.size + hpos, v.dtype)])
    return [vp[k * R:k * R + hneg + R + hpos] for k in range(n_dev)]


SHARDS = [("five:40x37", 2, None), ("five:40x37", 4, None),
          ("fdm:40", 4, None), ("hpcg:16x12x10", 4, None), (ANDERSON, 4, 9),
          ("bf16:" + ANDERSON, 2, 13)]


@pytest.mark.parametrize("np_dt", [np.float32, np.float64])
@pytest.mark.parametrize("case,n_dev,lines", SHARDS)
def test_box_shard_step_equals_the_leg_loop(case, n_dev, lines, np_dt):
    """The shard form on windows: each shard's x' bit-equal to the leg
    loop's rows of the whole grid, its inert padded rows (at or past n)
    x copied through.  Shards as the mesh cuts them (2-D: lines, which
    box_form marches as planes; 2 and 4 shards; rows padded past n; HPCG
    in planes, its 27-point halo rounded up to whole lines), and
    shards of `lines` x-lines that do not start on a plane (Anderson:
    whole-plane halo, a 3-D window cut mid-plane)."""
    bf16 = case.startswith("bf16:")
    A = _operator(case.removeprefix("bf16:"), bf16)
    hneg, hpos = A.window_halo
    nx, n = A.dims[0], A.n_rows
    R = (tso.stencil_shard_rows(A.dims, A.halo, n_dev) if lines is None
         else lines * nx)
    n_dev = max(n_dev, -(-n // R))
    assert R % nx == 0
    if lines is not None:
        assert R % (A.dims[0] * A.dims[1])
    x, rhs, dinv, diag = _inputs(A, np_dt, 12)
    pad = lambda v: np.concatenate([v, np.zeros(n_dev * R - n, v.dtype)])  # noqa: E731
    wins = _windows(x, R, n_dev, hneg, hpos)
    xs = pad(x)
    assert n_dev * R > n or case == "fdm:40"      # inert padded rows
    for spec in _specs(A):
        for c in range(spec.n_colors):
            ref = np.concatenate([legs_step(A, spec, c, x, rhs, dinv, diag),
                                  xs[n:]])
            for k in range(n_dev):
                sl = slice(k * R, (k + 1) * R)
                got = emulate_gs_box(
                    A, spec, c, wins[k], pad(rhs)[sl], pad(dinv)[sl],
                    None if diag is None else pad(diag)[sl], k * R, R, hneg)
                np.testing.assert_array_equal(got, ref[sl])


def test_gs_route_rules():
    """The pickers: "box" for legs within the box under a parity or grid
    colouring, lines of whole 16-byte vectors, aligned operands and (the
    shard form) its line-aligned window, in float32 or on a flat plane;
    "legs" for the mod colouring, legs outside the box, 37-wide lines,
    an operand off 16 bytes and float64 on a 3-D grid."""
    cases = {"hpcg:16x12x10": ("box", "legs"), "fdm:40": "box",
             ANDERSON: ("box", "legs"), "hpcg:37x21x5": "legs",
             "fdm:42": ("legs", "box")}
    for spec_s, want in cases.items():
        A = tso.from_source_operator(spec_s, torch.float32, device=CPU)
        x = torch.zeros(A.n_rows)
        cs = tcol.spec_for_device(A)
        got = tso.gs_route_for(A, x, x, x, cs)
        f64 = tso.gs_route_for(A, x.double(), x.double(), x.double(), cs)
        assert (got, f64) == (want if isinstance(want, tuple)
                              else (want, want)), spec_s
    A = tso.from_source_operator("fdm:40", torch.float32, device=CPU)
    x = torch.zeros(A.n_rows)
    off = torch.zeros(A.n_rows + 1)[1:]
    cs = tcol.spec_for_device(A)
    assert tso.gs_route_for(A, off, x, x, cs) == "legs"
    assert tso.gs_route_for(A, x, x, off, cs) == "legs"
    assert tso.gs_route_for(A, x, x, x, tcol.ColorSpec("mod", 3, (3,))) == \
        "legs"
    B = tso.make_stencil([((0, 0, 0), 4.0), ((2, 0, 0), -1.0),
                          ((-2, 0, 0), -1.0)], 8, 7, 6, device=CPU)
    xb = torch.zeros(B.n_rows)
    assert tso.gs_route_for(B, xb, xb, xb, tcol.spec_for_device(B)) == "legs"
    # the shard form on its window (the halo rounded up to whole lines)
    for spec_s, dt, want in (("fdm:40", torch.float32, "box"),
                             ("fdm:40", torch.float64, "box"),
                             ("hpcg:16x12x10", torch.float32, "box"),
                             ("hpcg:16x12x10", torch.float64, "legs"),
                             (ANDERSON, torch.float32, "box"),
                             (ANDERSON, torch.float64, "legs")):
        A = tso.from_source_operator(spec_s, dt, device=CPU)
        R = A.dims[0] * A.dims[1]
        xw = torch.zeros(sum(A.window_halo) + R, dtype=dt)
        v = torch.zeros(R, dtype=dt)
        d = None if A.diag is None else A.diag[:R].contiguous()
        assert tso.gs_halo_route_for(A, xw, v, v, tcol.spec_for_device(A),
                                     d, v) == want, (spec_s, dt)


@pytest.mark.parametrize("dims,row0,rows", [
    ((2048, 1, 2048), 0, 2048 * 2048), ((2048, 1, 2048), 3 * 2048 * 256,
                                        2048 * 256),
    ((128, 128, 128), 0, 128 ** 3), ((32, 24, 16), 32 * 29, 32 * 50)])
def test_gs_box_grid_covers_the_rows(dims, row0, rows):
    """The box route's grid covers each box_form plane holding the rows
    [row0, row0 + rows) once (runs of zr planes, tiles of BOX_THREADS
    chunks over a plane); zr is `_box_grid`'s with four blocks an SM on a
    flat plane (one line: ny = 1), two on three-line planes."""
    nx, ny, _nz = dims
    plane = nx * ny
    qa, qb = row0 // plane, -(-(row0 + rows) // plane)
    for vec in (2, 4):
        zr, gx, gy = tso._gs_box_grid(dims, vec, row0, rows, 132)
        assert gx * tso.BOX_THREADS * vec >= plane > (gx - 1) * (
            tso.BOX_THREADS * vec)
        assert (gy - 1) * zr < qb - qa <= gy * zr
        resident = tso.GS_BOX_FLAT_RESIDENT if ny == 1 else \
            tso.BOX_RESIDENT[0]
        assert (gx, gy, zr) == tso._box_grid((nx, ny, qb - qa), vec, 132,
                                             resident)
