"""Kernel #1's shard form on the "box" route (csrc/stencil_spmv.cu:
stencil_spmv_halo_box_kernel) and the line-aligned windows it reads.

* The kernel emulated thread by thread in NumPy from its launch table and
  grid (its threads as array lanes: a chunk of VEC rows each, three lines
  of each plane read only inside the grid and the window, x neighbours by
  the lane shuffles, the march over the planes holding the shard's rows,
  each operation rounded in the working dtype) gives the leg loop's rows
  bit for bit, inert rows 0, and its per-block dot partials (float64
  sums of products rounded in the working dtype, added one at a time)
  sum to `partial_dot` of its rows within float64 rounding, and to the
  plain version's dots within the working dtype's.
* Line-aligned windows (`DeviceStencil.window_halo`) change no result:
  the plain shard versions of #1 and #3 on them give the single-device
  plain versions' rows bit for bit.
* The route pickers' rules: `halo_route_for` and `gs_halo_route_for` on
  the mesh's windows.

The kernel cannot run here; tests/test_torch_cuda.py runs it on the card.
"""
import numpy as np
import pytest
import torch

from basic_iterative_solvers_tpu_torch import coloring as tcol
from basic_iterative_solvers_tpu_torch import stencil_op as tso
from tests.test_torch_stencil import _lanes, emulate_legs

CPU = "cpu"
ANDERSON = "anderson:Lx=8,Ly=7,Lz=6,t=1.0,ranpot=4.0,seed=1"


def emulate_halo_box(A, xw, aux, diag, row0, rows, hneg, dots, sms=132):
    """The box route's launch over rows [row0, row0 + rows) from the
    window xw (global row i at xw[hneg + i - row0]), block by block on the
    grid the wrapper plans for a card of `sms` multiprocessors.  Returns
    (y of the launch's rows, rows no block wrote NaN; the (blocks, dots)
    float64 partials: each thread adds its products one at a time, as
    the kernel's `dsum += (double)(acc * v)`, then the block sums its
    threads)."""
    legs, dims = tso.box_form(A)
    args, _ = tso._launch_table(legs, A.coeff_values, dims, diag is not None,
                                tuple(dots))
    nx, ny, nz = dims
    plane, dtype = nx * ny, xw.dtype.type
    vec = 16 // xw.itemsize
    qa, qb = row0 // plane, -(-(row0 + rows) // plane)
    zr, gx, gy = tso._shard_box_grid(dims, vec, row0, rows, sms,
                                     tso.BOX_RESIDENT[0])
    wlen, nt, cpl = xw.size, tso.BOX_THREADS, nx // vec
    y = np.full(rows, np.nan, xw.dtype)
    partials = np.zeros((gx * gy, len(dots)), np.float64)
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
                assert (ew[ok] % vec == 0).all()      # aligned 16-byte loads
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

        def out(z, planes, dsum):
            t = z * plane + e0 - row0
            own = live & (t >= 0) & (t < rows)
            idx = t[own][:, None] + lanes
            assert np.isnan(y[idx]).all()         # each row written once
            if z >= nz:                           # inert rows: 0
                y[idx] = 0
                return
            acc = np.zeros((nt, vec), xw.dtype)
            for g in range(args.n_groups):
                s = np.zeros((nt, vec), xw.dtype)
                for b in range(27):
                    if args.box_mask[g] >> b & 1:
                        dz, dy, dx = b // 9, b // 3 % 3, b % 3
                        s = s + planes[dz][:, dy, dx:dx + vec]
                acc = acc + dtype(args.group_coeff[g]) * s
            acc = acc[own]
            xc = planes[1][own, 1, 1:vec + 1]
            if diag is not None:
                acc = acc + diag[idx] * xc
            y[idx] = acc
            for q, kind in enumerate(dots):
                v = {"x": xc, "self": acc,
                     "aux": None if aux is None else aux[idx]}[kind]
                for r in range(vec):
                    dsum[own, q] += (acc[:, r] * v[:, r]).astype(np.float64)

        for by in range(gy):
            z0, z1 = qa + by * zr, min(qa + by * zr + zr, qb)
            dsum = np.zeros((nt, len(dots)), np.float64)
            win = [load(z0 - 1, z1), load(z0, z1)]
            for z in range(z0, z1):
                win.append(load(z + 1, z1))
                out(z, win, dsum)
                win.pop(0)
            partials[bx + gx * by] = dsum.sum(axis=0)
    return y, partials


def _five_point(nx, ny, dtype=torch.float64):
    return tso.make_stencil([((0, 0, 0), 4.0), ((-1, 0, 0), -1.0),
                             ((1, 0, 0), -1.0), ((0, -1, 0), -1.0),
                             ((0, 1, 0), -1.0)], nx, ny, 1, dtype=dtype,
                            device=CPU)


def _operator(case, bf16=False):
    if case == "five:40x37":
        return _five_point(40, 37)
    A = tso.from_source_operator(case, torch.float64, device=CPU)
    return tso.stencil_astype(A, torch.bfloat16) if bf16 else A


def _windows(v, R, n_dev, hneg, hpos):
    """Each shard's window of v (padded to n_dev·R): its left neighbour's
    last hneg rows, its own R, its right neighbour's first hpos, zeros at
    the global edges (parallel/sharded._halo_exchange's layout)."""
    vp = np.concatenate([np.zeros(hneg, v.dtype), v,
                         np.zeros(n_dev * R - v.size + hpos, v.dtype)])
    return [vp[k * R:k * R + hneg + R + hpos] for k in range(n_dev)]


SHARDS = [("hpcg:16x12x10", 4, None), ("hpcg:16x12x10", 8, None),
          ("five:40x37", 4, None), ("fdm:40", 4, None), (ANDERSON, 4, 9),
          ("bf16:" + ANDERSON, 2, 13)]


@pytest.mark.parametrize("np_dt", [np.float32, np.float64])
@pytest.mark.parametrize("case,n_dev,lines", SHARDS)
def test_halo_box_equals_the_leg_loop(case, n_dev, lines, np_dt):
    """Each shard's y on the box route, emulated thread by thread on its
    line-aligned window, bit-equal to the leg loop's rows of the whole
    grid, inert rows 0; its dots (the block partials summed) within
    rounding of the plain version's.  Shards as the mesh cuts them (HPCG
    in whole planes, 8 shards of 10 planes leaving inert shards; 2-D
    grids in lines, marched as box_form planes) and shards of `lines`
    x-lines that do not start on a plane (Anderson, a dense diagonal;
    bfloat16 widened exactly); the grid of an H100 and of a card of one
    SM.  The dots also within 1e-10 of `partial_dot` of the shard's rows
    (relative to the sum of the products' sizes), which a kernel summing
    float32 products in float32 misses."""
    bf16 = case.startswith("bf16:")
    A = _operator(case.removeprefix("bf16:"), bf16)
    hneg, hpos = A.window_halo
    nx, n = A.dims[0], A.n_rows
    R = (tso.stencil_shard_rows(A.dims, A.halo, n_dev) if lines is None
         else lines * nx)
    n_dev = max(n_dev, -(-n // R))
    rng = np.random.default_rng(17)
    x = rng.standard_normal(n).astype(np_dt)
    aux = rng.standard_normal(n).astype(np_dt)
    diag = (None if A.diag is None
            else A.diag.to(torch.float64).numpy().astype(np_dt))
    pad = lambda v: np.concatenate([v, np.zeros(n_dev * R - n, v.dtype)])  # noqa: E731
    ref = pad(emulate_legs(A, x, diag))
    wins = _windows(x, R, n_dev, hneg, hpos)
    dots = ("x", "self", "aux")
    tol = 1e-5 if np_dt == np.float32 else 1e-12
    for sms in (132, 1):
        for k in range(n_dev):
            sl = slice(k * R, (k + 1) * R)
            got, parts = emulate_halo_box(
                A, wins[k], pad(aux)[sl],
                None if diag is None else pad(diag)[sl], k * R, R, hneg,
                dots, sms)
            np.testing.assert_array_equal(got, ref[sl])
            if sms == 1:
                continue
            f64 = lambda v: torch.from_numpy(v.astype(np.float64))  # noqa: E731
            plain = tso.stencil_spmv_halo_plain(
                A, f64(wins[k]), k * R, dots, f64(pad(aux)[sl]),
                None if A.diag is None else
                torch.nn.functional.pad(A.diag, (0, n_dev * R - n))[sl])
            for q, kind in enumerate(dots):
                v = {"x": wins[k][hneg:hneg + R], "self": got,
                     "aux": pad(aux)[sl]}[kind]
                scale = float(np.abs(got.astype(np.float64) * v).sum())
                dot = float(parts[:, q].sum())
                assert abs(dot - float(plain[1 + q])) <= tol * (scale or 1.0)
                exact = float(tso.partial_dot(torch.from_numpy(got),
                                              torch.from_numpy(v.copy())))
                assert abs(dot - exact) <= 1e-10 * (scale or 1.0)


@pytest.mark.parametrize("case", ["hpcg:16x12x10", ANDERSON, "fdm:40",
                                  "five:40x37"])
def test_line_aligned_windows_change_no_result(case):
    """The plain shard versions of #1 (every dot kind) and #3 (every
    colour) on the line-aligned windows (the halo rounded up to whole
    x-lines, `A.window_halo`) give the single-device plain versions' rows
    bit for bit, each shard's dots `partial_dot` of its own rows; every
    shard owns at least the rounded halo, and a window not of whole lines
    is refused.  (The mesh built on these windows against one device and
    the JAX mesh: tests/test_torch_mesh_kernels.py.)"""
    A = _operator(case)
    n, nx = A.n_rows, A.dims[0]
    exact, aligned = A.halo, A.window_halo
    assert all(w % nx == 0 and w - nx < h <= w
               for h, w in zip(exact, aligned))
    n_dev = 4
    R = tso.stencil_shard_rows(A.dims, A.halo, n_dev)
    assert R >= max(aligned)
    rng = np.random.default_rng(23)
    x, aux, rhs = (rng.standard_normal(n) for _ in range(3))
    dinv = 1.0 / (4.0 + rng.random(n))
    pad = lambda v: torch.nn.functional.pad(  # noqa: E731
        torch.as_tensor(v), (0, n_dev * R - n))
    diag = None if A.diag is None else pad(A.diag)
    spec = tcol.spec_for_device(A)
    xt, rt, dt = (torch.from_numpy(v) for v in (x, rhs, dinv))
    y1 = pad(tso.stencil_spmv_plain(A, xt))
    steps = [pad(tso.stencil_gs_color_step_plain(A, xt, rt, dt, spec, c))
             for c in range(spec.n_colors)]
    wins = _windows(x, R, n_dev, *aligned)
    for k in range(n_dev):
        sl = slice(k * R, (k + 1) * R)
        d = None if diag is None else diag[sl]
        w, a = torch.from_numpy(wins[k]), pad(aux)[sl]
        ya = tso.stencil_spmv_halo_plain(A, w, k * R, ("x", "self", "aux"),
                                         a, d)
        assert torch.equal(ya[0], y1[sl])
        for got, v in zip(ya[1:], (pad(x)[sl], y1[sl], a)):
            assert torch.equal(got, tso.partial_dot(y1[sl], v))
        for c in range(spec.n_colors):
            ga = tso.stencil_gs_color_step_halo(
                A, w, k * R, pad(rhs)[sl], pad(dinv)[sl], spec, c, d)
            assert torch.equal(ga, steps[c][sl])
    with pytest.raises(ValueError, match="whole x-lines"):
        tso.stencil_spmv_halo_plain(A, torch.zeros(sum(aligned) + R + 1), 0)


def test_halo_route_rules():
    """`halo_route_for`: "box" on the line-aligned windows of HPCG and
    Anderson shards in float32 and float64 (the bfloat16 diagonal too),
    "legs" for legs outside the box, lines not of whole 16-byte vectors
    and an operand off 16 bytes; `gs_halo_route_for` takes #3's box route
    on a 27-point shard's window in float32 (float64 three-line planes
    stay on its leg loop)."""
    for spec, dt, mat in (("hpcg:16x12x10", torch.float32, None),
                          ("hpcg:16x12x10", torch.float64, None),
                          (ANDERSON, torch.float32, None),
                          (ANDERSON, torch.float64, None),
                          (ANDERSON, torch.float32, torch.bfloat16)):
        A = tso.from_source_operator(spec, mat or dt, device=CPU)
        R = A.dims[0] * A.dims[1]
        win = torch.zeros(sum(A.window_halo) + R, dtype=dt)
        v = torch.zeros(R, dtype=dt)
        d = None if A.diag is None else A.diag[:R].contiguous()
        assert tso.halo_route_for(A, win, v, d, v) == "box", (spec, dt)
        cs = tcol.spec_for_device(A)
        gs = tso.gs_halo_route_for(A, win, v, v, cs, d, v)
        assert gs == ("box" if dt == torch.float32 else "legs"), (spec, dt)
    A = tso.from_source_operator("hpcg:16x12x10", torch.float32, device=CPU)
    R = 16 * 12
    xw = torch.zeros(sum(A.window_halo) + R + 1)
    assert tso.halo_route_for(A, xw[1:]) == "legs"
    assert tso.halo_route_for(A, xw[:-1], aux=xw[1:R + 1]) == "legs"
    assert tso.halo_route_for(A, xw[:-1]) == "box"
    odd = tso.from_source_operator("hpcg:37x21x5", torch.float32, device=CPU)
    assert tso.halo_route_for(
        odd, torch.zeros(sum(odd.window_halo) + 37 * 21)) == "legs"
    B = tso.make_stencil([((0, 0, 0), 4.0), ((2, 0, 0), -1.0),
                          ((-2, 0, 0), -1.0)], 8, 7, 6, device=CPU)
    assert tso.halo_route_for(
        B, torch.zeros(sum(B.window_halo) + 56)) == "legs"


@pytest.mark.parametrize("dims,n_dev", [((128, 128, 128), 8),
                                        ((16, 16, 16), 8), ((8, 8, 8), 8),
                                        ((2048, 2048, 1), 8),
                                        ((37, 21, 5), 8)])
def test_shards_hold_the_window_halo(dims, n_dev):
    """`stencil_shard_rows` gives every shard at least the line-aligned
    halo of the 27-point stencil (whole lines or planes a shard), so the
    mesh's exchange takes a neighbour's rows only."""
    A = tso.stencil_27pt_operator(*dims, device=CPU)
    R = tso.stencil_shard_rows(A.dims, A.halo, n_dev)
    assert R % A.dims[0] == 0 and R >= max(A.window_halo)
