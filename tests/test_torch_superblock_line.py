"""Kernel #9's line route (csrc/block_trisolve.cu:
`super_level_line_kernel`, plane and const modes), emulated thread by
thread in NumPy from the launch tables the wrapper builds, against the
plain levels, bit for bit:

* the block of `line_shape` (lb lines, tl threads a line), thread k of a
  line on rows p + sx·(k + tl·j) in each parity pass, the self legs'
  solved parities as one bitmask a pass, the block's lines in a buffer
  written to x once;
* plane mode: each (line, group)'s two source offsets from Δ = q·nx + r
  (no division a row), a row at x reading line ℓ + q at x + r, or line
  ℓ + q + 1 at x + r − nx, 0 where that line leaves the superblock;
* const mode: interior rows on the unrolled legs with no bounds test,
  edge rows on the tested loop, the per-row 1/D read once a row;

on every level of the fdm:32 plane pair (and the same pair with extra
cross groups whose Δ wraps a line or leaves [0, m)), an hpcg:16x12x8
plane pair, the hpcg:16x16x16 const GS pair and a small Anderson const
pair with a per-row D, f32 and f64, on one device (`super_level_plain`)
and on each shard of a 4-shard mesh (`super_level_halo_plain`); one
emulated plane level against the JAX package's XLA level; and the route
picker (`line_shape`, `level_route_for`).
"""
import dataclasses

import numpy as np
import pytest
import torch

import basic_iterative_solvers_tpu_torch as bt
from basic_iterative_solvers_tpu_torch.coloring import spec_for_device
from basic_iterative_solvers_tpu_torch.ops import block_trisolve as bk
from basic_iterative_solvers_tpu_torch.parallel import make_mesh
from tests.test_torch_ilu0_factor import numpy_branch  # noqa: F401

CPU = "cpu"
ANDERSON = "anderson:Lx=8,Ly=8,Lz=8,ranpot=4.0"
#: the H100's multiprocessors, which the launch shapes are worked out for
SMS = 132
#: csrc/block_trisolve.cu: BIS_SL_NO_SOURCE
NO_SOURCE = -2 ** 31
DTYPES = [torch.float32, torch.float64]


def _host_pair(spec, dtype, precond):
    cfg = bt.SolverConfig(
        preconditioner=bt.PrecondType[precond], dtype=dtype,
        gs_mode="colored",
        color_spec=bt.generators.color_spec_for_source(spec))
    M = bt.preprocessing(bt.generators.from_source(spec), cfg,
                         device=CPU).M
    return M.L_block, M.U_block


def _wrapping(B, seed):
    """B with extra cross groups on every level: Δ wrapping a line (r ≠ 0),
    reaching past either end of the superblock from its first or last
    lines, random plane values."""
    nx, m = B.spec_params[0], B.m
    g = np.random.default_rng(seed)
    np_dt = bk._np_dtype(B.dtype)
    levels, vals = [], []
    for li, (sb, cross, selfs) in enumerate(B.levels):
        src = (sb + 1) % B.S
        extra = [(src, d) for d in (-nx - 3, -1, 5, nx - 1, 3 * nx + 7)]
        groups = sorted(set(cross) | set(extra))
        old = dict(zip(cross, B.vals_cross[li] if cross else ()))
        planes = [old[k].numpy() if k in old
                  else g.standard_normal(m).astype(np_dt) for k in groups]
        levels.append((sb, tuple(groups), selfs))
        vals.append(torch.from_numpy(np.array(planes, dtype=np_dt)))
    return dataclasses.replace(B, levels=tuple(levels),
                               vals_cross=tuple(vals), _args={})


def _pairs(case, dtype):
    if case == "fdm32-plane":
        return _host_pair("fdm:32", dtype, "ILU0")
    if case == "fdm32-wrapping":
        L, U = _host_pair("fdm:32", dtype, "ILU0")
        return (_wrapping(L, 1),)
    if case == "hpcg16x12x8-plane":
        return _host_pair("hpcg:16x12x8", dtype, "ILU0")
    if case == "hpcg16-const":
        A = bt.stencil_op.from_source_operator("hpcg:16x16x16", dtype,
                                               device=CPU)
        return bk.build_superblock_gs_pair_stencil(
            A, spec_for_device(A), dtype=dtype, need_d=True)
    return _host_pair(ANDERSON, dtype, "SYMMETRIC_GAUSS_SEIDEL")


def _emulate_line(a, tl, lb, y, x, vc, vs, drows):
    """x after super_level_line_kernel's launch with launch table `a` on
    blocks of (tl, lb) threads: every thread of the grid at once, as
    (block, line of the block, thread of the line) arrays, each pass and
    each leg in the kernel's order, each product and difference rounded
    alone in the vectors' type."""
    dt = x.dtype
    nx, sx, nc, ns = a.nx, a.sx, a.n_cross, a.n_self
    x = x.copy()
    grid = -(-a.lines // lb)
    k = (np.arange(grid)[:, None] * lb + np.arange(lb)[None, :])[..., None]
    tx = np.arange(tl)[None, None, :]
    live = np.broadcast_to(k < a.lines, (grid, lb, tl))
    line = a.line0 + k
    gy = a.sy * (line % a.my) + a.py
    gz = a.sz * (line // a.my) + a.pz
    row = nx * (gy + a.ny * gz)
    slot = line * nx
    iy, ix = row - a.y_row0, row - a.x_row0
    # the block's line buffers in shared memory (k, x); a dead line's stay 0
    buf = np.zeros((grid, lb, nx), dtype=dt)
    bi = np.broadcast_to(np.arange(grid)[:, None, None], (grid, lb, tl))
    li = np.broadcast_to(np.arange(lb)[None, :, None], (grid, lb, tl))
    src = np.zeros((grid, lb, 1, 2 * max(nc, 1)), dtype=np.int64)
    if a.mode == bk._MODE_PLANE:
        lines_m = a.m // nx
        for l in range(nc):
            for h in range(2):
                sl = line[..., 0] + a.cross_q[l] + h
                ok = (sl >= 0) & (sl < lines_m)
                s = np.where(ok, sl, 0)
                srow = nx * (a.sy * (s % a.my) + a.cross_spy[l] + a.ny * (
                    a.sz * (s // a.my) + a.cross_spz[l]))
                e = srow - row[..., 0] + a.cross_r[l] - h * nx
                assert (np.abs(e[ok]) < 2 ** 31).all()
                src[:, :, 0, 2 * l + h] = np.where(ok, e, NO_SOURCE)
    line_in = ((gy >= a.cross_ry) & (gy < a.ny - a.cross_ry)
               & (gz >= a.cross_rz) & (gz < a.nz - a.cross_rz))
    for j in range(-(-nx // tl)):
        gx = tx + tl * j
        on = live & (gx < nx)
        g0 = np.where(on, gx, 0)
        acc = y[np.where(on, iy + g0, 0)]
        if a.mode == bk._MODE_PLANE:
            for l in range(nc):
                h = np.where(g0 + a.cross_r[l] < nx, 0, 1)
                e = np.take_along_axis(
                    np.broadcast_to(src, (grid, lb, tl, src.shape[-1])),
                    (2 * l + h)[..., None], -1)[..., 0]
                ok = e != NO_SOURCE
                xv = np.where(ok, x[np.where(on & ok, ix + g0 + e, 0)], 0)
                f = vc[np.where(on, l * a.plane_m + slot - a.slot0 + g0, 0)]
                acc = acc - f * xv.astype(dt)
        else:
            inner = line_in & (g0 >= a.cross_rx) & (g0 < nx - a.cross_rx)
            for l in range(nc):
                c = dt.type(a.cross_coeff[l])
                ingrid = ((g0 + a.cross_dx[l] >= 0) & (g0 + a.cross_dx[l] < nx)
                          & (gy + a.cross_dy[l] >= 0)
                          & (gy + a.cross_dy[l] < a.ny)
                          & (gz + a.cross_dz[l] >= 0)
                          & (gz + a.cross_dz[l] < a.nz))
                use = on & (inner | ingrid)
                xv = x[np.where(use, ix + g0 + a.cross_off[l], 0)]
                acc = np.where(use, acc - c * xv, acc)
        buf[bi[on], li[on], g0[on]] = acc[on]
    for step in range(sx):
        p = sx - 1 - step if a.upper else step
        solved = 0
        for l in range(ns):
            q = (p + a.self_dx[l]) % sx
            if (q > p) if a.upper else (q < p):
                solved |= 1 << l
        for j in range(-(-nx // (sx * tl))):
            gx = p + sx * (tx + tl * j)
            on = live & (gx < nx)
            g0 = np.where(on, gx, p)
            v = buf[bi, li, g0]
            for l in range(ns):
                px = g0 + a.self_dx[l]
                ok = bool(solved >> l & 1) & (px >= 0) & (px < nx)
                src_v = buf[bi, li, np.where(ok, px, g0)]
                if a.mode == bk._MODE_PLANE:
                    f = vs[np.where(on, l * a.plane_m + slot - a.slot0 + g0,
                                    0)]
                    v = v - f * np.where(ok, src_v, 0).astype(dt)
                else:
                    v = np.where(ok, v - dt.type(a.self_coeff[l]) * src_v, v)
            d = (drows[np.where(on, iy + g0, 0)] if drows is not None
                 else dt.type(a.dinv))
            v = v * d
            buf[bi[on], li[on], g0[on]] = v[on]
    for j in range(-(-nx // tl)):
        gx = np.broadcast_to(tx + tl * j, live.shape)
        on = live & (gx < nx)
        x[(ix + gx)[on]] = buf[bi[on], li[on], gx[on]]
    return x


def _np(t):
    """A plane stack or diagonal as the flat array the kernel reads."""
    return None if t is None else t.reshape(-1).numpy()


def _check_whole(B, li, y, x):
    a = bk._level_args(B, li)
    tl, lb = bk._line_shape(B, li, x.itemsize, None, 0)
    vc, vs = bk._planes(B, li)
    got = _emulate_line(a, tl, lb, y, x, _np(vc), _np(vs), _np(B.dinv_rows))
    ref = bk.super_level_plain(B, li, torch.from_numpy(y),
                               torch.from_numpy(x.copy())).numpy()
    np.testing.assert_array_equal(got, ref)
    return got


@pytest.fixture
def sms(monkeypatch):
    monkeypatch.setattr(bk, "sm_count", lambda index: SMS)
    return SMS


CASES = ["fdm32-plane", "fdm32-wrapping", "hpcg16x12x8-plane",
         "hpcg16-const", "anderson-const"]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("case", CASES)
def test_line_route_emulation_matches_plain(case, dtype, sms):
    """Every level of the pair: the emulated line route bit-equal to
    super_level_plain on one device, and on each shard of a 4-shard mesh
    to super_level_halo_plain on the shard's window."""
    g = np.random.default_rng(3)
    mesh = make_mesh(4, device=CPU)
    np_dt = bk._np_dtype(dtype)
    pair = _pairs(case, dtype)
    # a plane pair's U may be const mode with a per-row D (fdm:32)
    assert pair[0].is_plane == case.endswith(("plane", "wrapping"))
    for B in pair:
        assert not B.is_table
        if case == "anderson-const":
            assert len(set(B.dinv_rows.tolist())) > 1
        n = B.n_rows
        MB = bk.shard_superblock(B, mesh)
        R, H = MB.rows, MB.halo
        for li in range(len(B.levels)):
            # these launches leave most of a 132-SM card idle: the picker
            # names the direct route, the line route runs when forced
            assert bk.level_route_for(B, li, np_dt(0).itemsize,
                                      device=torch.device("cuda", 0)) \
                == "direct"
            y = g.standard_normal(n).astype(np_dt)
            x = g.standard_normal(n).astype(np_dt)
            _check_whole(B, li, y, x)
            xw = np.pad(x, (H, 4 * R - n + H))
            yw = np.pad(y, (0, 4 * R - n))
            for k, Bs in enumerate(MB.shards):
                l0, l1 = Bs.lines[li]
                if l1 == l0:
                    continue
                a = bk._shard_args(Bs, li)
                tl, lb = bk._line_shape(B, li, x.itemsize, Bs, 0)
                win, yk = xw[k * R:(k + 1) * R + 2 * H], yw[k * R:(k + 1) * R]
                vc = Bs.vals_cross[li] if B.is_plane else None
                vs = Bs.vals_self[li] if B.is_plane else None
                got = _emulate_line(a, tl, lb, yk, win, _np(vc), _np(vs),
                                    _np(Bs.dinv_rows))
                ref = bk.super_level_halo_plain(
                    Bs, li, torch.from_numpy(yk.copy()),
                    torch.from_numpy(win.copy())).numpy()
                np.testing.assert_array_equal(got, ref)


def test_wrapping_groups_cover_the_carry(sms):
    """The extra groups of the fdm:32 pair do what they are there for: on
    some level a group's rows take line ℓ + q + 1 (x + r ≥ nx) and some
    (line, group) has no source line."""
    (B,) = _pairs("fdm32-wrapping", torch.float64)
    nx, lines = B.spec_params[0], B.m // B.spec_params[0]
    wraps = outside = 0
    for li in range(len(B.levels)):
        a = bk._level_args(B, li)
        for l in range(a.n_cross):
            q, r = a.cross_q[l], a.cross_r[l]
            assert q * nx + r == a.cross_delta[l] and 0 <= r < nx
            wraps += r > 0
            outside += any(not 0 <= ln + q + h < lines
                           for ln in range(lines) for h in (0, 1))
    assert wraps and outside


def test_emulated_plane_level_matches_xla(rng, numpy_branch,  # noqa: F811
                                         sms):
    """The emulated line route's plane levels of the fdm:32 ILU(0) pair
    against the JAX package's _super_level_xla, float64, rtol 1e-14 (the
    tolerance of test_torch_superblock_csr's plane-level test)."""
    import jax.numpy as jnp
    from basic_iterative_solvers_tpu.ops import block_trisolve as jbt
    from tests.test_torch_superblock_csr import _pairs as csr_pairs
    (Lt, _Ut), (Lj, _Uj) = csr_pairs("fdm:32", "ilu0", torch.float64,
                                     np.float64)
    assert Lt.is_plane
    y, x = rng.standard_normal(Lt.n_rows), rng.standard_normal(Lt.n_rows)
    yb = jbt._permute_super(Lj, jnp.asarray(y))
    xb = list(jbt._permute_super(Lj, jnp.asarray(x)))
    for li, (sb, _c, _s) in enumerate(Lt.levels):
        got = _check_whole(Lt, li, y, x)
        ref = np.asarray(jbt._super_level_xla(Lj, li, yb[sb], xb))
        ref = ref.reshape(-1)[:Lt.m]
        mine = bk._slots(Lt, torch.from_numpy(got), sb).reshape(-1)
        np.testing.assert_allclose(mine.numpy(), ref, rtol=1e-14,
                                   atol=1e-14 * np.abs(ref).max())



@pytest.mark.parametrize("args,shape", [
    ((2048, 2, 1024, 2, 4, 132), (128, 2)),     # fdm:2048, one device
    ((2048, 2, 128, 2, 4, 132), (1024, 1)),     # fdm:2048, 8 shards
    ((2048, 2, 128, 0, 8, 132), (1024, 1)),
    ((2048, 2, 1024, 2, 4, 66), (64, 4)),       # a card of half the SMs
    ((128, 2, 4096, 0, 4, 132), (32, 8)),       # 128^3, one device
    ((128, 2, 512, 0, 4, 132), (128, 2)),       # 128^3, 8 shards
    ((32, 2, 16, 7, 8, 132), (32, 1)),
    ((12288, 2, 64, 0, 4, 132), (1024, 1)),
    ((12288, 2, 64, 0, 8, 132), None),          # a line exceeds 48 KB
    ((6144, 2, 64, 1, 8, 132), None)])
def test_line_shape_rule(args, shape):
    """line_shape: the block by nx, parities, lines, groups, type and the
    card's SMs, None where one line's buffer does not fit; the block
    stays within the kernel's limits."""
    got = bk.line_shape(*args)
    assert got == shape
    if got is not None:
        tl, lb = got
        nx, _sx, _lines, groups, item, _sms = args
        assert tl * lb <= bk.LINE_THREADS
        assert lb * (nx * item + 8 * groups) <= bk.LINE_SMEM_MAX


def _geometry(nx, ny, nz, mode):
    """A const or plane level pair's metadata on an (nx, ny, nz) grid under
    the spec (nx, ny, nz, 2, 2, 1) (S = 2 superblocks a level, nothing on
    any device): enough for the route picker, which reads shapes only."""
    m = nx * (ny // 2) * nz
    levels = ((0, (), (-1, 1)), (1, ((0, 0), (0, nx)), (-1, 1)))
    kw = (dict(vals_cross=(None, torch.zeros(0)), vals_self=(None, None))
          if mode == "plane" else
          dict(const_cross=((), ((1.0, 0, -1, 0), (1.0, 0, 1, 0))),
               const_self=(((1.0, -1), (1.0, 1)),) * 2, dinv=0.25))
    return bk.SuperBlockTriSolve(
        n_rows=2 * m, S=2, m=m, sx=2, levels=levels, upper=False,
        spec_params=(nx, ny, nz, 2, 2, 1), dtype=torch.float32,
        reach=(1, 1, 0), **kw)


def test_route_kept_with_the_launch_table(sms):
    """level_route_for works a plane or const level's route and line shape
    out once per vector type and card, from shapes alone (no kernel
    library, which this machine cannot build), and keeps them with the
    launch table: B's for the whole level, a shard's for its launch.  The
    line route where the launch's rows fill the card's resident threads
    and a line fits the buffer; else the direct route; a route forced
    into the cache comes back."""
    card = torch.device("cuda", 0)
    for mode in ("plane", "const"):
        B = _geometry(2048, 2048, 1, mode)          # fdm:2048's levels
        assert B.is_plane == (mode == "plane")
        for _ in range(2):
            assert bk.level_route_for(B, 1, 4, device=card) == "line"
        assert B._args[("route", 1, 4, 0)] == "line"
        groups = 2 if mode == "plane" else 0
        assert B._args[("line_shape", 1, 4, 0)] == bk.line_shape(
            2048, 2, 1024, groups, 4, SMS) == (128, 2)
        # a shard of 128 lines (an 8-shard mesh's) fills the card; one of
        # 32 lines (65,536 rows) does not
        for lines, route in ((128, "line"), (32, "direct")):
            Bs = bk.SuperBlockShard(B=B, row0=0, rows=2 * lines * 2048,
                                    halo=2048, lines=((0, lines),) * 2)
            assert bk.level_route_for(B, 1, 8, Bs, card) == route
            assert Bs._args[("route", 1, 8, 0)] == route
            assert ("route", 1, 8, 0) not in B._args
        assert Bs._args.get(("line_shape", 1, 8, 0)) is None
        assert bk._line_shape(B, 1, 8, Bs, 0) == (1024, 1)
    # the 128^3 GS pair's geometry: one device fills the card, a shard of
    # 512 lines does not (the direct route was faster there)
    B = _geometry(128, 128, 64, "const")
    assert bk.level_route_for(B, 0, 4, device=card) == "line"
    Bs = bk.SuperBlockShard(B=B, row0=0, rows=2 * 512 * 128, halo=128 * 128,
                            lines=((0, 512),) * 2)
    assert bk.level_route_for(B, 0, 4, Bs, card) == "direct"
    B._args[("route", 1, 4, 0)] = "direct"
    assert bk.level_route_for(B, 1, 4, device=card) == "direct"
    # a line of 8,192 values fits the buffer in float32 (32 KB) and not in
    # float64 (64 KB)
    wide = _geometry(8192, 1024, 1, "const")
    assert bk.level_route_for(wide, 1, 4, device=card) == "line"
    assert bk.level_route_for(wide, 1, 8, device=card) == "direct"
    # a card of fewer SMs takes another block
    assert bk.line_shape(2048, 2, 1024, 2, 4, 66) != bk.line_shape(
        2048, 2, 1024, 2, 4, SMS)


@pytest.mark.parametrize("case", ["fdm32-plane", "hpcg16-const"])
def test_cpu_tensor_takes_the_plain_level(case, sms):
    """A CPU tensor takes the plain level, even with the line route in the
    cache: no kernel counter moves, the result is the plain level's."""
    for B in _pairs(case, torch.float64):
        g = np.random.default_rng(9)
        for li in range(len(B.levels)):
            B._args[("route", li, 8, 0)] = "line"
            y = torch.from_numpy(g.standard_normal(B.n_rows))
            x = torch.from_numpy(g.standard_normal(B.n_rows))
            before = {k: v for k, v in vars(bk.super_level).items()
                      if k.endswith("launches")}
            got = bk.super_level(B, li, y, x.clone())
            ref = bk.super_level_plain(B, li, y, x.clone())
            assert torch.equal(got, ref)
            assert {k: v for k, v in vars(bk.super_level).items()
                    if k.endswith("launches")} == before
