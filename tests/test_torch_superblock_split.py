"""The split route's kernels #10 (`super_acc`) and #11 (`super_parity`) on
their staged and line routes (csrc/block_trisolve.cu:
`super_acc_staged_kernel`, `super_parity_staged_kernel`,
`super_acc_line_kernel`, `super_parity_line_kernel`), emulated thread by
thread in NumPy from the launch tables the wrapper builds, against the
plain versions `super_acc_plain` and `super_parity_plain`, bit for bit:

* staged acc (factor-table mode): a warp a line, 8 lines a block, the
  blocks walking the line groups persistently, the block's x-classes and
  each line's cross-leg factors staged (restaged where a slot's next line
  has another (y, z) class); interior rows on the unrolled legs with no
  bounds test, edge rows on the tested loop;
* staged parity: `parity_shape`'s block walking the lines the same way,
  thread k of a line on rows p + sx·(k + tl·j), each line's self-leg
  factors and pivots staged, the solved source parities one bitmask a
  launch;
* line acc (plane mode): `line_shape`'s block, each (line, group)'s two
  source offsets from Δ = q·nx + r;
* line parity: `parity_shape`'s block, the self planes at the row's slot,
  the per-row 1/D;

on every level and parity of the hpcg:12x8x6 and hpcg:72x8x6 factor-table
pairs (levels with no cross legs, rows inside and at the edges) and of
plane pairs from host CSR on fdm:24 and
hpcg:12x8x6 (and fdm:24 with cross groups that wrap a line or leave the
superblock), float32 and float64; the block rule and the split picker
(`split_route_for`, kept with the launch table).
"""
import dataclasses

import numpy as np
import pytest
import torch

import basic_iterative_solvers_tpu_torch as bt
from basic_iterative_solvers_tpu_torch import coloring as tcol
from basic_iterative_solvers_tpu_torch import stencil_op as tso
from basic_iterative_solvers_tpu_torch.ops import block_trisolve as bk
from tests.test_torch_superblock_line import NO_SOURCE, SMS, _wrapping

CPU = "cpu"
DTYPES = [torch.float32, torch.float64]
#: csrc/block_trisolve.cu: BIS_SL_STAGED_BX, and the lines of its block
WARP, STAGED_LINES = 32, 8


@pytest.fixture
def sms(monkeypatch):
    monkeypatch.setattr(bk, "sm_count", lambda index: SMS)
    return SMS


def _table_pair(spec, dtype):
    A = tso.from_source_operator(spec, dtype, device=CPU)
    L, U = bk.build_superblock_ilu0_pair_stencil(A, tcol.spec_for_device(A),
                                                 dtype=dtype)
    return tuple(dataclasses.replace(B, fused=False, _args={})
                 for B in (L, U))


def _plane_pair(spec, dtype, monkeypatch):
    """The ILU(0) pair built from host CSR on the split route (nx does not
    divide 128, BIS_SB_ALIGNED=0): both triangles in plane mode."""
    monkeypatch.setattr(bk, "NO_ALIGNED", True)
    cfg = bt.SolverConfig(
        preconditioner=bt.PrecondType.ILU0, dtype=dtype, gs_mode="colored",
        color_spec=bt.generators.color_spec_for_source(spec))
    M = bt.preprocessing(bt.generators.from_source(spec), cfg,
                         device=CPU).M
    pair = (M.L_block, M.U_block)
    assert all(B.is_plane and not B.fused for B in pair)
    return pair


def _proto_class(i, n, P, s, R):
    if P == n:
        return i
    c = np.where(i < R, i, np.where(n - 1 - i < R, P - 1 - (n - 1 - i),
                                    R + (i - R) % s))
    return np.clip(c, 0, P - 1)


def _lines(a, grid, lb):
    """Per launch line (block, line of the block) flattened: k, live and
    the line's coordinates, as level_line gives them."""
    k = (np.arange(grid)[:, None] * lb + np.arange(lb)[None, :]).reshape(-1)
    live = k < a.lines
    k = k[live]
    line = a.line0 + k
    gy = a.sy * (line % a.my) + a.py
    gz = a.sz * (line // a.my) + a.pz
    row = a.nx * (gy + a.ny * gz)
    return dict(k=k, gy=gy, gz=gz, row=row, slot=line * a.nx,
                iy=row - a.y_row0, ix=row - a.x_row0,
                line_in=((gy >= a.cross_ry) & (gy < a.ny - a.cross_ry)
                         & (gz >= a.cross_rz) & (gz < a.nz - a.cross_rz)))


def _line_class(a, gy, gz):
    return a.proto_x * (_proto_class(gy, a.ny, a.proto_y, a.sy, a.radius)
                        + a.proto_y * _proto_class(gz, a.nz, a.proto_z, a.sz,
                                                   a.radius))


def _persistent_classes(a, lb, grid):
    """The (y, z) class whose factors each line k is solved with, as the
    persistent staged kernels walk the lines: block b takes the line groups
    b, b + grid, ...; slot j of a block keeps what it staged until a live
    line of that slot has another class (the block restages then)."""
    g = _lines(a, -(-a.lines // lb), lb)
    own = _line_class(a, g["gy"], g["gz"])
    used = np.full(a.lines, -1, dtype=np.int64)
    for b in range(grid):
        staged = [-1] * lb
        for grp in range(b, -(-a.lines // lb), grid):
            ks = [k for k in range(grp * lb, (grp + 1) * lb) if k < a.lines]
            if any(own[k] != staged[k - grp * lb] for k in ks):
                for k in ks:
                    staged[k - grp * lb] = own[k]
            for k in ks:
                used[k] = staged[k - grp * lb]
    return used


def _staged_factors(a, g, table, legs, pivots=None, lb=STAGED_LINES):
    """Each line's staged factors: fac[line, j, cx] of legs[j] (table rows)
    at the (y, z) class the persistent walk holds for it (one block, so
    every slot is reused), and its pivots (or None)."""
    Px = a.proto_x
    cyz = _persistent_classes(a, lb, 1)[g["k"]]
    assert (cyz == _line_class(a, g["gy"], g["gz"])).all()
    c = cyz[:, None] + np.arange(Px)[None, :]
    fac = np.stack([table[kd * a.n_proto + c] for kd in legs], axis=1) \
        if legs else np.zeros((len(cyz), 0, Px), table.dtype)
    return fac, (None if pivots is None else pivots[c])


def _emulate_acc_staged(a, y, x, table):
    """acc (m,) after super_acc_staged_kernel's launch: a warp a line, each
    lane on rows lane + 32·j, interior rows on the unrolled legs with no
    bounds test, edge rows on the tested loop; every slot written once."""
    dt = x.dtype
    nx, nc, Px = a.nx, a.n_cross, a.proto_x
    grid = -(-a.lines // STAGED_LINES)
    g = _lines(a, grid, STAGED_LINES)
    cls = _proto_class(np.arange(nx), nx, Px, a.sx, a.radius)
    fac, _ = _staged_factors(a, g, table, [a.cross_kd[l] for l in range(nc)])
    off = [int(a.cross_off[l]) for l in range(nc)]
    nl = len(g["k"])
    rows = np.arange(nl)[:, None]
    acc = np.full(a.m, np.nan, dtype=dt)
    writes = np.zeros(a.m, dtype=np.int64)
    for g0 in range(0, nx, WARP):
        gx = g0 + np.arange(WARP)[None, :]
        on = np.broadcast_to(gx < nx, (nl, WARP))
        gxc = np.where(gx < nx, gx, 0)
        inner = (g["line_in"][:, None] & (gx >= a.cross_rx)
                 & (gx < nx - a.cross_rx))
        ixr = g["ix"][:, None] + gxc
        cx = np.broadcast_to(cls[gxc], (nl, WARP))
        v = y[g["iy"][:, None] + gxc]
        for l in range(nc):
            px = gx + a.cross_dx[l]
            py = g["gy"][:, None] + a.cross_dy[l]
            pz = g["gz"][:, None] + a.cross_dz[l]
            ok = inner | ((px >= 0) & (px < nx) & (py >= 0) & (py < a.ny)
                          & (pz >= 0) & (pz < a.nz))
            xv = x[np.where(ok & on, ixr + off[l], 0)]
            v = np.where(ok, v - fac[:, l, :][rows, cx] * xv, v)
        dst = (g["slot"][:, None] - a.slot0 + gxc)[on]
        acc[dst] = v[on]
        np.add.at(writes, dst, 1)
    assert (writes == 1).all()
    return acc


def _emulate_acc_line(a, tl, lb, y, x, vc):
    """acc (m,) after super_acc_line_kernel's launch on a (tl, lb) block."""
    dt = x.dtype
    nx, nc = a.nx, a.n_cross
    grid = -(-a.lines // lb)
    g = _lines(a, grid, lb)
    lines_m = a.m // nx
    src = np.full((len(g["k"]), 2 * max(nc, 1)), NO_SOURCE, dtype=np.int64)
    for l in range(nc):
        for h in range(2):
            sl = a.line0 + g["k"] + a.cross_q[l] + h
            ok = (sl >= 0) & (sl < lines_m)
            s = np.where(ok, sl, 0)
            srow = nx * (a.sy * (s % a.my) + a.cross_spy[l] + a.ny * (
                a.sz * (s // a.my) + a.cross_spz[l]))
            e = srow - g["row"] + a.cross_r[l] - h * nx
            assert (np.abs(e[ok]) < 2 ** 31).all()
            src[:, 2 * l + h] = np.where(ok, e, NO_SOURCE)
    acc = np.full(a.m, np.nan, dtype=dt)
    writes = np.zeros(a.m, dtype=np.int64)
    rows = np.arange(len(g["k"]))[:, None]
    for j in range(-(-nx // tl)):
        gx = np.arange(tl)[None, :] + tl * j
        on = np.broadcast_to(gx < nx, (len(g["k"]), tl))
        gxc = np.where(gx < nx, gx, 0)
        v = y[g["iy"][:, None] + gxc]
        for l in range(nc):
            e = src[rows, 2 * l + np.where(gxc + a.cross_r[l] < nx, 0, 1)]
            ok = e != NO_SOURCE
            xv = np.where(ok, x[np.where(ok & on, g["ix"][:, None] + gxc + e,
                                         0)], 0).astype(dt)
            v = v - vc[l * a.plane_m + g["slot"][:, None] - a.slot0 + gxc] * xv
        dst = (g["slot"][:, None] - a.slot0 + gxc)[on]
        acc[dst] = v[on]
        np.add.at(writes, dst, 1)
    assert (writes == 1).all()
    return acc


def _solved(a, p):
    mask = 0
    for l in range(a.n_self):
        q = (p + a.self_dx[l]) % a.sx
        if (q > p) if a.upper else (q < p):
            mask |= 1 << l
    return mask


def _emulate_parity(a, p, tl, lb, y, acc, x, table=None, tdinv=None,
                    vs=None, drows=None):
    """x after super_parity_staged_kernel (table given) or
    super_parity_line_kernel's launch of parity p on a (tl, lb) block."""
    dt = x.dtype
    nx, sx, ns = a.nx, a.sx, a.n_self
    x = x.copy()
    grid = -(-a.lines // lb)
    g = _lines(a, grid, lb)
    nl = len(g["k"])
    rows = np.arange(nl)[:, None]
    solved = _solved(a, p)
    if table is not None:
        cls = _proto_class(np.arange(nx), nx, a.proto_x, a.sx, a.radius)
        fsel, piv = _staged_factors(a, g, table,
                                    [a.self_kd[l] for l in range(ns)], tdinv,
                                    lb)
    writes = np.zeros(len(x), dtype=np.int64)
    vin = (acc, g["slot"] - a.slot0) if acc is not None else (y, g["iy"])
    for j in range(-(-nx // (sx * tl))):
        gx = p + sx * (np.arange(tl)[None, :] + tl * j)
        on = np.broadcast_to(gx < nx, (nl, tl))
        gxc = np.where(gx < nx, gx, p)
        v = vin[0][vin[1][:, None] + gxc]
        for l in range(ns):
            px = gxc + a.self_dx[l]
            ok = bool(solved >> l & 1) & (px >= 0) & (px < nx)
            xv = x[g["ix"][:, None] + np.where(ok, px, gxc)]
            if table is not None:
                f = fsel[:, l, :][rows, cls[gxc]]
                v = np.where(ok, v - f * xv, v)
            else:
                f = vs[l * a.plane_m + g["slot"][:, None] - a.slot0 + gxc]
                v = v - f * np.where(ok, xv, 0).astype(dt)
        if table is not None:
            if piv is not None:
                v = v * piv[rows, cls[gxc]]
        else:
            v = v * (drows[g["iy"][:, None] + gxc] if drows is not None
                     else dt.type(a.dinv))
        dst = (g["ix"][:, None] + gxc)[on]
        x[dst] = v[on]
        np.add.at(writes, dst, 1)
    assert writes.max() <= 1
    return x


def _np(t):
    return None if t is None else t.reshape(-1).numpy()


def _check_pair(pair, dtype, seed):
    """Every level and parity of each solve in `pair`: the emulated acc and
    parity launches (the staged or line route of its mode) bit-equal to
    the plain versions."""
    g = np.random.default_rng(seed)
    np_dt = bk._np_dtype(dtype)
    item = np_dt(0).itemsize
    for B in pair:
        n, m = B.n_rows, B.m
        table = _np(B.table) if B.is_table else None
        tdinv = _np(B.table_dinv) if B.is_table else None
        for li, (_sb, cross, _selfs) in enumerate(B.levels):
            a = bk._level_args(B, li)
            y = g.standard_normal(n).astype(np_dt)
            x = g.standard_normal(n).astype(np_dt)
            acc_ref = None
            if cross:
                acc_ref = bk.super_acc_plain(
                    B, li, torch.from_numpy(y), torch.from_numpy(x),
                    torch.empty(m, dtype=dtype)).numpy()
                if B.is_table:
                    got = _emulate_acc_staged(a, y, x, table)
                    np.testing.assert_array_equal(got, acc_ref)
                else:
                    tl, lb = bk._line_shape(B, li, item, None, 0)
                    got = _emulate_acc_line(a, tl, lb, y, x,
                                            _np(B.vals_cross[li]))
                    np.testing.assert_array_equal(got, acc_ref)
            tl, lb = bk._parity_shape(B, li, item, 0)
            for p in bk._parity_order(B):
                ref = bk.super_parity_plain(
                    B, li, p, torch.from_numpy(y),
                    None if acc_ref is None else torch.from_numpy(acc_ref),
                    torch.from_numpy(x.copy())).numpy()
                if B.is_table:
                    got = _emulate_parity(a, p, tl, lb, y, acc_ref, x, table,
                                          tdinv)
                else:
                    got = _emulate_parity(a, p, tl, lb, y, acc_ref, x,
                                          vs=_np(B.vals_self[li]),
                                          drows=_np(B.dinv_rows))
                np.testing.assert_array_equal(got, ref)
                x = got         # the next parity reads this one's rows


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("spec", ["hpcg:12x8x6", "hpcg:72x8x6"])
def test_table_split_emulation_matches_plain(spec, dtype, sms):
    """Factor-table pairs on the split route (128 % nx ≠ 0): the staged
    acc kernel and the staged parity kernel, every level and parity,
    bit-equal to plain; L's first level has no cross legs, so its parity
    steps read y; nx = 72 has interior rows a whole warp wide, nx = 12 a
    class map that is the grid itself."""
    pair = _table_pair(spec, dtype)
    assert not pair[0].levels[0][1]
    _check_pair(pair, dtype, 11)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("spec", ["fdm:24", "hpcg:12x8x6", "fdm:24-wrapping"])
def test_plane_split_emulation_matches_plain(spec, dtype, sms, monkeypatch):
    """Plane pairs from host CSR on the split route: the line acc kernel
    and the line parity kernel, every level and parity, bit-equal to
    plain, the per-row 1/D applied; on fdm:24 also with extra cross groups
    whose Δ wraps a line or leaves the superblock."""
    pair = _plane_pair(spec.split("-")[0], dtype, monkeypatch)
    if spec.endswith("wrapping"):
        pair = (_wrapping(pair[0], 4),)
    _check_pair(pair, dtype, 12)


@pytest.mark.parametrize("args,shape", [
    ((384, 2, 36864, 3 * 18 * 4, 132), (32, 8)),     # 384^3 table, f32
    ((128, 2, 4096, 3 * 18 * 4, 132), (64, 4)),      # 128^3 table
    ((2048, 2, 1024, 0, 132), (256, 1)),             # fdm:2048 plane
    ((12, 2, 12, 3 * 12 * 8, 132), (8, 1)),          # hpcg:12x8x6, f64
    ((24, 2, 12, 0, 132), (16, 1))])                 # fdm:24
def test_parity_shape_rule(args, shape):
    """parity_shape: the line route's rule on ⌈nx/sx⌉ rows a line and
    2,048 resident threads an SM, within the kernel's threads and shared
    memory (the x-classes and the lines' staged factors)."""
    nx, _sx, _lines, line_bytes, _sms = args
    tl, lb = bk.parity_shape(*args)
    assert (tl, lb) == shape
    assert tl * lb <= bk.LINE_THREADS
    assert 4 * ((nx + 3) & ~3) * bool(line_bytes) + lb * line_bytes \
        <= bk.LINE_SMEM_MAX


def test_split_route_kept_with_the_launch_table(sms):
    """split_route_for: a split step takes the fused level's route
    (level_route_for, kept in B._args), but a factor table's parity step
    in float64 takes the float32 level's ("staged" where that is staged;
    the staged acc step lost to the direct one in float64); the parity
    block is worked out once and kept beside it."""
    L, _U = _table_pair("hpcg:12x8x6", torch.float32)
    card = torch.device("cuda", 0)
    for li in range(len(L.levels)):
        L._args[("route", li, 4, 0)] = "staged"
        for step in ("acc", "parity"):
            assert bk.split_route_for(L, li, 4, step, card) == "staged"
        assert bk.split_route_for(L, li, 8, "acc", card) == "direct"
        assert bk.split_route_for(L, li, 8, "parity", card) == "staged"
        assert L._args[("route", li, 8, 0)] == "direct"
        shape = bk._parity_shape(L, li, 4, 0)
        assert L._args[("parity_shape", li, 4, 0)] == shape
    L._args[("route", 1, 4, 0)] = "direct"
    assert bk.split_route_for(L, 1, 8, "parity", card) == "direct"
    # plane mode: the fused level's route in both types
    P = dataclasses.replace(L, table=None, vals_cross=(None,) * 4,
                            vals_self=(None,) * 4, _args={})
    for item in (4, 8):
        P._args[("route", 2, item, 0)] = "line"
        for step in ("acc", "parity"):
            assert bk.split_route_for(P, 2, item, step, card) == "line"


@pytest.mark.parametrize("case", ["table", "plane"])
def test_cpu_tensor_takes_the_plain_split(case, sms, monkeypatch):
    """A CPU tensor takes the plain acc and parity steps, even with a new
    route in the cache: no launch counter moves, the results are the plain
    versions'."""
    pair = (_table_pair("hpcg:12x8x6", torch.float64) if case == "table"
            else _plane_pair("fdm:24", torch.float64, monkeypatch))
    route = "staged" if case == "table" else "line"
    g = np.random.default_rng(9)
    before = {c: dict(vars(c)) for c in (bk.super_acc, bk.super_parity)}
    for B in pair:
        for li, (_sb, cross, _s) in enumerate(B.levels):
            B._args[("route", li, 8, 0)] = route
            y = torch.from_numpy(g.standard_normal(B.n_rows))
            x = torch.from_numpy(g.standard_normal(B.n_rows))
            acc = None
            if cross:
                acc = bk.super_acc(B, li, y, x, torch.empty(B.m,
                                                            dtype=y.dtype))
                assert torch.equal(acc, bk.super_acc_plain(
                    B, li, y, x, torch.empty_like(acc)))
            for p in bk._parity_order(B):
                got = bk.super_parity(B, li, p, y, acc, x.clone())
                assert torch.equal(got, bk.super_parity_plain(
                    B, li, p, y, acc, x.clone()))
    for c in (bk.super_acc, bk.super_parity):
        assert {k: v for k, v in vars(c).items() if k.endswith("launches")} \
            == {k: v for k, v in before[c].items() if k.endswith("launches")}
