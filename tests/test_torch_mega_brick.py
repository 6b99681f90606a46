"""Kernel #12's brick route (csrc/block_trisolve.cu:
`super_solve_brick_kernel`), emulated brick by brick and thread by thread
in NumPy from the brick tables the wrapper builds (`brick_tables`) and the
bricks and block of `brick_shape`, against `super_solve_mega_plain`, bit
for bit:

* a block a brick of by × bz (y, z) lines, the brick's x in its shared
  memory for the whole solve, the same block on the same brick at every
  level, levels in order with a grid barrier between them;
* the brick's y read once, into its place, before the block writes any
  row: a level's acc starts there;
* the brick framed by the legs' reach: each level copies the frame lines
  its table lists from global x, then every cross leg reads shared memory
  at an offset of its own, the same from every row; every place tracks
  the global row it holds and each read is checked against the row it
  must be;
* every row of global x stamped with the level that wrote it: a halo copy
  fails unless its stamp is older than the current level, a shared-memory
  read unless its row was solved at an earlier level (cross legs) or at
  an earlier parity pass of this one (self legs), a y read in place
  unless its row is still unwritten;
* every row on the unrolled legs with no bounds test: an edge row's legs
  outside the grid read a zero of the frame or of a line's x margin that
  nothing wrote (the plain version's f·0), parity passes with every
  thread on a row of the parity, the per-row 1/D read once a row into a
  stage beside the cross half, each solution written to global x in its
  pass;

on the hpcg:16x16x16 const GS pair (several bricks, an uneven last one),
a small Anderson const pair with a per-row D and a 2-D pair (fdm:32,
nz = 1), L, U and each in place, float32 and float64, on brick_shape's
block and on a small one; and the picker (`brick_shape`,
`mega_route_for`) as a pure function of the shape on a card of 132 SMs
and 227 KB of shared memory a block.
"""
import collections
import dataclasses

import numpy as np
import pytest
import torch

import basic_iterative_solvers_tpu_torch as bt
from basic_iterative_solvers_tpu_torch.coloring import spec_for_device
from basic_iterative_solvers_tpu_torch.ops import block_trisolve as bk

CPU = "cpu"
ANDERSON = "anderson:Lx=8,Ly=8,Lz=8,ranpot=4.0"
#: the H100: its multiprocessors and the shared memory a block may take
SMS, SMEM = 132, 227 * 1024
DTYPES = [torch.float32, torch.float64]
#: (pair, multiprocessors the bricks are cut for): several bricks each
CASES = [("hpcg16-const", 6), ("anderson-const", 3), ("fdm32-const", 3)]


def _host_pair(spec, dtype):
    cfg = bt.SolverConfig(
        preconditioner=bt.PrecondType.SYMMETRIC_GAUSS_SEIDEL, dtype=dtype,
        gs_mode="colored",
        color_spec=bt.generators.color_spec_for_source(spec))
    M = bt.preprocessing(bt.generators.from_source(spec), cfg,
                         device=CPU).M
    return M.L_block, M.U_block


def _pair(case, dtype):
    if case == "hpcg16-const":
        A = bt.stencil_op.from_source_operator("hpcg:16x16x16", dtype,
                                               device=CPU)
        return bk.build_superblock_gs_pair_stencil(
            A, spec_for_device(A), dtype=dtype, need_d=True)
    return _host_pair(ANDERSON if case == "anderson-const" else "fdm:32",
                      dtype)


def _emulate_brick(B, tables, shape, y, x, drows, inplace):
    """Global x after super_solve_brick_kernel's launch for B with brick
    tables `tables` (brick_tables) and brick shape (by, bz, tl, lb), x
    being y itself where `inplace`: every brick's block in turn within a
    level (each reads only what earlier levels wrote), each pass as (line
    of the block, thread of the line) arrays, legs in the kernel's order,
    each product and difference rounded alone in the vectors' type; every
    shared-memory place tracks the global row it holds, and each read is
    checked against the row it must be.  Returns (x, counts of the reads
    by kind and of the rows by path)."""
    nx, ny, nz, _sx, sy, sz = B.spec_params
    by, bz, tl, lb = shape
    rx, ry, rz = bk._brick_frame(B)
    dt = y.dtype
    shared, part = bk.brick_parts(y.itemsize, by, bz, ry, rz, sy, sz)
    n_lv = len(B.levels)
    head = tables[:n_lv * shared].reshape(n_lv, shared)
    nby, nbz = -(-ny // by), -(-nz // bz)
    parts = tables[n_lv * shared:].reshape(nby * nbz, n_lv, part)
    fy, ls = by + 2 * ry, nx + 2 * rx
    kmax = (by // sy) * (bz // sz)
    X = (y if inplace else x).copy()
    Y = X if inplace else y
    stamp = np.full(X.shape, -1)
    size = fy * (bz + 2 * rz) * ls
    bricks = []
    for b in range(nby * nbz):
        y0, z0 = (b % nby) * by, (b // nby) * bz
        ey, ez = min(by, ny - y0), min(bz, nz - z0)
        assert ey % sy == 0 and ez % sz == 0
        # the framed brick in shared memory, zeroed; each place's global
        # row (-1: the zero); the level it was solved at (-2: the zero,
        # never written; -1: y or acc; a frame place: its row's stamp when
        # copied); the level whose acc it holds
        buf, rowid = np.zeros(size, dt), np.full(size, -1)
        fin, accl = np.full(size, -2), np.full(size, -1)
        # the brick's y into its place, before the block writes any row
        # (other blocks may have written theirs)
        for L in range(ey * ez):
            gy, gz = y0 + L % ey, z0 + L // ey
            r = nx * (gy + ny * gz) + np.arange(nx)
            pl = ((gz - z0 + rz) * fy + gy - y0 + ry) * ls + rx
            assert (stamp[r] == -1).all(), "y overwritten"
            buf[pl:pl + nx], rowid[pl:pl + nx], fin[pl:pl + nx] = Y[r], r, -1
        bricks.append((ey, ez, buf, rowid, fin, accl))
    counts = collections.Counter()
    ty = np.arange(lb)[:, None]
    tx = np.arange(tl)[None, :]
    gxs = np.arange(nx)
    for li in range(n_lv):
        nc, ns, sx, upper = (int(v) for v in head[li, :4])
        coef = head[li, bk.BRICK_HDR:shared - bk.BRICK_OFFS].view(dt)
        offs = head[li, shared - bk.BRICK_OFFS:]
        half = bk.BRICK_OFFS // 2
        assert (nc, ns) == (len(B.const_cross[li]), len(B.const_self[li]))
        for b, (ey, ez, buf, rowid, fin, accl) in enumerate(bricks):
            pt = parts[b, li]
            K = (ey // sy) * (ez // sz)
            place, row = pt[0:2 * K:2], pt[1:2 * K:2]
            # the level's frame lines, from global x
            n_fr = pt[2 * kmax]
            for fp, fr in pt[2 * kmax + 2:2 * kmax + 2 + 2 * n_fr].reshape(
                    -1, 2):
                st = stamp[fr + gxs]
                assert ((st >= 0) & (st < li)).all(), "halo unwritten"
                buf[fp + gxs], rowid[fp + gxs] = X[fr + gxs], fr + gxs
                fin[fp + gxs] = st
            gy, gz = (row // nx) % ny, row // (nx * ny)
            dstage = np.full((K, nx), np.nan, dt)
            for j in range(-(-K // lb)):
                k = ty + lb * j
                kk = np.where(k < K, k, 0)
                for i in range(-(-nx // tl)):
                    gx = tx + tl * i
                    on = (k < K) & (gx < nx)
                    g0 = np.where(gx < nx, gx, 0)
                    pos = place[kk] + g0
                    r = row[kk] + g0
                    # acc starts from the staged y, untouched since
                    assert (rowid[pos[on]] == r[on]).all()
                    assert (accl[pos[on]] == -1).all()
                    assert (fin[pos[on]] == -1).all()
                    acc = buf[pos]
                    if drows is not None:
                        dstage[np.broadcast_to(kk, on.shape)[on],
                               np.broadcast_to(g0, on.shape)[on]] = drows[
                                   r[on]]
                    edge = np.zeros(on.shape, bool)
                    for l, (_c, dx, dy, dz) in enumerate(B.const_cross[li]):
                        qy, qz = gy[kk] + dy, gz[kk] + dz
                        ingrid = ((g0 + dx >= 0) & (g0 + dx < nx)
                                  & (qy >= 0) & (qy < ny) & (qz >= 0)
                                  & (qz < nz))
                        src = np.where(on, pos + offs[l], 0)
                        want = r + dx + nx * (dy + ny * dz)
                        got = on & ingrid
                        assert (rowid[src[got]] == want[got]).all()
                        st = fin[src[got]]
                        assert ((st >= 0) & (st < li)).all(), "unsolved"
                        # outside the grid: the never-written zero
                        assert (fin[src[on & ~ingrid]] == -2).all()
                        edge |= ~ingrid
                        core = ((qy >= (b % nby) * by)
                                & (qy < (b % nby) * by + ey)
                                & (qz >= (b // nby) * bz)
                                & (qz < (b // nby) * bz + ez))
                        counts["shared reads"] += int((got & core).sum())
                        counts["halo reads"] += int((got & ~core).sum())
                        acc = acc - coef[l] * buf[src]
                    counts["interior rows"] += int((on & ~edge).sum())
                    counts["edge rows"] += int((on & edge).sum())
                    buf[pos[on]] = acc[on]
                    accl[pos[on]] = li
            for step in range(sx):
                p = sx - 1 - step if upper else step
                solved = 0
                for l in range(ns):
                    q = (p + offs[half + l]) % sx
                    if (q > p) if upper else (q < p):
                        solved |= 1 << l
                for j in range(-(-K // lb)):
                    k = ty + lb * j
                    kk = np.where(k < K, k, 0)
                    for i in range(-(-nx // (sx * tl))):
                        gx = p + sx * (tx + tl * i)
                        on = (k < K) & (gx < nx)
                        g0 = np.where(gx < nx, gx, p)
                        pos = place[kk] + g0
                        assert (accl[pos[on]] == li).all()
                        assert (fin[pos[on]] < li).all()
                        v = buf[pos]
                        for l in range(ns):
                            if not solved >> l & 1:
                                continue
                            # no bounds test: outside the line, the zero
                            # of its x margin
                            px = g0 + offs[half + l]
                            src = place[kk] + px
                            inl = on & (px >= 0) & (px < nx)
                            assert (fin[src[inl]] == li).all()
                            assert (rowid[src[inl]]
                                    == (row[kk] + px)[inl]).all()
                            assert (fin[src[on & ~inl]] == -2).all()
                            counts["margin reads"] += int((on & ~inl).sum())
                            v = v - coef[bk.BRICK_COEF // 2 + l] * buf[
                                np.where(on, src, 0)]
                        r = row[kk] + g0
                        d = (dstage[np.broadcast_to(kk, on.shape),
                                    np.broadcast_to(g0, on.shape)]
                             if drows is not None else coef[-1])
                        v = v * d
                        buf[pos[on]] = v[on]
                        fin[pos[on]] = li
                        X[r[on]] = v[on]
                        stamp[r[on]] = li
    assert (stamp >= 0).all(), "a row was never written"
    return X, counts


def _np(t):
    return None if t is None else t.numpy()


def _solve_both(B, shape, y, x, inplace):
    got, counts = _emulate_brick(B, bk.brick_tables(B, shape, y.itemsize),
                                 shape, y, x, _np(B.dinv_rows), inplace)
    yt = torch.from_numpy(y.copy())
    xt = yt if inplace else torch.from_numpy(x.copy())
    ref = bk.super_solve_mega_plain(B, yt, xt).numpy()
    np.testing.assert_array_equal(got, ref)
    return counts


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("case,sms", CASES, ids=[c for c, _ in CASES])
def test_brick_route_emulation_matches_plain(case, sms, dtype):
    """L and U of the pair, apart and in place: the emulated brick route
    bit-equal to super_solve_mega_plain on brick_shape's bricks and block
    for a card of `sms` SMs, and on the same bricks with a small block
    (several thread passes a line and a level); the reads go to shared
    memory and to the halo, rows take both paths."""
    g = np.random.default_rng(17)
    np_dt = bk._np_dtype(dtype)
    item = np_dt(0).itemsize
    for B in _pair(case, dtype):
        assert B.is_const and B.fused
        assert (B.dinv_rows is not None) == (case != "hpcg16-const")
        nx, ny, nz, _sx, sy, sz = B.spec_params
        shape = bk.brick_shape(B, item, sms, SMEM)
        by, bz = shape[:2]
        assert bk.brick_count(B, shape) <= sms
        assert by % sy == 0 and bz % sz == 0
        assert bk.brick_count(B, shape) > 1
        if case == "hpcg16-const" or case == "fdm32-const":
            # an uneven last brick along z (hpcg) or y (fdm, nz = 1)
            assert (nz % bz if nz > 1 else ny % by) != 0
        if case == "fdm32-const":
            assert nz == 1 and bz == 1 and sz == 1
        total = collections.Counter()
        for blk in (shape, (by, bz, 8, 4)):
            for inplace in (False, True):
                y = g.standard_normal(B.n_rows).astype(np_dt)
                x = g.standard_normal(B.n_rows).astype(np_dt)
                total += _solve_both(B, blk, y, x, inplace)
        for what in ("shared reads", "halo reads", "interior rows",
                     "edge rows", "margin reads"):
            assert total[what] > 0, what


def test_stamps_catch_a_read_too_early():
    """The emulation's checks fire: with every level's frame list emptied
    the levels of L read places no copy filled; with the levels of L
    reversed they read rows no level has written."""
    (L, _U) = _pair("hpcg16-const", torch.float64)
    shape = bk.brick_shape(L, 8, 6, SMEM)
    y = np.random.default_rng(1).standard_normal(L.n_rows)
    tables = bk.brick_tables(L, shape, 8)
    shared, part = bk.brick_parts(8, *shape[:2], *bk._brick_frame(L)[1:],
                                  *L.spec_params[4:])
    kmax = (shape[0] // 2) * (shape[1] // 2)
    bare = tables.copy()
    parts = bare[len(L.levels) * shared:].reshape(-1, len(L.levels), part)
    assert parts[:, :, 2 * kmax].any()
    parts[:, :, 2 * kmax] = 0
    with pytest.raises(AssertionError):
        _emulate_brick(L, bare, shape, y, y.copy(), None, False)
    flipped = dataclasses.replace(L, levels=L.levels[::-1],
                                  const_cross=L.const_cross[::-1],
                                  const_self=L.const_self[::-1], _args={})
    with pytest.raises(AssertionError, match="unsolved|halo unwritten"):
        _emulate_brick(flipped, bk.brick_tables(flipped, shape, 8), shape, y,
                       y.copy(), None, False)


def _geometry(nx, ny, nz, sy, sz, dtype=torch.float32):
    """A const pair's metadata on an (nx, ny, nz) grid under the strides
    (2, sy, sz): sy·sz levels with cross legs reaching one line along y
    and, on a 3-D grid, along z; nothing on any device; enough for the
    picker, which reads shapes only."""
    S = sy * sz
    m = nx * ny * nz // S
    cross = ((1.0, 1, -1, 0),) + (((1.0, -1, 0, -1),) if nz > 1 else ())
    levels = tuple((sb, ((0, 0),) * len(cross), (-1, 1)) for sb in range(S))
    return bk.SuperBlockTriSolve(
        n_rows=S * m, S=S, m=m, sx=2, levels=levels, upper=False,
        spec_params=(nx, ny, nz, 2, sy, sz), dtype=dtype,
        reach=(1, 1, int(nz > 1)), const_cross=(cross,) * S,
        const_self=(((1.0, -1), (1.0, 1)),) * S, dinv=0.25)


@pytest.mark.parametrize("geom,item,shape", [
    ((128, 128, 128, 2, 2), 4, (16, 8, 32, 16)),     # HPCG, Anderson 128³
    ((128, 128, 128, 2, 2), 8, (16, 8, 32, 16)),
    ((2048, 2048, 1, 2, 1), 4, (16, 1, 64, 8)),      # fdm:2048
    ((2048, 2048, 1, 2, 1), 8, None),                # 33.6 MB of x
    ((384, 384, 384, 2, 2), 4, None),                # 226 MB of x
    ((384, 384, 384, 2, 2), 8, None)])
def test_brick_shape_rule(geom, item, shape):
    """brick_shape on a card of 132 SMs and 227 KB a block: the bricks
    and block, None where the solve's x does not fit; the bricks stay in
    one wave, within the block's shared memory (with a per-row D too:
    Anderson 128³ and fdm:2048's U) and the kernel's threads."""
    B = _geometry(*geom)
    assert bk._brick_frame(B) == (1, 1, int(geom[2] > 1))   # self dx ±1
    got = bk.brick_shape(B, item, SMS, SMEM)
    assert got == shape
    if got is not None:
        by, bz, tl, lb = got
        nx, ny, nz, _sx, sy, sz = B.spec_params
        assert bk.brick_count(B, got) <= SMS
        for drows in (False, True):
            assert bk.brick_smem(len(B.levels), by, bz,
                                 *bk._brick_frame(B), sy, sz, nx, item,
                                 drows) <= SMEM
        assert tl * lb <= bk.BRICK_THREADS
        assert lb <= (by // sy) * (bz // sz)


@pytest.fixture
def card(monkeypatch):
    """A card of 132 SMs and 227 KB a block holding one brick block an SM
    (the kernel's design point), with no library: the picker's queries
    answered from the shape alone."""
    asked = []
    monkeypatch.setattr(bk, "_brick_card", lambda index: (SMS, SMEM))

    def resident(index, itemsize, threads, smem):
        asked.append((itemsize, threads, smem))
        assert threads <= bk.BRICK_THREADS and smem <= SMEM
        return SMS

    monkeypatch.setattr(bk, "_brick_resident", resident)
    return asked


@pytest.mark.parametrize("geom,item,route", [
    ((128, 128, 128, 2, 2), 4, "brick"),
    ((128, 128, 128, 2, 2), 8, "brick"),
    ((2048, 2048, 1, 2, 1), 4, "brick"),
    ((2048, 2048, 1, 2, 1), 8, "direct"),
    ((384, 384, 384, 2, 2), 4, "direct"),
    ((384, 384, 384, 2, 2), 8, "direct")])
def test_mega_route_for(geom, item, route, card):
    """mega_route_for: "brick" where the shape has bricks that fit on the
    card at once, else "direct"; worked out once per type and card and
    kept with the launch tables, with the brick shape."""
    B = _geometry(*geom)
    dev = torch.device("cuda", 0)
    for _ in range(2):
        assert bk.mega_route_for(B, item, dev) == route
    assert B._args[("mega_route", item, 0)] == route
    assert B._args[("brick_shape", item, 0)] == bk.brick_shape(
        B, item, SMS, SMEM)
    assert len(card) == (1 if route == "brick" else 0)


def test_mega_route_needs_a_cooperative_card(monkeypatch):
    """A card that cannot launch the bricks cooperatively (0 resident)
    takes the direct route; so does a solve that is not fused const."""
    monkeypatch.setattr(bk, "_brick_card", lambda index: (SMS, SMEM))
    monkeypatch.setattr(bk, "_brick_resident", lambda *a: 0)
    dev = torch.device("cuda", 0)
    assert bk.mega_route_for(_geometry(128, 128, 128, 2, 2), 4,
                             dev) == "direct"
    monkeypatch.setattr(bk, "_brick_resident", lambda *a: SMS)
    split = _geometry(128, 128, 128, 2, 2)
    split.fused = False
    assert bk.mega_route_for(split, 4, dev) == "direct"
    assert bk.mega_route_for(_geometry(128, 128, 128, 2, 2), 4,
                             dev) == "brick"


def test_cpu_tensor_takes_the_plain_loop(card):
    """A CPU tensor takes the plain loop whatever route is cached: no
    counter moves."""
    L, U = _pair("hpcg16-const", torch.float64)
    g = np.random.default_rng(4)
    for B in (L, U):
        B._args[("mega_route", 8, 0)] = "brick"
        y = torch.from_numpy(g.standard_normal(B.n_rows))
        before = (bk.super_solve_mega.launches,
                  bk.super_solve_mega.brick_launches,
                  bk.super_solve_mega.direct_launches)
        got = bk.super_solve_mega(B, y, torch.empty_like(y))
        assert torch.equal(got, bk.super_solve_mega_plain(
            B, y, torch.empty_like(y)))
        assert (bk.super_solve_mega.launches,
                bk.super_solve_mega.brick_launches,
                bk.super_solve_mega.direct_launches) == before
