"""Kernel #8's "vec" route (csrc/block_trisolve.cu: rank_level_vec_kernel)
emulated thread by thread in NumPy from its launch table
(`rank_windows`) and its launch shape (`rank_vec_shape`), held bit for
bit against the plain level (`rank_level_plain`) and the scalar route's
arithmetic; and the route picker's rule.

The kernel cannot run here.  Each chunk of 16 bytes of slots is an array
lane: its y, value planes and dinv as vectors, one window of aligned x
vectors a source colour (zeros outside [0, M)), each group's values
picked from the window at its shift, products and differences rounded
one at a time in the working dtype, in the level's group order.
"""
import dataclasses

import numpy as np
import pytest
import torch

from basic_iterative_solvers_tpu_torch import coloring as tcol
from basic_iterative_solvers_tpu_torch import generators as tgen
from basic_iterative_solvers_tpu_torch.ops import block_trisolve as tbt

CPU = "cpu"


def _pair(spec, dtype, mod=None):
    """The SGS pair of A under its source's colouring, or a mod colouring
    of `mod` colours (a 2-D grid under mod: |Δ| beyond a vector)."""
    A = tgen.from_source(spec)
    cs = (tgen.color_spec_for_source(spec) if mod is None
          else tcol.ColorSpec("mod", mod, (mod,)))
    colors = tcol.spec_colors_np(cs, A.n_rows)
    return tbt.build_best_trisolve_pair(A, A.diagonal(), A.diagonal(),
                                        colors, cs, dtype=dtype,
                                        need_d=True, device=CPU)


def emulate_vec(B, li, Y, X, sms=132):
    """The vec route's launch of level li, block by block, thread by
    thread (a thread's chunks in turn), in place on X (Y may be X)."""
    c, groups = B.levels[li]
    item = X.itemsize
    vec = 16 // item
    table = tbt.rank_windows(groups, vec)
    threads, cpt = tbt.rank_vec_shape(B.M, item, sms)
    M = B.M
    chunks = M // vec
    vals, dinv = B.vals.numpy(), B.dinv.numpy()
    W = tbt.RANK_VEC_WIN * vec
    lanes = np.arange(vec)
    for b in range(-(-chunks // (threads * cpt))):
        for j in range(cpt):
            k = b * threads * cpt + j * threads + np.arange(threads)
            k = k[k < chunks]
            t = (k * vec)[:, None] + lanes
            acc = Y[c][t].copy()                 # y before x
            w = np.zeros((k.size, W), X.dtype)
            for plane, src, base, nvec, shift in table:
                if src >= 0:
                    assert src != c
                    w[:] = 0
                    for q in range(tbt.RANK_VEC_WIN):
                        s0 = k * vec + (base + q) * vec
                        ok = (q < nvec) & (s0 >= 0) & (s0 < M)
                        w[ok, q * vec:(q + 1) * vec] = X[src][
                            s0[ok][:, None] + lanes]
                assert 0 <= shift <= W - vec
                acc = acc - vals[plane][t] * w[:, shift:shift + vec]
            X[c][t] = acc * dinv[c][t]
    return X


def emulate_scalar(B, li, Y, X):
    """The scalar route: a thread a slot, a source outside [0, M) read as
    0."""
    c, groups = B.levels[li]
    M = B.M
    t = np.arange(M)
    acc = Y[c].copy()
    for sc, delta, g in groups:
        s = t + delta
        ok = (s >= 0) & (s < M)
        xv = np.zeros(M, X.dtype)
        xv[ok] = X[sc][s[ok]]
        acc = acc - B.vals[g].numpy() * xv
    X[c] = acc * B.dinv[c].numpy()
    return X


CASES = [("band:900,2", None), ("band:500,3", None), ("fdm:16", 3),
         ("fdm:23", 4)]


@pytest.mark.parametrize("alias", [False, True], ids=["y", "y_is_x"])
@pytest.mark.parametrize("dt,np_dt", [(torch.float32, np.float32),
                                      (torch.float64, np.float64)])
@pytest.mark.parametrize("spec,mod", CASES)
def test_vec_route_equals_plain(spec, mod, dt, np_dt, alias):
    """Every level with groups, on the vec route (emulated), equals the
    plain level and the scalar route bit for bit, with y a separate
    tensor or x itself (the U solve in place), on bands and on a 2-D grid
    under a mod colouring whose Δ reach past a vector (windows split in
    float64); the picker names vec for levels of at most 8 groups (2 in
    float64)."""
    rng = np.random.default_rng(3)
    most = 2 if dt == torch.float64 else 8
    for B in _pair(spec, dt, mod):
        for li, (c, groups) in enumerate(B.levels):
            if not groups:
                continue
            assert tbt.rank_route_for(B, li) == (
                "vec" if len(groups) <= most else "scalar")
            X0 = rng.standard_normal((B.n_colors, B.M)).astype(np_dt)
            Y0 = X0 if alias else rng.standard_normal(X0.shape).astype(np_dt)
            Xv = X0.copy()
            Yv = Xv if alias else Y0.copy()
            emulate_vec(B, li, Yv, Xv)
            Xs = X0.copy()
            emulate_scalar(B, li, Xs if alias else Y0.copy(), Xs)
            Xp = torch.from_numpy(X0.copy())
            tbt.rank_level_plain(B, li, Xp if alias else
                                 torch.from_numpy(Y0.copy()), Xp)
            np.testing.assert_array_equal(Xv, Xs)
            np.testing.assert_array_equal(Xv, Xp.numpy())


def test_vec_route_splits_windows_and_levels_beyond_the_bucket():
    """A source whose Δ span more than RANK_VEC_WIN vectors opens a second
    window (fdm:16 under mod 3 in float64: Δ −5 and 0), and a level of
    more groups than the largest bucket (band:500,8 under its mod-9
    colouring) takes the scalar route, whose emulation equals plain."""
    L, _U = _pair("fdm:16", torch.float64, 3)
    opened = [sum(w[1] >= 0 for w in tbt.rank_windows(g, 2))
              for _c, g in L.levels if g]
    srcs = [len({sc for sc, _d, _g in g}) for _c, g in L.levels if g]
    assert any(o > s for o, s in zip(opened, srcs))
    rng = np.random.default_rng(4)
    seen = 0
    for B in _pair("band:500,8", torch.float32):
        for li, (c, groups) in enumerate(B.levels):
            if len(groups) <= tbt.RANK_VEC_BUCKETS[-1]:
                continue
            seen += 1
            assert tbt.rank_route_for(B, li) == "scalar"
            X0 = rng.standard_normal((B.n_colors, B.M)).astype(np.float32)
            Xs = X0.copy()
            emulate_scalar(B, li, X0.copy(), Xs)
            Xp = torch.from_numpy(X0.copy())
            tbt.rank_level_plain(B, li, torch.from_numpy(X0.copy()), Xp)
            np.testing.assert_array_equal(Xs, Xp.numpy())
    assert seen


def test_rank_route_rule():
    """The picker: "vec" only for 1..8 groups (1..2 in float64), no
    source of the level's own colour, M and every pointer on 16 bytes; a
    call whose Y or X
    starts off 16 bytes takes "scalar", the level's own route stays kept
    with its launch table."""
    g2 = ((0, -1, 0), (0, 0, 1))
    g4 = g2 + ((2, -1, 2), (2, 0, 3))
    assert tbt._rank_rule(g2, 1, 1024, 4) == "vec"
    assert tbt._rank_rule(g2, 1, 1024, 8) == "vec"
    assert tbt._rank_rule(g4, 1, 1024, 4) == "vec"
    assert tbt._rank_rule(g4, 1, 1024, 8) == "scalar"      # f64: 2 groups
    assert tbt._rank_rule(g2, 1, 1001, 4) == "scalar"      # M off 16 bytes
    assert tbt._rank_rule(g2, 1, 1026, 8) == "vec"         # 2 doubles
    assert tbt._rank_rule(g2, 1, 1025, 8) == "scalar"
    assert tbt._rank_rule(g2, 0, 1024, 4) == "scalar"      # src == c
    assert tbt._rank_rule(g2, 1, 1024, 4, (64, 72)) == "scalar"
    assert tbt._rank_rule((), 1, 1024, 4) == "scalar"
    nine = tuple((s, 0, s) for s in range(2, 11))
    assert tbt._rank_rule(nine[:8], 1, 1024, 4) == "vec"
    assert tbt._rank_rule(nine, 1, 1024, 4) == "scalar"
    L, _U = _pair("band:900,2", torch.float32)
    li = next(i for i, (_c, g) in enumerate(L.levels) if g)
    store = torch.zeros(L.n_colors * L.M + 1)
    Y = store[1:].view(L.n_colors, L.M)                    # off 16 bytes
    X = torch.zeros(L.n_colors, L.M)
    assert tbt.rank_route_for(L, li, Y, X) == "scalar"
    assert tbt.rank_route_for(L, li, X, X) == "vec"
    assert tbt._rank_table(L, li, X.device)[0] == "vec"
    # misaligned value planes: the level itself takes the scalar route
    Lm = dataclasses.replace(
        L, vals=torch.zeros(L.vals.numel() + 1)[1:].view_as(L.vals),
        _tables={})
    assert tbt.rank_route_for(Lm, li) == "scalar"


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("M", [1024, 10240, 2796544, 8 * 2 ** 20])
def test_rank_vec_shape_covers_every_chunk_once(M, itemsize):
    """The launch covers the M·itemsize/16 chunks exactly once (no empty
    block), and cpt minimises waves of resident blocks × cpt, the least
    on a tie."""
    for sms in (132, 1):
        threads, cpt = tbt.rank_vec_shape(M, itemsize, sms)
        assert threads % 32 == 0 and threads <= tbt.RANK_VEC_THREADS
        chunks = M * itemsize // 16
        per = threads * cpt
        grid = -(-chunks // per)
        assert (grid - 1) * per < chunks <= grid * per
        wave = tbt.RANK_VEC_RESIDENT * sms
        cost = [-(-(-(-chunks // (threads * k))) // wave) * k
                for k in range(1, 9)]
        assert cost[cpt - 1] == min(cost) and cost.index(min(cost)) == cpt - 1


@pytest.mark.parametrize("vec", [2, 4])
def test_rank_windows_cover_every_group(vec):
    """Each group's source slots t + Δ .. t + Δ + vec − 1 lie in its
    window at lanes shift .. shift + vec − 1, the window within
    RANK_VEC_WIN vectors, windows opened in the level's order."""
    groups = ((0, -5, 0), (0, -1, 1), (0, 0, 2), (0, 6, 3), (2, -9, 4),
              (2, 9, 5))
    table = tbt.rank_windows(groups, vec)
    assert [row[0] for row in table] == [g for _s, _d, g in groups]
    cur = None
    for (sc, delta, _g), (_p, src, base, nvec, shift) in zip(groups, table):
        if src >= 0:
            cur = (src, base, nvec)
            assert 1 <= nvec <= tbt.RANK_VEC_WIN
        assert cur[0] == sc
        assert vec * cur[1] + shift == delta
        assert 0 <= shift and shift + vec <= vec * cur[2]
