"""The port's rank-space triangular solves (kernel #8's plain version and
the solves around it) against the JAX package's BlockedTriSolve: the
planes, diagonals and level metadata of the builder, the block permute,
one level, whole GS, SGS and ILU(0) solves (float64 against the XLA form),
and the level against the Pallas kernel in interpret mode (float32).

The plain level rolls x like the JAX package's _level_xla; the kernel
reads a zero where the roll wraps.  A wrapped slot always meets a zero
value, so the two agree for finite x.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import basic_iterative_solvers_tpu as bis
from basic_iterative_solvers_tpu.ops import block_trisolve as jbt
from basic_iterative_solvers_tpu.ops import pallas_env

from basic_iterative_solvers_tpu_torch import coloring as tcol
from basic_iterative_solvers_tpu_torch import convert
from basic_iterative_solvers_tpu_torch import factor as tfac
from basic_iterative_solvers_tpu_torch import generators as tgen
from basic_iterative_solvers_tpu_torch.ops import block_trisolve as tbt
from tests.test_torch_ilu0_factor import numpy_branch  # noqa: F401

CPU = "cpu"
BANDS = ["band:900,2", "band:61,2", "band:500,3"]


def _setup(spec):
    A = tgen.from_source(spec)
    Aj = bis.generators.from_source(spec)
    sj = bis.generators.color_spec_for_source(spec)
    st = tcol.ColorSpec(sj.kind, sj.n_colors, sj.params)
    colors = tcol.spec_colors_np(st, A.n_rows)
    return A, Aj, st, sj, colors


def _pair(spec, dtype, np_dtype, triplets=False):
    """(port L, port U, JAX L, JAX U): the SGS pair of A (or the coloured
    ILU(0) pair from its factor triplets)."""
    A, Aj, st, sj, colors = _setup(spec)
    if triplets:
        rows, cols, vals, U_D = tfac.factor_ilu0_colored_triplets(A, colors)
        T, D_L, D_U, need_d = (rows, cols, vals, A.n_rows), None, U_D, False
    else:
        T, D_L, D_U, need_d = A, A.diagonal(), A.diagonal(), True
    Lt, Ut = tbt.build_best_trisolve_pair(T, D_L, D_U, colors, st,
                                          dtype=dtype, need_d=need_d,
                                          device=CPU)
    Tj = Aj if not triplets else T
    Lj, Uj = jbt.build_best_trisolve_pair(Tj, D_L, D_U, colors, sj,
                                          dtype=np_dtype, need_d=need_d)
    return Lt, Ut, Lj, Uj


def _stack(blocks):
    return np.stack([np.asarray(b).reshape(-1) for b in blocks])


@pytest.mark.parametrize("triplets", [False, True], ids=["sgs", "ilu0"])
@pytest.mark.parametrize("spec", BANDS)
def test_builder_equal(spec, triplets, numpy_branch):  # noqa: F811
    """Planes, dinv, d, m, R_b and the level tables equal the JAX
    package's."""
    for Bt, Bj in zip(*(lambda p: (p[:2], p[2:]))(
            _pair(spec, torch.float64, np.float64, triplets))):
        assert isinstance(Bt, tbt.BlockedTriSolve)
        for f in ("n_rows", "n_colors", "m", "R_b", "spec_kind",
                  "spec_params"):
            assert getattr(Bt, f) == getattr(Bj, f), f
        assert Bt.levels == Bj.levels
        np.testing.assert_array_equal(Bt.vals.numpy(), _stack(Bj.vals))
        np.testing.assert_array_equal(Bt.dinv.numpy(), _stack(Bj.dinv))
        assert (Bt.d is None) == (Bj.d is None)
        if Bt.d is not None:
            np.testing.assert_array_equal(Bt.d.numpy(), _stack(Bj.d))


@pytest.mark.parametrize("spec", BANDS)
def test_permute_blocks_equal(spec, rng):
    Lt, _Ut, Lj, _Uj = _pair(spec, torch.float64, np.float64)
    y = rng.standard_normal(Lt.n_rows)
    Yt = tbt.permute_blocks(Lt, torch.from_numpy(y))
    np.testing.assert_array_equal(Yt.numpy(),
                                  _stack(jbt.permute_blocks(Lj,
                                                            jnp.asarray(y))))
    assert torch.equal(tbt.unpermute_blocks(Lt, Yt), torch.from_numpy(y))


@pytest.mark.parametrize("spec", BANDS)
def test_plain_level_matches_xla(spec, rng):
    """Every level with groups, from random y and x: the plain level
    against the JAX package's _level_xla, float64, rtol 1e-14."""
    for Bt, Bj in zip(*(lambda p: (p[:2], p[2:]))(
            _pair(spec, torch.float64, np.float64))):
        Y = rng.standard_normal((Bt.n_colors, Bt.M))
        X = rng.standard_normal((Bt.n_colors, Bt.M))
        xb = [jnp.asarray(X[c].reshape(Bj.R_b, 128))
              for c in range(Bt.n_colors)]
        for li, (c, groups) in enumerate(Bt.levels):
            if not groups:
                continue
            Xt = tbt.rank_level(Bt, li, torch.from_numpy(Y),
                                torch.from_numpy(X.copy()))
            ref = np.asarray(jbt._level_xla(
                Bj, groups, jnp.asarray(Y[c].reshape(Bj.R_b, 128)),
                Bj.dinv[c], xb)).reshape(-1)
            np.testing.assert_allclose(Xt[c].numpy(), ref, rtol=1e-14,
                                       atol=1e-14 * np.abs(ref).max())
            others = [k for k in range(Bt.n_colors) if k != c]
            np.testing.assert_array_equal(Xt[others].numpy(), X[others])


@pytest.mark.parametrize("triplets", [False, True], ids=["sgs", "ilu0"])
@pytest.mark.parametrize("spec", BANDS)
def test_whole_solves_match_xla(spec, triplets, rng):
    """blocked_trisolve of both triangles, and blocked_sgs or blocked_ilu0
    of the pair, against the JAX package's XLA form, float64, rtol
    1e-14."""
    Lt, Ut, Lj, Uj = _pair(spec, torch.float64, np.float64, triplets)
    y = rng.standard_normal(Lt.n_rows)
    yt, yj = torch.from_numpy(y), jnp.asarray(y)
    pairs = [(tbt.blocked_trisolve(Lt, yt),
              jbt.blocked_trisolve(Lj, yj, use_pallas=False)),
             (tbt.blocked_trisolve(Ut, yt),
              jbt.blocked_trisolve(Uj, yj, use_pallas=False))]
    if triplets:
        pairs.append((tbt.blocked_ilu0(Lt, Ut, yt),
                      jbt.blocked_ilu0(Lj, Uj, yj, use_pallas=False)))
    else:
        pairs.append((tbt.blocked_sgs(Lt, Ut, yt),
                      jbt.blocked_sgs(Lj, Uj, yj, use_pallas=False)))
    for got, ref in pairs:
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-14,
                                   atol=1e-14 * np.abs(ref).max())


def test_gs_solve_is_the_coloured_sweep(rng):
    """The rank-space L solve is the exact GS solve of the colour-sorted
    ordering: the masked colour sweep of the DIA operator from zero."""
    from basic_iterative_solvers_tpu_torch import device_matrix as tdm
    A, _Aj, st, _sj, colors = _setup("band:900,2")
    Lt, Ut, _Lj, _Uj = _pair("band:900,2", torch.float64, np.float64)
    D = torch.from_numpy(A.diagonal())
    Ad = tdm.csr_to_dia(A, torch.float64, device=CPU)
    y = torch.from_numpy(rng.standard_normal(A.n_rows))
    for B, rev in ((Lt, False), (Ut, True)):
        z = tcol.colored_sweep(Ad, 1.0 / D, y, None, st, st.n_colors,
                               reverse=rev)
        torch.testing.assert_close(tbt.blocked_trisolve(B, y), z,
                                   rtol=1e-13, atol=1e-13)


@pytest.fixture
def interpret():
    pallas_env.INTERPRET = True
    try:
        yield
    finally:
        pallas_env.INTERPRET = False


@pytest.mark.parametrize("spec", ["band:900,2", "band:500,3"])
def test_plain_matches_pallas_interpret(spec, interpret, rng):
    """The port's plain solves against the JAX package's Pallas level
    kernel in interpret mode, float32 (tests/test_pallas_interpret.py's
    rtol 2e-5, atol 1e-5), the pair carried across with
    blocked_trisolve_from_numpy."""
    _Lt, _Ut, Lj, Uj = _pair(spec, torch.float32, np.float32)
    y = rng.standard_normal(Lj.n_rows).astype(np.float32)
    for Bj in (Lj, Uj):
        Bt = convert.blocked_trisolve_from_numpy(
            [np.asarray(v) for v in Bj.vals], [np.asarray(v) for v in Bj.dinv],
            None if Bj.d is None else [np.asarray(v) for v in Bj.d],
            Bj.n_rows, Bj.n_colors, Bj.m, Bj.R_b, Bj.levels,
            Bj.spec_kind, Bj.spec_params, dtype=torch.float32, device=CPU)
        yk = np.asarray(jbt.blocked_trisolve(Bj, jnp.asarray(y),
                                             use_pallas=True))
        yt = tbt.blocked_trisolve(Bt, torch.from_numpy(y)).numpy()
        np.testing.assert_allclose(yt, yk, rtol=2e-5, atol=1e-5)


def test_cpu_launches_nothing_and_refusals(numpy_branch):  # noqa: F811
    """CPU tensors launch no kernel; under a grid colouring
    build_blocked_trisolve builds the grid rank-space form and
    build_best_trisolve_pair the superblock pair, each equal to the JAX
    package's; an improper colouring raises ImproperColoringError; a zero
    diagonal raises."""
    A, _Aj, st, _sj, colors = _setup("band:61,2")
    L, U = tbt.build_best_trisolve_pair(A, A.diagonal(), A.diagonal(),
                                        colors, st, dtype=torch.float64,
                                        need_d=True, device=CPU)
    tbt.rank_level.launches = 0
    tbt.blocked_sgs(L, U, torch.ones(A.n_rows, dtype=torch.float64))
    assert tbt.rank_level.launches == 0
    H = tgen.from_source("hpcg:4x4x4")
    Hj = bis.generators.from_source("hpcg:4x4x4")
    grid = tgen.color_spec_for_source("hpcg:4x4x4")
    gj = bis.generators.color_spec_for_source("hpcg:4x4x4")
    gc = tcol.spec_colors_np(grid, H.n_rows)
    Bt = tbt.build_blocked_trisolve(H, H.diagonal(), gc, grid, upper=False,
                                    dtype=torch.float64, device=CPU)
    Bj = jbt.build_blocked_trisolve(Hj, H.diagonal(), gc, gj, upper=False,
                                    dtype=np.float64)
    assert (Bt.spec_kind, Bt.m, Bt.levels) == ("grid", 8, Bj.levels)
    np.testing.assert_array_equal(Bt.vals.numpy(), _stack(Bj.vals))
    pt = tbt.build_best_trisolve_pair(H, H.diagonal(), H.diagonal(), gc,
                                      grid, dtype=torch.float64, device=CPU)
    pj = jbt.build_best_trisolve_pair(Hj, H.diagonal(), H.diagonal(), gc,
                                      gj, dtype=np.float64)
    for St, Sj in zip(pt, pj):
        assert isinstance(St, tbt.SuperBlockTriSolve)
        assert (St.levels, St.is_const) == (Sj.levels, Sj.is_const)
        assert (St.const_cross or None) == Sj.const_cross
    two = tcol.ColorSpec("mod", 2, (2,))
    with pytest.raises(tbt.ImproperColoringError):
        tbt.build_blocked_trisolve(A, A.diagonal(), tcol.spec_colors_np(
            two, A.n_rows), two, upper=False, device=CPU)
    D0 = A.diagonal().copy()
    D0[3] = 0.0
    with pytest.raises(ValueError, match="zero diagonal"):
        tbt.build_blocked_trisolve(A, D0, colors, st, upper=False,
                                   device=CPU)
