"""The port's superblock form built from host CSR against the JAX
package's NumPy branch (`numpy_branch`): the builder's levels, (src, Δ)
keys, self legs, detected mode, const coefficients, planes (the TPU's
R_b·128 padding stripped) and per-row diagonals bit for bit at float32 and
float64; the plane-mode plain level against the JAX package's XLA form
(float64, rtol 1e-14) and whole solves against its Pallas kernels in
interpret mode (float32, rtol 1e-5, atol 1e-6, as for the const and table
modes); the carry-across function; and the rank-space form under a grid
colouring, the fallback where the superblock form refuses (the lane rule
among its refusals).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import basic_iterative_solvers_tpu as bis
from basic_iterative_solvers_tpu import coloring as jcol
from basic_iterative_solvers_tpu.ops import block_trisolve as jbt
from basic_iterative_solvers_tpu.ops import pallas_env

import basic_iterative_solvers_tpu_torch as bt
from basic_iterative_solvers_tpu_torch import coloring as tcol
from basic_iterative_solvers_tpu_torch import convert
from basic_iterative_solvers_tpu_torch import factor as tfac
from basic_iterative_solvers_tpu_torch import matrix as tmat
from basic_iterative_solvers_tpu_torch import stencil_op as tso
from basic_iterative_solvers_tpu_torch.ops import block_trisolve as tbt
from tests.test_torch_ilu0_factor import numpy_branch  # noqa: F401

CPU = "cpu"
ANDERSON = "anderson:Lx=8,Ly=8,Lz=8,ranpot=4.0"
DTYPES = [(torch.float32, np.float32), (torch.float64, np.float64)]
#: (source, pair, the modes detected for L and U, BIS_SB_ALIGNED=0): the
#: ILU(0) U of a 5-point stencil keeps A's off-diagonals (no two
#: neighbours share a neighbour), so it is const mode with U's pivots per
#: row, in both packages and both dtypes
BUILDS = [("hpcg:8x8x8", "sgs", "const const", False),
          ("hpcg:6x4x8", "sgs", "plane plane", True),
          ("fdm:16", "ilu0", "plane const", False),
          ("hpcg:8x8x8", "ilu0", "plane plane", False),
          (ANDERSON, "sgs", "const const", False)]


@pytest.fixture
def interpret():
    pallas_env.INTERPRET = True
    try:
        yield
    finally:
        pallas_env.INTERPRET = False


def _specs(source):
    sj = bis.generators.color_spec_for_source(source)
    return sj, tcol.ColorSpec(sj.kind, sj.n_colors, sj.params)


def _csr(source):
    """The JAX package's CSR of `source` and the same as the port's."""
    Aj = bis.generators.from_source(source)
    At = tmat.MatrixCSR(Aj.n_rows, Aj.n_cols, Aj.nnz,
                        np.asarray(Aj.row_ptr).copy(),
                        np.asarray(Aj.col).copy(), np.asarray(Aj.val).copy())
    return Aj, At


def _pairs(source, kind, t_dt, np_dt):
    """((port L, U), (JAX L, U)): the SGS pair of the CSR (D on L), or the
    coloured ILU(0) pair from the colour-sorted factors' triplets, both
    packages through build_best_trisolve_pair (the JAX package's NumPy
    branch once its native CSR-direct path is off)."""
    Aj, At = _csr(source)
    sj, st = _specs(source)
    colors = tcol.spec_colors_np(st, At.n_rows)
    if kind == "sgs":
        D = At.diagonal()
        pt = tbt.build_best_trisolve_pair(At, D, D, colors, st, dtype=t_dt,
                                          need_d=True, device=CPU)
        pj = jbt.build_best_trisolve_pair(Aj, D, D, colors, sj, dtype=np_dt,
                                          need_d=True)
        return pt, pj
    rows, cols, vals, U_D = tfac.factor_ilu0_colored_triplets(At, colors)
    trip = (rows, cols, vals, At.n_rows)
    pt = tbt.build_best_trisolve_pair(trip, None, U_D, colors, st,
                                      dtype=t_dt, device=CPU)
    pj = jbt.build_best_trisolve_pair(trip, None, U_D, colors, sj,
                                      dtype=np_dt)
    return pt, pj


def _rows_of(B, blocks):
    """The JAX package's per-superblock (R_b, 128) blocks as per-row (n,)."""
    nx, ny, nz, sx, sy, sz = B.spec_params
    i = np.arange(B.n_rows)
    X, Y, Z = i % nx, (i // nx) % ny, i // (nx * ny)
    SB = (Y % sy) + sy * (Z % sz)
    SLOT = X + nx * ((Y // sy) + (ny // sy) * (Z // sz))
    return np.stack([np.asarray(b).reshape(-1) for b in blocks])[SB, SLOT]


def _carry(Bj, t_dt):
    return convert.superblock_from_numpy(
        Bj.vals_cross, Bj.vals_self, Bj.dinv, Bj.d, Bj.n_rows, Bj.S, Bj.m,
        Bj.sx, Bj.levels, Bj.upper, Bj.spec_params, Bj.fused,
        Bj.const_cross, Bj.const_self, dtype=t_dt, device=CPU)


@pytest.mark.parametrize("t_dt,np_dt", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("source,kind,mode,split", BUILDS,
                         ids=[f"{s}-{k}" for s, k, _m, _a in BUILDS])
def test_builder_matches_jax(source, kind, mode, split, t_dt, np_dt,
                             numpy_branch, monkeypatch):  # noqa: F811
    """Levels, keys, self legs, mode and const coefficients equal; planes
    and per-row diagonals equal bit for bit (padding stripped)."""
    if split:
        monkeypatch.setattr(jbt, "NO_ALIGNED", True)
        monkeypatch.setattr(tbt, "NO_ALIGNED", True)
    (Lt, Ut), (Lj, Uj) = _pairs(source, kind, t_dt, np_dt)
    for Bt, Bj, want in zip((Lt, Ut), (Lj, Uj), mode.split()):
        assert isinstance(Bj, jbt.SuperBlockTriSolve)
        assert Bt.levels == Bj.levels
        assert (Bt.n_rows, Bt.S, Bt.m, Bt.sx, Bt.upper, Bt.spec_params,
                Bt.fused) == (Bj.n_rows, Bj.S, Bj.m, Bj.sx, Bj.upper,
                              Bj.spec_params, Bj.fused)
        assert Bt.fused == (not split)
        assert Bt.is_const == Bj.is_const == (want == "const")
        assert Bt.is_plane == (want == "plane") and Bt.dtype == t_dt
        if Bt.is_const:
            assert Bt.const_cross == Bj.const_cross
            assert Bt.const_self == Bj.const_self
            assert Bt.dinv is None and Bt.d is None
        else:
            for vt, vj in zip(Bt.vals_cross + Bt.vals_self,
                              Bj.vals_cross + Bj.vals_self):
                assert (vt is None) == (vj is None)
                if vt is not None:
                    vj = np.asarray(vj)
                    np.testing.assert_array_equal(
                        vt.numpy(), vj.reshape(vj.shape[0], -1)[:, :Bt.m])
                    assert vt.dtype == t_dt
        np.testing.assert_array_equal(Bt.dinv_rows.numpy(),
                                      _rows_of(Bj, Bj.dinv))
        assert (Bt.d_rows is None) == (Bj.d is None)
        if Bt.d_rows is not None:
            np.testing.assert_array_equal(Bt.d_rows.numpy(),
                                          _rows_of(Bj, Bj.d))
    if source == ANDERSON:
        # constant legs, random diagonal: const mode with a per-row D
        assert len(set(Lt.dinv_rows.tolist())) > 1


@pytest.mark.parametrize("source", ["fdm:16", "hpcg:8x8x8"])
def test_plane_level_matches_xla(source, rng, numpy_branch):  # noqa: F811
    """Every level of the ILU(0) pair from random y and x: the plane-mode
    plain level against the JAX package's _super_level_xla, float64, rtol
    1e-14; the level writes its superblock's rows only."""
    (Lt, Ut), (Lj, Uj) = _pairs(source, "ilu0", torch.float64, np.float64)
    n = Lt.n_rows
    for Bt, Bj in ((Lt, Lj), (Ut, Uj)):
        y, x = rng.standard_normal(n), rng.standard_normal(n)
        yb = jbt._permute_super(Bj, jnp.asarray(y))
        xb = list(jbt._permute_super(Bj, jnp.asarray(x)))
        for li, (sb, _c, _s) in enumerate(Bt.levels):
            xt = tbt.super_level_plain(Bt, li, torch.from_numpy(y),
                                       torch.from_numpy(x.copy()))
            ref = np.asarray(jbt._super_level_xla(Bj, li, yb[sb], xb))
            ref = ref.reshape(-1)[:Bt.m]
            got = tbt._slots(Bt, xt, sb).reshape(-1).numpy()
            np.testing.assert_allclose(got, ref, rtol=1e-14,
                                       atol=1e-14 * np.abs(ref).max())
            mine = tbt._slots(Bt, torch.ones(n, dtype=torch.bool), sb)
            rows = torch.zeros(n, dtype=torch.bool)
            tbt._slots(Bt, rows, sb).copy_(mine)
            np.testing.assert_array_equal(xt[~rows].numpy(), x[~rows.numpy()])


def _applies(pkg, L, U, kind, y, **kw):
    if kind == "ilu0":
        both = pkg.blocked_ilu0(L, U, y, **kw)
    else:
        both = pkg.blocked_sgs(L, U, y, **kw)
    return [pkg.blocked_trisolve(L, y, **kw), pkg.blocked_trisolve(U, y, **kw),
            both]


@pytest.mark.parametrize("source,kind,mode,split", BUILDS,
                         ids=[f"{s}-{k}" for s, k, _m, _a in BUILDS])
def test_solves_match_xla_f64(source, kind, mode, split, rng, numpy_branch,
                              monkeypatch):  # noqa: F811
    """L, U and the pair's apply (ILU(0) or symmetric GS), float64, against
    the JAX package's XLA form: rtol 1e-14."""
    if split:
        monkeypatch.setattr(jbt, "NO_ALIGNED", True)
        monkeypatch.setattr(tbt, "NO_ALIGNED", True)
    (Lt, Ut), (Lj, Uj) = _pairs(source, kind, torch.float64, np.float64)
    y = rng.standard_normal(Lt.n_rows)
    got = _applies(tbt, Lt, Ut, kind, torch.from_numpy(y))
    ref = _applies(jbt, Lj, Uj, kind, jnp.asarray(y), use_pallas=False)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-14,
                                   atol=1e-14 * np.abs(r).max())


@pytest.mark.parametrize("source,kind,mode,split", BUILDS,
                         ids=[f"{s}-{k}" for s, k, _m, _a in BUILDS])
def test_solves_match_pallas_interpret(source, kind, mode, split, rng,
                                       interpret, numpy_branch,
                                       monkeypatch):  # noqa: F811
    """The same solves, float32, against the JAX package's Pallas kernels
    in interpret mode (_super_level_pallas, or _super_acc_pallas and
    _super_parity_pallas on the split route), which contract products and
    differences into fused multiply-adds: rtol 1e-5, atol 1e-6."""
    if split:
        monkeypatch.setattr(jbt, "NO_ALIGNED", True)
        monkeypatch.setattr(tbt, "NO_ALIGNED", True)
    (Lt, Ut), (Lj, Uj) = _pairs(source, kind, torch.float32, np.float32)
    y = rng.standard_normal(Lt.n_rows).astype(np.float32)
    got = _applies(tbt, Lt, Ut, kind, torch.from_numpy(y))
    ref = _applies(jbt, Lj, Uj, kind, jnp.asarray(y), use_pallas=True)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("source,kind", [("fdm:16", "ilu0"),
                                         (ANDERSON, "sgs")])
def test_carried_pair_applies_as_jax(source, kind, rng,
                                     numpy_branch):  # noqa: F811
    """A JAX pair built from CSR (plane mode; const mode with a per-row D)
    carried across with superblock_from_numpy: equal to the port's own
    build field for field, and its apply equal to the JAX package's XLA
    apply at rtol 1e-14 and to the port's own apply bit for bit."""
    (Lt, Ut), (Lj, Uj) = _pairs(source, kind, torch.float64, np.float64)
    Lc, Uc = _carry(Lj, torch.float64), _carry(Uj, torch.float64)
    for Bc, Bt in ((Lc, Lt), (Uc, Ut)):
        assert (Bc.levels, Bc.is_const, Bc.const_cross, Bc.reach,
                Bc.unit) == (Bt.levels, Bt.is_const, Bt.const_cross,
                             Bt.reach, Bt.unit)
        assert torch.equal(Bc.dinv_rows, Bt.dinv_rows)
    y = rng.standard_normal(Lt.n_rows)
    got = _applies(tbt, Lc, Uc, kind, torch.from_numpy(y))
    own = _applies(tbt, Lt, Ut, kind, torch.from_numpy(y))
    ref = _applies(jbt, Lj, Uj, kind, jnp.asarray(y), use_pallas=False)
    for g, o, r in zip(got, own, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-14,
                                   atol=1e-14 * np.abs(r).max())
        assert torch.equal(g, o)


@pytest.mark.parametrize("source", ["fdm:16", "hpcg:8x8x8"])
def test_blocked_ilu0_refuses_gs_pairs(source, rng,
                                       numpy_branch):  # noqa: F811
    """blocked_ilu0 applies the ILU(0) pair built from CSR (L marked unit)
    and refuses the SGS pair built from the same CSR (L divides by D), in
    plane and in const mode."""
    (Li, Ui), _ = _pairs(source, "ilu0", torch.float64, np.float64)
    (Ls, Us), _ = _pairs(source, "sgs", torch.float64, np.float64)
    assert (Li.unit, Ui.unit, Ls.unit, Us.unit) == (True, False, False, False)
    y = torch.from_numpy(rng.standard_normal(Li.n_rows))
    assert torch.isfinite(tbt.blocked_ilu0(Li, Ui, y)).all()
    with pytest.raises(ValueError, match="unit diagonal"):
        tbt.blocked_ilu0(Ls, Us, y)


def test_refusals_in_the_jax_order(numpy_branch):  # noqa: F811
    """Each refusal of the JAX NumPy branch, raised by both builders with
    the same error: no grid spec, dims, strides, an improper colouring; and
    a zero diagonal."""
    Aj, At = _csr("hpcg:4x4x4")
    _sj, st = _specs("hpcg:4x4x4")
    D = At.diagonal()
    cases = [("mod", 2, (2,), "BlockIneligibleError", "grid coloring"),
             ("grid", 8, (4, 4, 2, 2, 2, 2), "BlockIneligibleError", "dims"),
             ("grid", 24, (4, 4, 4, 2, 3, 4), "BlockIneligibleError",
              "strides"),
             ("grid", 2, (4, 4, 4, 2, 1, 1), "ImproperColoringError",
              "not proper")]
    for kind, nc, params, err, why in cases:
        spec = tcol.ColorSpec(kind, nc, params)
        colors = (tcol.spec_colors_np(spec, At.n_rows)
                  if kind == "mod" or np.prod(params[:3]) == At.n_rows
                  and not why == "strides"
                  else tcol.spec_colors_np(st, At.n_rows))
        for pkg, A, cls, kw in ((tbt, At, tcol.ColorSpec, {"device": CPU}),
                                (jbt, Aj, jcol.ColorSpec, {})):
            with pytest.raises(getattr(pkg, err), match=why):
                pkg.build_superblock_trisolve(A, D, colors,
                                              cls(kind, nc, params),
                                              upper=False, **kw)
    colors = tcol.spec_colors_np(st, At.n_rows)
    D0 = D.copy()
    D0[5] = 0.0
    with pytest.raises(ValueError, match="zero diagonal"):
        tbt.build_superblock_trisolve(At, D0, colors, st, upper=False,
                                      device=CPU)


# ---------------------------------------------------------------------------
# The rank-space form under a grid colouring
# ---------------------------------------------------------------------------

GRID_RANK = ["hpcg:6x4x8", "fdm:16"]


def _grid_rank_pair(source, triplets):
    Aj, At = _csr(source)
    sj, st = _specs(source)
    colors = tcol.spec_colors_np(st, At.n_rows)
    if triplets:
        rows, cols, vals, U_D = tfac.factor_ilu0_colored_triplets(At, colors)
        T, D_L, D_U, need_d = (rows, cols, vals, At.n_rows), None, U_D, False
        Tj = T
    else:
        T, D_L, D_U, need_d = At, At.diagonal(), At.diagonal(), True
        Tj = Aj
    out = []
    for upper, D in ((False, D_L), (True, D_U)):
        nd = need_d and not upper
        out.append((tbt.build_blocked_trisolve(T, D, colors, st, upper=upper,
                                               dtype=torch.float64,
                                               need_d=nd, device=CPU),
                    jbt.build_blocked_trisolve(Tj, D, colors, sj,
                                               upper=upper, dtype=np.float64,
                                               need_d=nd)))
    return out


def _stack(blocks):
    return np.stack([np.asarray(b).reshape(-1) for b in blocks])


@pytest.mark.parametrize("triplets", [False, True], ids=["sgs", "ilu0"])
@pytest.mark.parametrize("source", GRID_RANK)
def test_grid_rank_space_matches_jax(source, triplets, rng,
                                     numpy_branch):  # noqa: F811
    """build_blocked_trisolve under a grid colouring: the levels and groups,
    m and R_b, the planes, dinv and d bit for bit, the permute equal to the
    JAX package's and its round trip exact, and the whole solves against
    the XLA form at rtol 1e-14."""
    pairs = _grid_rank_pair(source, triplets)
    for Bt, Bj in pairs:
        assert (Bt.levels, Bt.m, Bt.R_b, Bt.n_colors, Bt.spec_kind) == (
            Bj.levels, Bj.m, Bj.R_b, Bj.n_colors, "grid")
        np.testing.assert_array_equal(Bt.vals.numpy(), _stack(Bj.vals))
        np.testing.assert_array_equal(Bt.dinv.numpy(), _stack(Bj.dinv))
        assert (Bt.d is None) == (Bj.d is None)
        if Bt.d is not None:
            np.testing.assert_array_equal(Bt.d.numpy(), _stack(Bj.d))
    (Lt, Lj), (Ut, Uj) = pairs
    y = rng.standard_normal(Lt.n_rows)
    Y = tbt.permute_blocks(Lt, torch.from_numpy(y))
    np.testing.assert_array_equal(
        Y.numpy(), _stack(jbt.permute_blocks(Lj, jnp.asarray(y))))
    assert torch.equal(tbt.unpermute_blocks(Lt, Y), torch.from_numpy(y))
    yt, yj = torch.from_numpy(y), jnp.asarray(y)
    got = [tbt.blocked_trisolve(Lt, yt), tbt.blocked_trisolve(Ut, yt),
           (tbt.blocked_ilu0 if triplets else tbt.blocked_sgs)(Lt, Ut, yt)]
    ref = [jbt.blocked_trisolve(Lj, yj, use_pallas=False),
           jbt.blocked_trisolve(Uj, yj, use_pallas=False),
           (jbt.blocked_ilu0 if triplets else jbt.blocked_sgs)(
               Lj, Uj, yj, use_pallas=False)]
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-14,
                                   atol=1e-14 * np.abs(r).max())


#: a 300 × 2 open-boundary grid, legs (±1, 0), (±129, 0), (0, ±1): the
#: x legs are self legs of the 2 × 2 grid colouring, and 129 ≥ min(nx,
#: 128) trips the lane rule
WIDE = (300, 2, 1)
WIDE_LEGS = [((1, 0, 0), -1.0), ((-1, 0, 0), -1.0), ((129, 0, 0), -0.5),
             ((-129, 0, 0), -0.5), ((0, 1, 0), -1.0), ((0, -1, 0), -1.0)]


def wide_csr():
    """The WIDE grid's matrix (diagonal 6, dominant) as the port's CSR, and
    the same in the JAX package's, and its 2 × 2 grid spec in both."""
    nx, ny, nz = WIDE
    n = nx * ny * nz
    i = np.arange(n)
    x, y = i % nx, i // nx
    rows, cols, vals = [i], [i], [np.full(n, 6.0)]
    for (dx, dy, _dz), c in WIDE_LEGS:
        ok = (x + dx >= 0) & (x + dx < nx) & (y + dy >= 0) & (y + dy < ny)
        rows.append(i[ok])
        cols.append(i[ok] + dx + nx * dy)
        vals.append(np.full(int(ok.sum()), c))
    coo = tmat.MatrixCOO.from_arrays(np.concatenate(rows),
                                     np.concatenate(cols),
                                     np.concatenate(vals), n_rows=n,
                                     n_cols=n)
    At = tmat.convert_coo_to_csr(coo)
    Aj = bis.matrix.MatrixCSR(At.n_rows, At.n_cols, At.nnz,
                              At.row_ptr.copy(), At.col.copy(),
                              At.val.copy())
    params = WIDE + (2, 2, 1)
    return (At, Aj, tcol.ColorSpec("grid", 4, params),
            jcol.ColorSpec("grid", 4, params))


def test_lane_rule_refuses_like_jax(numpy_branch):  # noqa: F811
    """A self leg of 129 ≥ min(300, 128): both packages refuse the
    superblock form (from CSR and on the stencil) and build the grid
    rank-space pair instead, with the same planes."""
    At, Aj, st, sj = wide_csr()
    colors = tcol.spec_colors_np(st, At.n_rows)
    D = At.diagonal()
    for pkg, A, s, kw in ((tbt, At, st, {"device": CPU}), (jbt, Aj, sj, {})):
        with pytest.raises(pkg.BlockIneligibleError, match="lane row"):
            pkg.build_superblock_trisolve(A, D, colors, s, upper=False, **kw)
    Lt, Ut = tbt.build_best_trisolve_pair(At, D, D, colors, st,
                                          dtype=torch.float64, need_d=True,
                                          device=CPU)
    Lj, Uj = jbt.build_best_trisolve_pair(Aj, D, D, colors, sj,
                                          dtype=np.float64, need_d=True)
    for Bt, Bj in ((Lt, Lj), (Ut, Uj)):
        assert isinstance(Bt, tbt.BlockedTriSolve)
        assert isinstance(Bj, jbt.BlockedTriSolve)
        assert Bt.levels == Bj.levels
        np.testing.assert_array_equal(Bt.vals.numpy(), _stack(Bj.vals))
    op = tso.make_stencil(WIDE_LEGS + [((0, 0, 0), 6.0)], *WIDE,
                          dtype=torch.float64, device=CPU)
    opj = bis.stencil_op.make_stencil(WIDE_LEGS + [((0, 0, 0), 6.0)], *WIDE,
                                      dtype=np.float64)
    assert not tbt.stencil_blocked_eligible(op, st)
    assert not jbt.stencil_blocked_eligible(opj, sj)
    assert not tbt.stencil_ilu0_eligible(op, st)
    assert not jbt.stencil_ilu0_eligible(opj, sj)


@pytest.mark.parametrize("harness", ["host", "fused"])
def test_lane_rule_solve_matches_jax(harness, numpy_branch):  # noqa: F811
    """CG + SGS on the WIDE matrix, gs_mode "colored" with its grid spec:
    both packages take the rank-space fallback, the same count and
    history."""
    from tests.test_torch_methods import _check_parity
    At, Aj, st, sj = wide_csr()
    bv, xv = np.full(At.n_rows, 2.0), np.full(At.n_rows, 1.0)
    kw = dict(tolerance=1e-10, gs_mode="colored", harness=harness)
    sjob = bis.preprocessing(Aj, bis.SolverConfig(
        method=bis.SolverType.CONJUGATE_GRADIENT,
        preconditioner=bis.PrecondType.SYMMETRIC_GAUSS_SEIDEL,
        dtype=np.float64, color_spec=sj, **kw), b=bv, x0=xv)
    stor = bt.preprocessing(At, bt.SolverConfig(
        method=bt.SolverType.CONJUGATE_GRADIENT,
        preconditioner=bt.PrecondType.SYMMETRIC_GAUSS_SEIDEL,
        dtype=torch.float64, color_spec=st, **kw),
        b=torch.from_numpy(bv), x0=torch.from_numpy(xv), device=CPU)
    assert type(sjob.M.L_block).__name__ == "BlockedTriSolve"
    assert isinstance(stor.M.L_block, tbt.BlockedTriSolve)
    rj, rt = bis.solve(sjob), bt.solve(stor)
    assert rt.converged
    _check_parity(rj, rt)
