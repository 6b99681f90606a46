"""The port's const-mode superblock solves (the plain version of kernel #9)
against the JAX package's.

The port builds the (L, U) pair from its own DeviceStencil; its metadata
must equal what the JAX package's build_superblock_gs_pair_stencil gives.
The solves (L, U and the symmetric apply) are held against the JAX
package's blocked_trisolve/blocked_sgs on its XLA path (float64) and
through the Pallas kernel `_super_level_pallas` in interpret mode
(float32).  Inputs come from `numpy.random.default_rng`.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from basic_iterative_solvers_tpu import coloring as jcol
from basic_iterative_solvers_tpu import stencil_op as jso
from basic_iterative_solvers_tpu.ops import block_trisolve as jbt
from basic_iterative_solvers_tpu.ops import pallas_env

from basic_iterative_solvers_tpu_torch import coloring as tcol
from basic_iterative_solvers_tpu_torch import stencil_op as tso
from basic_iterative_solvers_tpu_torch.ops import block_trisolve as tbt

#: the port's entry points run on the card unless asked; these tests
#: run on the CPU
CPU = "cpu"

SPECS = ["hpcg:16x16x16", "hpcg:16x12x8"]
SOLVES = ["L", "U", "sgs"]


@pytest.fixture
def interpret():
    pallas_env.INTERPRET = True
    try:
        yield
    finally:
        pallas_env.INTERPRET = False


def _pairs(spec, np_dt, t_dt):
    Aj = jso.from_source_operator(spec, dtype=np_dt)
    At = tso.from_source_operator(spec, t_dt, device=CPU)
    pj = jbt.build_superblock_gs_pair_stencil(
        Aj, jcol.spec_for_device(Aj), dtype=np_dt, need_d=True)
    pt = tbt.build_superblock_gs_pair_stencil(
        At, tcol.spec_for_device(At), dtype=t_dt, need_d=True)
    return pj, pt, At.n_rows


def _solve(pkg, pair, y, solve, **kw):
    L, U = pair
    if solve == "sgs":
        return pkg.blocked_sgs(L, U, y, **kw)
    return pkg.blocked_trisolve(L if solve == "L" else U, y, **kw)


@pytest.mark.parametrize("spec", SPECS + ["hpcg:8x8x8", "hpcg:6x4x2"])
def test_pair_metadata_matches_jax(spec):
    (Lj, Uj), (Lt, Ut), _ = _pairs(spec, np.float64, torch.float64)
    for j, t in ((Lj, Lt), (Uj, Ut)):
        assert t.levels == j.levels
        assert t.const_cross == j.const_cross
        assert t.const_self == j.const_self
        assert (t.upper, t.S, t.sx, t.m, t.spec_params) == (
            j.upper, j.S, j.sx, j.m, j.spec_params)
    d = np.asarray(Lj.d[0]).reshape(-1)[0]
    dinv = np.asarray(Lj.dinv[0]).reshape(-1)[0]
    assert (Lt.d, Lt.dinv, Ut.d) == (d, dinv, None)


@pytest.mark.parametrize("solve", SOLVES)
@pytest.mark.parametrize("spec", SPECS)
def test_plain_solves_f64_match_jax_xla(spec, solve):
    """Cross legs in the JAX package's (src, Δ) order, then self legs, each
    product and difference rounded alone as XLA's separate ops round them:
    rtol 1e-14."""
    pj, pt, n = _pairs(spec, np.float64, torch.float64)
    y = np.random.default_rng(7).standard_normal(n)
    ref = np.asarray(_solve(jbt, pj, jnp.asarray(y), solve,
                            use_pallas=False))
    got = _solve(tbt, pt, torch.from_numpy(y), solve).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-14, atol=1e-14)


@pytest.mark.parametrize("solve", SOLVES)
@pytest.mark.parametrize("spec", SPECS)
def test_plain_solves_f32_match_pallas_kernel(interpret, spec, solve):
    """Against the Pallas kernel in interpret mode, which contracts each
    product and difference into a fused multiply-add where the plain
    version rounds both: rtol 1e-5, atol 1e-6."""
    pj, pt, n = _pairs(spec, np.float32, torch.float32)
    y = np.random.default_rng(8).standard_normal(n).astype(np.float32)
    ref = np.asarray(_solve(jbt, pj, jnp.asarray(y), solve))
    got = _solve(tbt, pt, torch.from_numpy(y), solve).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("spec", ["hpcg:8x8x8", "fdm:16"])
def test_blocked_solves_equal_colored_sweeps(spec):
    """The superblock solves are the masked sweeps' action from zero, with
    the same colouring (exact solves of one ordering: rtol 1e-12)."""
    At = tso.from_source_operator(spec, torch.float64, device=CPU)
    st = tcol.spec_for_device(At)
    if st.kind != "grid":
        with pytest.raises(tbt.BlockIneligibleError):
            tbt.build_superblock_gs_pair_stencil(At, st)
        assert not tbt.stencil_blocked_eligible(At, st)
        return
    L, U = tbt.build_superblock_gs_pair_stencil(At, st, dtype=torch.float64,
                                                need_d=True)
    y = torch.from_numpy(np.random.default_rng(9).standard_normal(At.n_rows))
    dinv = 1.0 / tso.stencil_diag(At)
    for B, reverse in ((L, False), (U, True)):
        ref = tcol.colored_sweep(At, dinv, y, None, st, st.n_colors,
                                 reverse=reverse)
        torch.testing.assert_close(tbt.blocked_trisolve(B, y), ref,
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("spec,why", [
    ("anderson:Lx=4,Ly=4,Lz=4,ranpot=1.0", "dense-diagonal"),
    ("hpcg:8x6x5", "divide"),
])
def test_ineligible_operators_raise_like_jax(spec, why):
    At = tso.from_source_operator(spec, torch.float64, device=CPU)
    Aj = jso.from_source_operator(spec, dtype=np.float64)
    st, sj = tcol.spec_for_device(At), jcol.spec_for_device(Aj)
    for pkg, A, s in ((tbt, At, st), (jbt, Aj, sj)):
        if s.kind != "grid":
            s = type(s)("grid", 8, A.dims + (2, 2, 2))
        with pytest.raises(pkg.BlockIneligibleError, match=why):
            pkg.build_superblock_gs_pair_stencil(A, s)
    assert not tbt.stencil_blocked_eligible(At, st)


def test_super_level_in_place_and_checks():
    """A level writes only its superblock's rows; the U solve may run in
    place (y is x) as blocked_sgs runs it; bad operands raise."""
    At = tso.from_source_operator("hpcg:8x8x8", torch.float64, device=CPU)
    L, U = tbt.build_superblock_gs_pair_stencil(
        At, tcol.spec_for_device(At), dtype=torch.float64)
    y = torch.from_numpy(np.random.default_rng(10).standard_normal(512))
    x = torch.full_like(y, 7.0)
    tbt.super_level(L, 0, y, x)
    sb = L.levels[0][0]
    i = torch.arange(512)
    mine = ((i // 8) % 8 % 2 + 2 * ((i // 64) % 2)) == sb
    assert bool((x[~mine] == 7.0).all()) and not bool((x[mine] == 7.0).any())
    t = y.clone()
    for li in range(len(U.levels)):
        tbt.super_level(U, li, t, t)
    torch.testing.assert_close(t, tbt.blocked_trisolve(U, y), rtol=0, atol=0)
    with pytest.raises(TypeError):
        tbt.super_level(L, 0, y.float(), x)
    with pytest.raises(ValueError):
        tbt.super_level(L, 0, y[:-1], x)
    with pytest.raises(IndexError):
        tbt.super_level(L, 4, y, x)
    with pytest.raises(ValueError, match="need_d"):
        tbt.blocked_sgs(L, U, y)
