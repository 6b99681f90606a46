"""Mixed-precision float64 refinement (refine_outer > 0) of the port
against the JAX package's, through both of its forms:

* the single-dispatch form (`_refine_fused_eligible`: a device oracle, the
  fused harness, a classic-CG or GMRES inner), and
* the per-outer form (BiCGSTAB's loosen-by-100x retry ladder, the
  host-CSR oracle).

With float64 inners: equal outer counts and inner iteration totals, the
outer (true float64) residual norms within rtol 1e-6 for CG, looser where
the inner method amplifies rounding (each case says why).  With float32
inners the outer norms after the first outer are the float32 inner
solve's rounding floor, which the two packages reach by differently
ordered float32 sums (measured 3% and 12% apart on CG + MG), so there the
norms are held within a factor of two and the counts exactly; both reach
the float64 criterion (CG + MG in test_torch_refine_mg.py).  The JAX tests
mirrored are tests/test_mixed_precision.py's refinement cases.
"""
import numpy as np
import pytest
import torch

import basic_iterative_solvers_tpu as bis
from basic_iterative_solvers_tpu.solvers.base import (
    _refine_fused_eligible as j_eligible)

import basic_iterative_solvers_tpu_torch as bt
from basic_iterative_solvers_tpu_torch.solvers.base import (
    _refine_fused_eligible as t_eligible)

CPU = "cpu"
TORCH_DTYPE = {np.float64: torch.float64, np.float32: torch.float32}
_METHOD = {"cg": bis.SolverType.CONJUGATE_GRADIENT,
           "gmres": bis.SolverType.GMRES, "bicgstab": bis.SolverType.BICGSTAB}
_PRECOND = {"j": bis.PrecondType.JACOBI, "ilu0": bis.PrecondType.ILU0,
            "mg": bis.PrecondType.MULTIGRID,
            "sgs": bis.PrecondType.SYMMETRIC_GAUSS_SEIDEL}


def _setups(route, spec, method, precond, dtype, **cfg):
    """Both packages' setups of one system (b = 2, x₀ = 1) on `route`:
    "stencil" or "dia" (preprocessing_device) or "host" (preprocessing)."""
    mj, pj = _METHOD[method], _PRECOND[precond]
    kw = dict(dtype=dtype, harness="fused", **cfg)
    cj = bis.SolverConfig(method=mj, preconditioner=pj, **kw)
    ct = bt.SolverConfig(method=bt.SolverType(mj.value),
                         preconditioner=bt.PrecondType(pj.value), **kw)
    td = TORCH_DTYPE[dtype]
    if route == "stencil":
        Aj = bis.stencil_op.from_source_operator(spec, dtype=dtype)
        At = bt.stencil_op.from_source_operator(spec, td, device=CPU)
    elif route == "dia":
        Aj = bis.dia.from_source_device(spec, dtype=dtype)
        At = bt.dia.from_source_device(spec, dtype=td, device=CPU)
    else:
        Aj, At = bis.generators.from_source(spec), bt.generators.from_source(
            spec)
    n = Aj.n_rows
    bv, xv = np.full(n, 2.0, dtype), np.full(n, 1.0, dtype)
    bt_, xt = torch.from_numpy(bv), torch.from_numpy(xv)
    if route == "host":
        return (bis.preprocessing(Aj, cj, b=bv, x0=xv),
                bt.preprocessing(At, ct, b=bt_, x0=xt, device=CPU))
    return (bis.preprocessing_device(Aj, cj, b=bv, x0=xv),
            bt.preprocessing_device(At, ct, b=bt_, x0=xt))


def _check(rj, rt, outer_rtol):
    assert rj.converged and rt.converged
    assert rt.refine_outer_count == rj.refine_outer_count
    assert rt.iter_count == rj.iter_count
    assert rt.gmres_restart_count == rj.gmres_restart_count
    assert len(rt.residual_norms) == len(rj.residual_norms)
    np.testing.assert_allclose(rt.residual_norms, rj.residual_norms,
                               rtol=outer_rtol)
    assert rt.final_residual_norm <= rt.stopping_criteria
    assert rt.x_star.dtype == torch.float64


#: inners to 1e-3 and outers to 1e-9: three or more outers, the last well
#: above the float64 evaluation floor of b − A·x (a 1e-11·‖r₀‖ outer sits
#: on it and differs by ~1e-4 between the packages)
F64 = dict(refine_outer=6, tolerance=1e-9, refine_inner_tol=1e-3,
           max_iters=300)


@pytest.mark.parametrize("route,spec,method,precond,cfg,fused,rtol", [
    ("stencil", "hpcg:16x16x16", "cg", "j", {}, True, 1e-6),
    ("dia", "hpcg:16x16x16", "gmres", "j", {"restart_length": 20}, True,
     5e-5),
    ("stencil", "hpcg:16x16x16", "bicgstab", "j", {}, False, 5e-5),
    ("host", "fdm:16", "cg", "sgs", {"gs_mode": "levels"}, False, 5e-6),
    ("stencil", "hpcg:16x16x16", "cg", "ilu0", {}, True, 1e-6),
], ids=["cg_single_dispatch", "gmres_single_dispatch", "bicgstab_ladder",
        "host_csr_oracle", "ilu0"])
def test_refinement_f64_inner_matches_jax(route, spec, method, precond, cfg,
                                          fused, rtol):
    """Each outer divides the residual by ~1/refine_inner_tol and so
    multiplies the inner solve's last-bit differences by as much: CG holds
    rtol 1e-6 over three outers; GMRES (six outers), BiCGSTAB (whose
    recurrence amplifies rounding) and CG + SGS
    on the host route (natural-order level scans) hold the rtol given."""
    sj, st = _setups(route, spec, method, precond, np.float64, **F64, **cfg)
    assert j_eligible(sj) == t_eligible(st) == fused
    rj, rt = bis.solve(sj), bt.solve(st)
    assert rt.refine_outer_count >= 3
    _check(rj, rt, rtol)
    if method == "gmres":
        assert rt.iter_count > 20      # the inner solves restarted


@pytest.mark.parametrize("method", ["cg", "bicgstab", "gmres"])
def test_refinement_f32_inner_reaches_f64_criterion(method):
    """tests/test_mixed_precision.py's regression: unit-scaled inner
    right-hand sides let every Krylov method reach 1e-12 from float32
    inners (BiCGSTAB on the per-outer form's ladder)."""
    cfg = dict(refine_outer=8, tolerance=1e-12, max_iters=300)
    if method == "gmres":
        cfg["restart_length"] = 20
    sj, st = _setups("dia", "hpcg:16x16x16", method, "j", np.float32, **cfg)
    assert t_eligible(st) == (method != "bicgstab")
    rj, rt = bis.solve(sj), bt.solve(st)
    assert rj.converged and rt.converged
    assert rt.refine_outer_count == rj.refine_outer_count
    assert rt.final_residual_norm <= rt.stopping_criteria
    np.testing.assert_allclose(rt.residual_norms[:2], rj.residual_norms[:2],
                               rtol=0.5)


def test_refinement_refuses_permuted_setups():
    """The per-outer form refuses a permuted solve ordering, as the JAX
    package's does."""
    A = bt.generators.from_source("fdm:8")
    st = bt.preprocessing(A, bt.SolverConfig(
        refine_outer=2, perm_mode="rcm", harness="host"), device=CPU)
    with pytest.raises(ValueError, match="perm_mode"):
        bt.solve(st)
