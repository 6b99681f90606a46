"""The port's Jacobi, BiCGSTAB and Jacobi-preconditioned CG against the JAX
package's, and the port against the reference's golden histories (these
methods, GMRES and the two-stage preconditioners).

Each parity case builds the same generator spec in both packages and hands
both the same b = 2 and x0 = 1 (the bench's).  On the CPU the port's SpMV
runs its plain version; the JAX package runs its XLA path.
"""
import json
import pathlib

import numpy as np
import pytest
import torch

import basic_iterative_solvers_tpu as bis
import basic_iterative_solvers_tpu_torch as bt

#: the port's entry points run on the card unless asked; these tests
#: run on the CPU
CPU = "cpu"

HARNESSES = ["host", "fused"]
GOLDENS = json.loads((pathlib.Path(__file__).parent / "goldens" /
                      "reference_histories.json").read_text())


def _solve_both(spec, harness, method, precond="NONE", **cfg):
    """The same float64 solve in both packages; `method` and `precond` name
    the members of either package's enums."""
    Aj = bis.stencil_op.from_source_operator(spec, dtype=np.float64)
    n = Aj.n_rows
    bv, xv = np.full(n, 2.0), np.full(n, 1.0)
    rj = bis.solve(bis.preprocessing_device(Aj, bis.SolverConfig(
        method=bis.SolverType[method], preconditioner=bis.PrecondType[precond],
        dtype=np.float64, harness=harness, **cfg), b=bv, x0=xv))
    At = bt.stencil_op.from_source_operator(spec, torch.float64, device=CPU)
    rt = bt.solve(bt.preprocessing_device(At, bt.SolverConfig(
        method=bt.SolverType[method], preconditioner=bt.PrecondType[precond],
        dtype=torch.float64, harness=harness, **cfg),
        b=torch.from_numpy(bv), x0=torch.from_numpy(xv)))
    return rj, rt


def _check_parity(rj, rt, final_rtol=1e-4):
    """Same iteration and restart counts, histories to rtol 1e-8 above the
    float64 noise floor (atol 1e-15·‖r0‖: the two differ in reduction order
    only, and BiCGSTAB's last norms, ~1e-10·‖r0‖, move by ~1e-18·‖r0‖), and
    the explicit final residual to rtol `final_rtol` (1e-4): it sits at the
    rounding floor of b − A·x, where x* that differ in their last bits move
    it by ~1e-5."""
    assert rt.iter_count == rj.iter_count
    assert rt.gmres_restart_count == rj.gmres_restart_count
    assert rt.converged == rj.converged
    assert len(rt.residual_norms) == len(rj.residual_norms)
    np.testing.assert_allclose(rt.residual_norms[:-1],
                               rj.residual_norms[:-1], rtol=1e-8,
                               atol=1e-15 * rj.residual_norms[0])
    np.testing.assert_allclose(rt.final_residual_norm,
                               rj.final_residual_norm, rtol=final_rtol)


@pytest.mark.parametrize("harness", HARNESSES)
@pytest.mark.parametrize("spec,iters", [("hpcg:16x16x16", 340),
                                        ("fdm:16", 790)])
def test_jacobi_f64_parity(spec, iters, harness):
    """Jacobi to tol 1e-6: 340 and 790 iterations (measured with the JAX
    package)."""
    rj, rt = _solve_both(spec, harness, "JACOBI", tolerance=1e-6)
    assert rt.converged and rt.iter_count == iters
    _check_parity(rj, rt)


@pytest.mark.parametrize("harness", HARNESSES)
@pytest.mark.parametrize("precond", ["NONE", "JACOBI"])
@pytest.mark.parametrize("spec,iters", [("hpcg:16x16x16", 18),
                                        ("fdm:16", 23)])
def test_bicgstab_f64_parity(spec, iters, precond, harness):
    """BiCGSTAB to tol 1e-10, unpreconditioned and with -p j: 18 and 23
    iterations (measured with the JAX package)."""
    rj, rt = _solve_both(spec, harness, "BICGSTAB", precond, tolerance=1e-10)
    assert rt.converged and rt.iter_count == iters
    _check_parity(rj, rt)


@pytest.mark.parametrize("harness", HARNESSES)
@pytest.mark.parametrize("spec,iters", [("hpcg:16x16x16", 27),
                                        ("fdm:16", 31)])
def test_cg_jacobi_f64_parity(spec, iters, harness):
    """CG with -p j (the general branch, ρ = (r, z)) to tol 1e-10."""
    rj, rt = _solve_both(spec, harness, "CONJUGATE_GRADIENT", "JACOBI",
                         tolerance=1e-10)
    assert rt.converged and rt.iter_count == iters
    _check_parity(rj, rt)


#: (case, rtol of the recurrence prefix, prefix limit, check the count):
#: tests/test_reference_parity.py's settings for these cases
GOLDEN_CASES = [
    ("fdm16_j", 1e-9, 200, True),
    ("fdm16_bi", 1e-4, None, True),
    ("fdm16_cg_j", 1e-5, None, True),
    ("fdm16_bi_j", 1e-4, None, True),
    ("fdm16_bi_j_outer2", 1e-4, None, True),
    ("fdm16_gm_j_rl50", 1e-4, 32, False),
    ("fdm16_gm_j_rl10", 1e-6, 90, True),
    ("fdm16_cg_2st", 1e-5, None, True),
    ("fdm16_cg_s2st", 1e-5, None, True),
    ("fdm16_cg_2st_inner2", 1e-7, 200, True),
    ("fdm16_cg_s2st_inner2", 1e-5, None, True),
    ("fdm16_bi_s2st_inner2", 1e-4, None, True),
]


@pytest.mark.parametrize("harness", HARNESSES)
@pytest.mark.parametrize("case,rtol,limit,check_iters", GOLDEN_CASES,
                         ids=[c[0] for c in GOLDEN_CASES])
def test_golden_history(case, rtol, limit, check_iters, harness):
    """The reference binary's history with its defaults (b = 1, x0 = 0.1,
    tol = 1e-14; the two-stage cases' Richardson sweeps as the golden
    names them), the port's fdm:16 standing in for FDM-2d-16.mtx: the
    convergence flag, the iteration count with GMRES restarts counted
    (±1), the recurrence prefix golden[:-1] (the reference overwrites its
    last entry with the explicit residual) at the case's rtol and atol
    1e-13, and a converged solve's explicit residual within 10× the stop."""
    g, d = GOLDENS[case], GOLDENS["_defaults"]
    kw = {}
    extra = list(g["extra"])
    while extra:
        flag = extra.pop(0)
        if flag == "-p":
            kw["preconditioner"] = extra.pop(0)
        elif flag == "-rl":
            kw["restart_length"] = int(extra.pop(0))
    res = bt.solve_system(
        "fdm:16", g["method"], harness=harness, tolerance=d["tol"],
        max_iters=d["max_iters"], b_val=d["b_val"],
        init_x_val=d["init_x_val"], res_check_len=d["res_check_len"],
        precond_outer_iters=g.get("precond_outer_iters", 1),
        precond_inner_iters=g.get("precond_inner_iters", 0), **kw,
        matrix_format="stencil", device=CPU)
    assert res.converged == g["converged"]
    if check_iters:
        assert abs(res.iter_count + res.gmres_restart_count
                   - g["iterations"]) <= 1
    golden = np.asarray(g["norms"][:-1])
    ours = res.residual_norms[:len(golden)]
    if limit is not None:
        golden, ours = golden[:limit], ours[:limit]
    np.testing.assert_allclose(ours, golden, rtol=rtol, atol=1e-13)
    if g["converged"]:
        assert res.final_residual_norm < 10.0 * res.stopping_criteria


def test_gmres_rl10_golden_counts_restarts():
    """fdm16_gm_j_rl10: 192 iterations and 19 restarts, 211 steps in all,
    as the reference counts them."""
    res = bt.solve_system("fdm:16", "gm", "j", harness="fused",
                          tolerance=1e-14, b_val=1.0, init_x_val=0.1,
                          matrix_format="stencil", device=CPU)
    assert res.converged
    assert res.iter_count + res.gmres_restart_count == 211
    assert res.gmres_restart_count == 19


@pytest.mark.parametrize("method,iters", [("BICGSTAB", 23), ("JACOBI", 795)])
def test_fused_stop_leaves_state_unchanged(method, iters):
    """A fused solve that converges inside a check chunk returns the iterate
    of its stopping iteration: the gated steps after it change nothing, so
    iteration count, history and x* equal the host harness's."""
    A = bt.stencil_op.from_source_operator("fdm:16", torch.float64, device=CPU)
    tol = 1e-6 if method == "JACOBI" else 1e-10
    results = [bt.solve(bt.preprocessing_device(A, bt.SolverConfig(
        method=bt.SolverType[method], harness=h, tolerance=tol)))
        for h in HARNESSES]
    assert results[0].iter_count == results[1].iter_count == iters
    assert iters % 64
    np.testing.assert_array_equal(results[0].residual_norms,
                                  results[1].residual_norms)
    assert torch.equal(results[0].x_star, results[1].x_star)


def test_jacobi_preconditioner_setup():
    """-p j stores the diagonal and its inverse at the vector dtype and
    divides by the diagonal, composed precond_outer_iters times."""
    from basic_iterative_solvers_tpu_torch.precond import (
        apply_preconditioner, setup_preconditioner)
    A = bt.stencil_op.from_source_operator("hpcg:8x6x4", torch.float32,
                                           device=CPU)
    cfg = bt.SolverConfig(preconditioner=bt.PrecondType.JACOBI,
                          dtype=torch.float64, precond_outer_iters=2)
    M = setup_preconditioner(A, cfg)
    assert M.A_D.dtype == M.A_D_inv.dtype == torch.float64
    assert torch.equal(M.A_D, torch.full((A.n_rows,), 26.0,
                                         dtype=torch.float64))
    y = torch.arange(A.n_rows, dtype=torch.float64)
    assert torch.equal(apply_preconditioner(M, y), y / 26.0 / 26.0)
    Z = bt.stencil_op.anderson_operator(3, ranpot=0.0, dtype=torch.float64,
                                        device=CPU)
    with pytest.raises(ValueError, match="zero on the matrix diagonal"):
        setup_preconditioner(Z, cfg)
