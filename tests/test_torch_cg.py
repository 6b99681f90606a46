"""The port's CG solve against the JAX package's, and against the
reference's golden history.

Each case builds the same generator spec in both packages and hands both
the same b and x0 (the bench's b = 2, x0 = 1 unless stated).  On the CPU
the port's SpMV runs its plain version; the JAX package runs its XLA path.
"""
import json
import pathlib

import numpy as np
import pytest
import torch

import basic_iterative_solvers_tpu as bis
import basic_iterative_solvers_tpu_torch as bt
from basic_iterative_solvers_tpu_torch.solvers import make_method

#: the port's entry points run on the card unless asked; these tests
#: run on the CPU
CPU = "cpu"

HARNESSES = ["host", "fused"]
TORCH_DTYPE = {np.float64: torch.float64, np.float32: torch.float32}


def _solve_both(spec, harness, dtype=np.float64, b=2.0, x0=1.0, **cfg):
    Aj = bis.stencil_op.from_source_operator(spec, dtype=dtype)
    n = Aj.n_rows
    bv, xv = np.full(n, b, dtype), np.full(n, x0, dtype)
    rj = bis.solve(bis.preprocessing_device(
        Aj, bis.SolverConfig(dtype=dtype, harness=harness, **cfg),
        b=bv, x0=xv))
    At = bt.stencil_op.from_source_operator(spec, TORCH_DTYPE[dtype],
                                            device=CPU)
    rt = bt.solve(bt.preprocessing_device(
        At, bt.SolverConfig(dtype=dtype, harness=harness, **cfg),
        b=torch.from_numpy(bv), x0=torch.from_numpy(xv)))
    return rj, rt


#: The explicit float64 residual of a solve run to tol=1e-10 sits at the
#: rounding floor of evaluating b − A·x: x* that differ in the last bit
#: move it by ~1e-5 relative.  The JAX package's own host and fused
#: harnesses differ by 3e-6 on it (hpcg:16x16x16), so it is compared at
#: rtol 1e-4; the recurrence histories carry the tight check.
FINAL_RTOL = 1e-4


def _check_parity(rj, rt, hist_rtol):
    assert rt.iter_count == rj.iter_count
    assert rt.converged == rj.converged
    assert len(rt.residual_norms) == len(rj.residual_norms)
    np.testing.assert_allclose(rt.residual_norms[:-1],
                               rj.residual_norms[:-1], rtol=hist_rtol)
    np.testing.assert_allclose(rt.final_residual_norm,
                               rj.final_residual_norm, rtol=FINAL_RTOL)


@pytest.mark.parametrize("harness", HARNESSES)
@pytest.mark.parametrize("spec,iters", [("hpcg:16x16x16", 27),
                                        ("fdm:16", 31)])
def test_cg_f64_parity(spec, iters, harness):
    """Same recurrence in float64: the same iteration count (27 on
    hpcg:16x16x16, measured with the JAX package), histories to rtol 1e-8
    (rounding differs only in reduction order; measured ≤ 2e-11)."""
    rj, rt = _solve_both(spec, harness, tolerance=1e-10, max_iters=1000)
    assert rt.converged and rt.iter_count == iters
    _check_parity(rj, rt, 1e-8)
    np.testing.assert_allclose(rt.x_star.numpy(), np.asarray(rj.x_star),
                               rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("harness", HARNESSES)
@pytest.mark.parametrize("spec", ["hpcg:16x16x16", "fdm:16"])
def test_cg_f32_fixed_iterations(spec, harness):
    """tolerance=0 runs exactly max_iters.  While the residual is above the
    float32 floor the histories agree to rtol 1e-4 (reduction order moves
    them by ≤ 4e-5); below ~1e-4·||r0|| (from iteration ~16) both are
    rounding noise and differ by up to 2x, so there both explicit float64
    residuals need only reach float32's attainable accuracy, 1e-5·||r0||."""
    rj, rt = _solve_both(spec, harness, dtype=np.float32, tolerance=0.0,
                         max_iters=50, breakdown_stall=True)
    assert rt.iter_count == rj.iter_count == 50
    hj, ht = rj.residual_norms[:-1], rt.residual_norms[:-1]
    assert len(ht) == len(hj) == 51
    above = hj >= 1e-4 * hj[0]
    assert above[:15].all()
    np.testing.assert_allclose(ht[above], hj[above], rtol=1e-4)
    for res in (rj, rt):
        assert res.final_residual_norm <= 1e-5 * hj[0]


@pytest.mark.parametrize("harness", HARNESSES)
def test_cg_res_check_len(harness):
    """Sampling every 3rd iteration: the stopping test reads the last
    sampled norm, so iteration counts and the shorter history match."""
    rj, rt = _solve_both("hpcg:16x16x16", harness, tolerance=1e-10,
                         max_iters=1000, res_check_len=3)
    assert rt.iter_count % 3 == 0
    _check_parity(rj, rt, 1e-8)


@pytest.mark.parametrize("harness", HARNESSES)
def test_cg_fdm16_golden(harness):
    """The reference binary's fdm16_cg history with its defaults (b = 1,
    x0 = 0.1, tol = 1e-14): 34 iterations, and the recurrence prefix
    golden[:-1] (the reference overwrites its last entry with the explicit
    residual) at rtol 1e-5 and, for the entries at the float64 floor, the
    atol 1e-13 of tests/test_reference_parity.py."""
    goldens = json.loads((pathlib.Path(__file__).parent / "goldens" /
                          "reference_histories.json").read_text())
    d, g = goldens["_defaults"], goldens["fdm16_cg"]
    res = bt.solve_system("fdm:16", "cg", harness=harness,
                          tolerance=d["tol"], max_iters=d["max_iters"],
                          b_val=d["b_val"], init_x_val=d["init_x_val"],
                          res_check_len=d["res_check_len"],
                          matrix_format="stencil", device=CPU)
    assert res.iter_count == g["iterations"] == 34
    assert res.converged
    golden = np.asarray(g["norms"])
    np.testing.assert_allclose(res.residual_norms[:len(golden) - 1],
                               golden[:-1], rtol=1e-5, atol=1e-13)


@pytest.mark.parametrize("harness", HARNESSES)
def test_cg_general_branch_matches_identity(harness):
    """The preconditioned branch (ρ = (r, z), breakdown guard on) with
    M = I takes the same steps as the identity specialization; ρ comes from
    a dot instead of the carried norm, so rounding differs: rtol 1e-8."""
    A = bt.stencil_op.from_source_operator("hpcg:16x16x16", torch.float64,
                                           device=CPU)
    cfg = bt.SolverConfig(harness=harness, tolerance=1e-10,
                          breakdown_stall=True)
    setup = bt.preprocessing_device(A, cfg)
    general = make_method(setup)
    general._identity_M = False
    r_gen = bt.solve(setup, method=general)
    r_id = bt.solve(setup)
    assert r_gen.iter_count == r_id.iter_count
    np.testing.assert_allclose(r_gen.residual_norms[:-1],
                               r_id.residual_norms[:-1], rtol=1e-8)
    np.testing.assert_allclose(r_gen.final_residual_norm,
                               r_id.final_residual_norm, rtol=FINAL_RTOL)


def test_fused_stop_leaves_state_unchanged():
    """A fused solve that converges inside a check chunk returns the
    iterate of its stopping iteration: the gated steps after it change
    nothing (the host harness stops exactly there)."""
    A = bt.stencil_op.from_source_operator("fdm:16", torch.float64, device=CPU)
    results = [bt.solve(bt.preprocessing_device(
        A, bt.SolverConfig(harness=h, tolerance=1e-10))) for h in HARNESSES]
    assert results[0].iter_count == results[1].iter_count == 31
    assert torch.equal(results[0].x_star, results[1].x_star)
    assert results[0].final_residual_norm == results[1].final_residual_norm
