"""The host-CSR path's natural-order exact solves (gs_mode "levels": the
level-scheduled scans of ops/trisolve.py) against the reference's golden
histories, and natural-order ILU(0) on FDM and Anderson against the JAX
package.

The goldens come from the reference's lexicographic GS (b = 1, x0 = 0.1,
tol 1e-14), which the JAX package matches on this path
(tests/test_reference_parity.py); the prefixes and tolerances here are
that file's.  The port's fdm:16 stands in for FDM-2d-16.mtx.  Two goldens
of other settings stand here too: fdm16_cg_j_scale (num_scale, the
reference's x0 quirk compensated) and fdm16_bi_sgs_outer2 (the port, like
the JAX package, converges strictly faster than the reference's
outer-iterations init defect).
"""
import json
import pathlib

import numpy as np
import pytest
import torch

import basic_iterative_solvers_tpu as bis
import basic_iterative_solvers_tpu_torch as bt
from basic_iterative_solvers_tpu_torch import generators as tgen
from tests.test_torch_ilu0_factor import numpy_branch  # noqa: F401
from tests.test_torch_methods import _check_parity

CPU = "cpu"
HARNESSES = ["host", "fused"]
GOLDENS = json.loads((pathlib.Path(__file__).parent / "goldens" /
                      "reference_histories.json").read_text())

#: (case, rtol of the recurrence prefix, prefix limit, check the count):
#: tests/test_reference_parity.py's settings (fdm16_cg_gs is the same
#: configuration as fdm16_gs_precond_cg and takes its settings)
GOLDEN_CASES = [
    ("fdm16_gs", 1e-8, None, True),
    ("fdm16_sgs", 1e-8, None, True),
    ("fdm16_cg_sgs", 1e-5, None, True),
    ("fdm16_bi_sgs", 1e-4, None, True),
    ("fdm16_bi_bgs", 1e-4, None, True),
    ("fdm16_cg_gs", 1e-5, 100, True),
    ("fdm16_gs_precond_cg", 1e-5, 100, True),
    ("anderson_cg_j", 1e-3, 30, True),
    ("anderson_bi_j", 1e-3, 7, False),
    ("anderson_gs", 1e-7, 40, False),
]


def _matrix(g):
    return "fdm:16" if g["matrix"].endswith("FDM-2d-16.mtx") else g["matrix"]


@pytest.mark.parametrize("harness", HARNESSES)
@pytest.mark.parametrize("case,rtol,limit,check_iters", GOLDEN_CASES,
                         ids=[c[0] for c in GOLDEN_CASES])
def test_golden_history_levels(case, rtol, limit, check_iters, harness):
    """preprocessing(host CSR) with the default gs_mode ("levels" on this
    path): the convergence flag, the iteration count (±1), the recurrence
    prefix at the case's rtol and atol 1e-13, and a converged solve's
    explicit residual within 10× the stop."""
    g, d = GOLDENS[case], GOLDENS["_defaults"]
    kw = {}
    extra = list(g["extra"])
    while extra:
        if extra.pop(0) == "-p":
            kw["preconditioner"] = bt.PRECOND_CLI_NAMES[extra.pop(0)]
    cfg = bt.SolverConfig(
        method=bt.SOLVER_CLI_FLAGS[g["method"]], dtype=torch.float64,
        harness=harness, tolerance=d["tol"], max_iters=d["max_iters"],
        b_val=d["b_val"], init_x_val=d["init_x_val"],
        res_check_len=d["res_check_len"], **kw)
    setup = bt.preprocessing(tgen.from_source(_matrix(g)), cfg, device=CPU)
    if cfg.method in (bt.SolverType.GAUSS_SEIDEL,
                      bt.SolverType.SYMMETRIC_GAUSS_SEIDEL):
        assert setup.L_solve is not None and setup.n_colors == 0
    res = bt.solve(setup)
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


def _golden_config(g, harness, **kw):
    d = GOLDENS["_defaults"]
    return bt.SolverConfig(
        method=bt.SOLVER_CLI_FLAGS[g["method"]], dtype=torch.float64,
        harness=harness, tolerance=d["tol"], max_iters=d["max_iters"],
        b_val=d["b_val"], init_x_val=d["init_x_val"],
        res_check_len=d["res_check_len"],
        precond_outer_iters=g.get("precond_outer_iters", 1), **kw)


@pytest.mark.parametrize("harness", HARNESSES)
def test_golden_cg_j_scale(harness):
    """fdm16_cg_j_scale (-p j -scale 1): num_scale on the host path.  The
    reference's solvers copy x0 before its preprocessing scales it, so its
    solve starts from x0 = 0.1 unscaled; the test hands the port
    0.1·sqrt(|a_ii|), which scaling turns into that x0, as
    tests/test_reference_parity.py does for the JAX package.  The golden's
    settings: the count (±1), the prefix at rtol 1e-5, atol 1e-13, the
    explicit residual within 10× the stop."""
    g = GOLDENS["fdm16_cg_j_scale"]
    assert g["extra"] == ["-p", "j", "-scale", "1"]
    A = tgen.from_source(_matrix(g))
    cfg = _golden_config(g, harness, num_scale=True,
                         preconditioner=bt.PrecondType.JACOBI)
    x0 = cfg.init_x_val * np.sqrt(np.abs(A.diagonal()))
    res = bt.solve(bt.preprocessing(A, cfg, x0=x0, device=CPU))
    assert res.converged == g["converged"]
    assert abs(res.iter_count - g["iterations"]) <= 1
    golden = np.asarray(g["norms"][:-1])
    np.testing.assert_allclose(res.residual_norms[:len(golden)], golden,
                               rtol=1e-5, atol=1e-13)
    assert res.final_residual_norm < 10.0 * res.stopping_criteria


@pytest.mark.parametrize("harness", HARNESSES)
def test_golden_bi_sgs_outer2_converges_faster(harness,
                                               numpy_branch):  # noqa: F811
    """fdm16_bi_sgs_outer2 (-p sgs, precond_outer_iters 2): the reference's
    init call aliases its input and output and loses the preconditioned
    r0 (tests/test_reference_parity.py:145-183), so its golden takes 19
    iterations; the port composes the init apply correctly and converges
    in fewer, as the JAX package does, with the JAX package's count and
    history (rtol 1e-8).  At tol 1e-14 the explicit final residual,
    ~3.5e-13, is the float64 rounding floor of b − A·x (x* differing in
    their last bits move it by ~20%): both are held below 10× the stop,
    not to each other."""
    g = GOLDENS["fdm16_bi_sgs_outer2"]
    assert g["extra"] == ["-p", "sgs"] and g["precond_outer_iters"] == 2
    cfg = _golden_config(g, harness,
                         preconditioner=bt.PrecondType.SYMMETRIC_GAUSS_SEIDEL)
    res = bt.solve(bt.preprocessing(tgen.from_source(_matrix(g)), cfg,
                                    device=CPU))
    assert res.converged and res.iter_count < g["iterations"]
    d = GOLDENS["_defaults"]
    rj = bis.solve(bis.preprocessing(
        bis.generators.from_source("fdm:16"), bis.SolverConfig(
            method=bis.SolverType.BICGSTAB,
            preconditioner=bis.PrecondType.SYMMETRIC_GAUSS_SEIDEL,
            dtype=np.float64, harness=harness, tolerance=d["tol"],
            max_iters=d["max_iters"], b_val=d["b_val"],
            init_x_val=d["init_x_val"], res_check_len=d["res_check_len"],
            precond_outer_iters=2)))
    assert rj.iter_count == res.iter_count
    _check_parity(rj, res, final_rtol=np.inf)
    assert max(res.final_residual_norm, rj.final_residual_norm) < (
        10.0 * res.stopping_criteria)


ANDERSON = "anderson:Lx=4,Ly=4,Lz=4,ranpot=1.0"


@pytest.mark.parametrize("method,iters", [("cg", 20), ("bi", 13)])
@pytest.mark.parametrize("harness", HARNESSES)
def test_ilu0_fdm_host_route_matches_jax(method, iters, harness,
                                         numpy_branch):  # noqa: F811
    """solve_system("fdm:16", method, "ilu0") takes the host-CSR route in
    both packages (red-black FDM has no factor-table pair): natural-order
    ILU(0) levels, tol 1e-10, b = 2, x0 = 1; the same iteration count
    (CG: 20), histories within rtol 1e-8."""
    n = 256
    kw = dict(tolerance=1e-10, harness=harness, b=np.full(n, 2.0),
              x0=np.full(n, 1.0))
    rj = bis.solve_system("fdm:16", method, "ilu0", dtype=np.float64, **kw)
    rt = bt.solve_system("fdm:16", method, "ilu0", dtype=torch.float64,
                         device=CPU, **kw)
    assert rt.iter_count == rj.iter_count == iters and rt.converged
    _check_parity(rj, rt)


@pytest.mark.parametrize("harness", HARNESSES)
def test_ilu0_anderson_host_route_matches_jax(harness,
                                              numpy_branch):  # noqa: F811
    """CG + ILU(0) on an Anderson lattice (a dense diagonal: no
    factor-table pair), host route in both packages, tol 1e-8, the default
    b and x0: 123 iterations in both.  The lattice is indefinite and its
    first step multiplies the residual by ~740 (11.6 → 8610), so the
    histories part at reduction-order rounding after the first seven
    steps, as the Anderson goldens do (tests/test_reference_parity.py pins
    only their early history): the prefix is held to rtol 1e-8, the rest
    to the count and the stop."""
    kw = dict(tolerance=1e-8, harness=harness)
    rj = bis.solve_system(ANDERSON, "cg", "ilu0", dtype=np.float64, **kw)
    rt = bt.solve_system(ANDERSON, "cg", "ilu0", dtype=torch.float64,
                         device=CPU, **kw)
    assert rt.iter_count == rj.iter_count == 123
    assert rt.converged and rj.converged
    np.testing.assert_allclose(rt.residual_norms[:8], rj.residual_norms[:8],
                               rtol=1e-8)
    assert rt.final_residual_norm < 10.0 * rt.stopping_criteria


def test_trisolve_levels_match_jax(rng, numpy_branch):  # noqa: F811
    """build_trisolve packs the JAX package's level tables, and trisolve
    equals its level scan in float64 (rtol 1e-14), for both triangles of
    fdm:16 and the unit-diagonal ILU(0) L."""
    import jax.numpy as jnp
    from basic_iterative_solvers_tpu.factor import factor_LU
    from basic_iterative_solvers_tpu.ops import trisolve as jts
    from basic_iterative_solvers_tpu_torch import convert
    from basic_iterative_solvers_tpu_torch.ops import trisolve as tts
    Aj = bis.generators.from_source("fdm:16")
    f = factor_LU(Aj, ilu0=True)
    y = rng.standard_normal(Aj.n_rows)
    for T, D, upper in ((f.L_strict, f.L_D, False), (f.U_strict, f.U_D, True),
                        (factor_LU(Aj).L_strict, Aj.diagonal(), False)):
        Tt = convert.csr_from_numpy(T.n_rows, T.n_cols, T.row_ptr, T.col,
                                    T.val)
        tsj = jts.build_trisolve(T, D, upper=upper, dtype=np.float64)
        tst = tts.build_trisolve(Tt, D, upper=upper, dtype=torch.float64,
                                 device=CPU)
        assert (tst.n_levels, tst.max_width) == (tsj.n_levels, tsj.max_width)
        for name in ("rows", "cols", "vals", "dinv"):
            np.testing.assert_array_equal(getattr(tst, name).numpy(),
                                          np.asarray(getattr(tsj, name)))
        carried = convert.trisolve_levels_from_numpy(
            np.asarray(tsj.rows), np.asarray(tsj.cols), np.asarray(tsj.vals),
            np.asarray(tsj.dinv), tsj.n_rows, dtype=torch.float64,
            device=CPU)
        ref = np.asarray(jts.trisolve(tsj, jnp.asarray(y)))
        for ts in (tst, carried):
            np.testing.assert_allclose(
                tts.trisolve(ts, torch.from_numpy(y)).numpy(), ref,
                rtol=1e-14, atol=1e-14 * np.abs(ref).max())
