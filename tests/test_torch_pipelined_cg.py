"""Pipelined CG (cg_flavor="pipelined") of the port against the JAX
package's, with no preconditioner, Jacobi, Chebyshev (λmax carried across)
and multigrid, in float64 and float32.

Step by step (`iterate` driven by hand in both packages): the same
residual-replacement steps (k_rep returns to 0 on the same iterations),
and recurrence norms within rtol 1e-8 (float64) up to the first
replacement.  float32 rounds differently in the two packages and the
pipelined recurrences amplify it (measured 1.2e-4 after nine steps with
no preconditioner), so float32 is held at rtol 1e-3 there.  Whole solves
(the host harness here, the fused one in test_torch_pipelined_fused.py):
equal iteration and replacement counts, histories as above up to the
first replacement and within rtol 1e-4 (float64) after it, where the
replaced residual carries the packages' last-bit differences.
"""
import numpy as np
import pytest
import torch

import jax

import basic_iterative_solvers_tpu as bis
from basic_iterative_solvers_tpu.solvers.factory import make_method as jmake

import basic_iterative_solvers_tpu_torch as bt
from basic_iterative_solvers_tpu_torch import convert
from basic_iterative_solvers_tpu_torch.solvers import make_method as tmake

CPU = "cpu"
SPEC = "hpcg:16x16x16"
TORCH_DTYPE = {np.float64: torch.float64, np.float32: torch.float32}
PRECONDS = ["none", "jacobi", "chebyshev", "multigrid"]
#: tolerances of the whole solves: above the float32 floor in float32
TOL = {np.float64: 1e-10, np.float32: 1e-4}
HEAD_RTOL = {np.float64: 1e-8, np.float32: 1e-3}


def _setups(pname, dtype, harness="host"):
    pj = {"none": bis.PrecondType.NONE, "jacobi": bis.PrecondType.JACOBI,
          "chebyshev": bis.PrecondType.CHEBYSHEV,
          "multigrid": bis.PrecondType.MULTIGRID}[pname]
    # a degree-4 coarsest solve keeps the JAX package's compile short
    kw = dict(dtype=dtype, cg_flavor="pipelined", harness=harness,
              tolerance=TOL[dtype], max_iters=200, mg_coarse_degree=4)
    Aj = bis.stencil_op.from_source_operator(SPEC, dtype=dtype)
    n = Aj.n_rows
    bv, xv = np.full(n, 2.0, dtype), np.full(n, 1.0, dtype)
    sj = bis.preprocessing_device(
        Aj, bis.SolverConfig(preconditioner=pj, **kw), b=bv, x0=xv)
    At = bt.stencil_op.from_source_operator(SPEC, TORCH_DTYPE[dtype],
                                            device=CPU)
    st = bt.preprocessing_device(
        At, bt.SolverConfig(preconditioner=bt.PrecondType(pj.value), **kw),
        b=torch.from_numpy(bv), x0=torch.from_numpy(xv))
    if pname == "chebyshev":
        convert.carry_cheby_lmax(st.M, np.asarray(sj.M.cheby_lmax))
    return sj, st


def _steps(sj, st, n_steps):
    """(k_rep, ‖r‖) after each of n_steps steps, in each package."""
    mj, mt = jmake(sj), tmake(st)
    s_j, s_t = mj.init_state(), mt.init_state()
    step_j = jax.jit(mj.iterate)
    kj, kt, rj, rt = [], [], [], []
    for _ in range(n_steps):
        s_j, s_t = step_j(s_j), mt.iterate(s_t)
        kj.append(int(s_j["k_rep"]))
        kt.append(int(s_t["k_rep"]))
        rj.append(float(s_j["residual_norm"]))
        rt.append(float(s_t["residual_norm"]))
    return kj, kt, np.asarray(rj), np.asarray(rt), mt.replacements


def _check_history(rj, rt, first, dtype):
    """Histories: HEAD_RTOL up to the first replacement (history index
    `first`), rtol 1e-4 after it in float64."""
    hj, ht = rj.residual_norms[:-1], rt.residual_norms[:-1]
    np.testing.assert_allclose(ht[:first + 1], hj[:first + 1],
                               rtol=HEAD_RTOL[dtype])
    if dtype == np.float64:
        np.testing.assert_allclose(ht, hj, rtol=1e-4)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("pname", PRECONDS)
def test_pipelined_steps_and_host_solve_match_jax(pname, dtype):
    """Step by step over the JAX solve's iteration count: the same
    replacement steps, the norms up to the first; then the whole solve in
    the host harness: the same iteration and replacement counts."""
    sj, st = _setups(pname, dtype)
    rj = bis.solve(sj)
    kj, kt, nj, nt, n_rep = _steps(sj, st, rj.iter_count)
    assert kt == kj
    assert n_rep == kj.count(0) > 0
    first = kj.index(0)
    np.testing.assert_allclose(nt[:first + 1], nj[:first + 1],
                               rtol=HEAD_RTOL[dtype])
    mt = tmake(st)
    rt = bt.solve(st, method=mt)
    assert rj.converged and rt.converged
    assert rt.iter_count == rj.iter_count
    assert mt.replacements == n_rep
    _check_history(rj, rt, first + 1, dtype)
