"""The Chebyshev preconditioner (`-p cheby`) of the port against the JAX
package's: the power-iteration λmax (float64, rtol 1e-12: its reductions
are ordered differently), one apply on a carried λmax (rtol 1e-12 in
float64, 1e-5 in float32), and CG, GMRES and BiCGSTAB + Chebyshev in
float64 on the three routes (stencil, DIA on the device, host CSR):
equal counts, histories within rtol 1e-8 down to 1e-8·‖r₀‖ and 1e-5 below
(last-bit differences amplified by the solve).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import basic_iterative_solvers_tpu as bis
from basic_iterative_solvers_tpu import precond as jpre

import basic_iterative_solvers_tpu_torch as bt
from basic_iterative_solvers_tpu_torch import convert
from basic_iterative_solvers_tpu_torch import precond as tpre

CPU = "cpu"
TORCH_DTYPE = {np.float64: torch.float64, np.float32: torch.float32}
ANDERSON = "anderson:Lx=6,Ly=5,Lz=4,t=1.0,ranpot=1.0,seed=3"


def _ops(route, spec, dtype):
    if route == "stencil":
        return (bis.stencil_op.from_source_operator(spec, dtype=dtype),
                bt.stencil_op.from_source_operator(spec, TORCH_DTYPE[dtype],
                                                   device=CPU))
    if route == "dia":
        return (bis.dia.from_source_device(spec, dtype=dtype),
                bt.dia.from_source_device(spec, dtype=TORCH_DTYPE[dtype],
                                          device=CPU))
    return bis.generators.from_source(spec), bt.generators.from_source(spec)


_METHOD = {"cg": bis.SolverType.CONJUGATE_GRADIENT,
           "gmres": bis.SolverType.GMRES, "bicgstab": bis.SolverType.BICGSTAB}


def _setups(route, spec, dtype, method="cg", **cfg):
    """Both packages' setups of the same system (b = 2, x₀ = 1)."""
    Aj, At = _ops(route, spec, dtype)
    n = Aj.n_rows
    bv, xv = np.full(n, 2.0, dtype), np.full(n, 1.0, dtype)
    mj = _METHOD[method]
    cj = bis.SolverConfig(dtype=dtype, method=mj,
                          preconditioner=bis.PrecondType.CHEBYSHEV, **cfg)
    ct = bt.SolverConfig(dtype=dtype, method=bt.SolverType(mj.value),
                         preconditioner=bt.PrecondType.CHEBYSHEV, **cfg)
    bt_, xt = torch.from_numpy(bv), torch.from_numpy(xv)
    if route == "host":
        return (bis.preprocessing(Aj, cj, b=bv, x0=xv),
                bt.preprocessing(At, ct, b=bt_, x0=xt, device=CPU))
    return (bis.preprocessing_device(Aj, cj, b=bv, x0=xv),
            bt.preprocessing_device(At, ct, b=bt_, x0=xt))


CASES = [("stencil", "hpcg:16x16x16"), ("stencil", ANDERSON),
         ("dia", "fdm:16"), ("host", "fdm:16")]


@pytest.mark.parametrize("route,spec", CASES)
def test_power_lmax_matches_jax(route, spec):
    sj, st = _setups(route, spec, np.float64)
    np.testing.assert_allclose(float(st.M.cheby_lmax),
                               float(sj.M.cheby_lmax), rtol=1e-12)
    np.testing.assert_array_equal(st.M.A_D_inv.numpy(),
                                  np.asarray(sj.M.A_D_inv)[:st.n])


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-12),
                                        (np.float32, 1e-5)])
@pytest.mark.parametrize("route,spec", CASES)
def test_cheby_apply_on_carried_lmax(route, spec, dtype, rtol, rng):
    sj, st = _setups(route, spec, dtype)
    convert.carry_cheby_lmax(st.M, np.asarray(sj.M.cheby_lmax))
    y = rng.standard_normal(st.n).astype(dtype)
    zj = np.asarray(jpre.apply_preconditioner(sj.M, jnp.asarray(y)))[:st.n]
    zt = tpre.apply_preconditioner(st.M, torch.from_numpy(y))
    assert zt.dtype == TORCH_DTYPE[dtype]
    np.testing.assert_allclose(zt.numpy(), zj, rtol=rtol,
                               atol=rtol * np.abs(zj).max())


METHODS = {"cg": dict(tolerance=1e-10),
           "gmres": dict(tolerance=1e-8, restart_length=30),
           "bicgstab": dict(tolerance=1e-10)}


@pytest.mark.parametrize("method", sorted(METHODS))
@pytest.mark.parametrize("route,spec", [("stencil", "hpcg:16x16x16"),
                                        ("dia", "fdm:16"),
                                        ("host", "fdm:16")])
def test_krylov_cheby_f64_parity(route, spec, method):
    sj, st = _setups(route, spec, np.float64, method, harness="host",
                     max_iters=300, **METHODS[method])
    rj, rt = bis.solve(sj), bt.solve(st)
    assert rj.converged and rt.converged
    assert rt.iter_count == rj.iter_count
    hj, ht = rj.residual_norms[:-1], rt.residual_norms[:-1]
    head = hj >= 1e-8 * hj[0]
    np.testing.assert_allclose(ht[head], hj[head], rtol=1e-8)
    np.testing.assert_allclose(ht, hj, rtol=1e-5)


def test_solve_system_takes_cheby_on_dia():
    """`-p cheby` on a spec takes the DIA route in both packages (device
    native), with equal counts."""
    rt = bt.solve_system("fdm:16", "cg", "cheby", tolerance=1e-10,
                         device=CPU)
    rj = bis.solve_system("fdm:16", "cg", "cheby", tolerance=1e-10)
    assert rt.converged and rt.iter_count == rj.iter_count
