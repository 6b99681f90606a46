"""CG + geometric multigrid (`-p mg`) solves of the port against the JAX
package's, in float64: the same iteration counts, and histories within
rtol 1e-8 down to 1e-8·‖r₀‖ (the packages' reduction and transfer orders
differ in the last bit).  Below that, down to the 1e-10 stop, the solve
amplifies those bits: the JAX package's own host and fused harnesses
differ by 5.7e-7 at fdm:64's last step, so the tail is held at rtol 1e-5.
The host harness and the main path's entry points (`solve_system`,
`preprocessing_device` on a stencil) here; the fused harness in
test_torch_mg_fused.py.
"""
import numpy as np
import pytest
import torch

import basic_iterative_solvers_tpu as bis

import basic_iterative_solvers_tpu_torch as bt

CPU = "cpu"


def _solve_both(spec, harness, **cfg):
    Aj = bis.stencil_op.from_source_operator(spec, dtype=np.float64)
    n = Aj.n_rows
    bv, xv = np.full(n, 2.0), np.full(n, 1.0)
    kw = dict(dtype=np.float64, harness=harness, tolerance=1e-10,
              max_iters=200, **cfg)
    rj = bis.solve(bis.preprocessing_device(
        Aj, bis.SolverConfig(preconditioner=bis.PrecondType.MULTIGRID, **kw),
        b=bv, x0=xv))
    At = bt.stencil_op.from_source_operator(spec, torch.float64, device=CPU)
    rt = bt.solve(bt.preprocessing_device(
        At, bt.SolverConfig(preconditioner=bt.PrecondType.MULTIGRID, **kw),
        b=torch.from_numpy(bv), x0=torch.from_numpy(xv)))
    return rj, rt


def _check(rj, rt):
    assert rt.converged and rj.converged
    assert rt.iter_count == rj.iter_count
    hj, ht = rj.residual_norms[:-1], rt.residual_norms[:-1]
    head = hj >= 1e-8 * hj[0]
    np.testing.assert_allclose(ht[head], hj[head], rtol=1e-8)
    np.testing.assert_allclose(ht, hj, rtol=1e-5)
    # the explicit residual of a 1e-10 solve sits near the rounding floor
    np.testing.assert_allclose(rt.final_residual_norm,
                               rj.final_residual_norm, rtol=1e-3)


SPECS = ["hpcg:16x16x16", "hpcg:32x24x20", "fdm:64"]


@pytest.mark.parametrize("spec", SPECS)
def test_cg_mg_f64_parity(spec):
    rj, rt = _solve_both(spec, "host")
    _check(rj, rt)
    assert rt.iter_count <= 15         # grid-size-independent counts


def test_cg_mg_injection_rediscretize():
    """HPCG's own scheme: injection transfers, rediscretized levels."""
    rj, rt = _solve_both("hpcg:16x16x16", "host", mg_transfer="injection")
    _check(rj, rt)


def test_solve_system_routes_mg_to_the_stencil():
    """`-p mg` on a spec builds the matrix-free stencil (the main path's
    route), with the JAX package's count."""
    rt = bt.solve_system("hpcg:16x16x16", "cg", "mg", tolerance=1e-10,
                         device=CPU)
    rj = bis.solve_system("hpcg:16x16x16", "cg", "mg", tolerance=1e-10)
    assert rt.converged and rt.iter_count == rj.iter_count
    _check(rj, rt)
