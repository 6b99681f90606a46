"""Coloured solves on the port's host-CSR path against the JAX package's,
in both harnesses: gs_mode "colored" with a mod colour spec (the
rank-space solves: BiCGSTAB + SGS, BiCGSTAB + ILU(0), GMRES + GS,
BiCGSTAB + backward GS), with greedy colours (masked sweeps), and with a
grid colour spec (the superblock form built from CSR, slice 5b: CG + SGS,
CG + ILU(0), BiCGSTAB + GS, GMRES + backward GS on hpcg:16x16x16 and
fdm:16).  float64 on the CPU, the same inputs in both packages; the JAX
side's host code runs its NumPy branch (`numpy_branch`).
"""
import numpy as np
import pytest

import basic_iterative_solvers_tpu as bis
from basic_iterative_solvers_tpu_torch.ops import block_trisolve as tbt
from tests.test_torch_host_solve import _host_both
from tests.test_torch_ilu0_factor import numpy_branch  # noqa: F401
from tests.test_torch_methods import _check_parity

CPU = "cpu"
HARNESSES = ["host", "fused"]


@pytest.mark.parametrize("harness", HARNESSES)
@pytest.mark.parametrize("method,precond", [
    ("BICGSTAB", "SYMMETRIC_GAUSS_SEIDEL"), ("BICGSTAB", "ILU0"),
    ("GMRES", "GAUSS_SEIDEL"), ("BICGSTAB", "BACKWARDS_GAUSS_SEIDEL")])
def test_rankspace_colored_matches_jax(method, precond, harness,
                                       numpy_branch):  # noqa: F811
    """gs_mode "colored" on band:3000,2 with its mod-3 colouring: the
    rank-space solves in both packages; the same count and history."""
    spec = "band:3000,2"
    rj, rt, st = _host_both(
        spec, harness, method=method, precond=precond, gs_mode="colored",
        color_spec=bis.generators.color_spec_for_source(spec),
        tolerance=1e-10, restart_length=30)
    assert type(st.M.L_block or st.M.U_block).__name__ == "BlockedTriSolve"
    assert rt.iter_count == rj.iter_count and rt.converged
    _check_parity(rj, rt)


@pytest.mark.parametrize("harness", HARNESSES)
@pytest.mark.parametrize("spec,method,precond", [
    ("fdm:16", "SYMMETRIC_GAUSS_SEIDEL", "NONE"),
    ("fdm:16", "CONJUGATE_GRADIENT", "ILU0"),
    ("fdm:16", "BICGSTAB", "SYMMETRIC_GAUSS_SEIDEL")])
def test_greedy_colored_matches_jax(spec, method, precond, harness,
                                    numpy_branch):  # noqa: F811
    """gs_mode "colored" with no spec: greedy colours and masked sweeps in
    both packages (SGS as the method takes greedy colours too; it stops at
    max_iters, 400)."""
    rj, rt, st = _host_both(spec, harness, method=method, precond=precond,
                            gs_mode="colored", tolerance=1e-10,
                            max_iters=400)
    assert (st.color_arr if precond == "NONE" else st.M.color_arr) \
        is not None
    assert rt.iter_count == rj.iter_count and rt.converged == rj.converged
    _check_parity(rj, rt)


@pytest.mark.parametrize("precond", ["SYMMETRIC_GAUSS_SEIDEL", "ILU0"])
def test_grid_spec_on_host_csr_names_slice_5b(precond,
                                              numpy_branch):  # noqa: F811
    """gs_mode "colored" on host CSR with a grid colour spec takes the
    superblock form built from CSR (ROADMAP slice 5b): hpcg:8x8x8's pair is
    const mode with a per-row D for SGS, plane mode (L) for ILU(0), in
    both packages, and CG takes the JAX package's count and history."""
    spec = "hpcg:8x8x8"
    rj, rt, st = _host_both(
        spec, "fused", method="CONJUGATE_GRADIENT", precond=precond,
        gs_mode="colored",
        color_spec=bis.generators.color_spec_for_source(spec),
        tolerance=1e-10)
    L, U = st.M.L_block, st.M.U_block
    assert isinstance(L, tbt.SuperBlockTriSolve)
    assert L.dinv_rows is not None
    assert (L.is_const, U.is_const) == ((True, True) if precond != "ILU0"
                                        else (False, False))
    assert rt.converged
    _check_parity(rj, rt)


#: gs_mode "colored" with the grid spec: the cases of the slice-5b route
GRID_CASES = [("CONJUGATE_GRADIENT", "SYMMETRIC_GAUSS_SEIDEL"),
              ("CONJUGATE_GRADIENT", "ILU0"),
              ("BICGSTAB", "GAUSS_SEIDEL"),
              ("GMRES", "BACKWARDS_GAUSS_SEIDEL")]


@pytest.mark.parametrize("harness", HARNESSES)
@pytest.mark.parametrize("method,precond", GRID_CASES)
@pytest.mark.parametrize("spec", ["hpcg:16x16x16", "fdm:16"])
def test_grid_colored_matches_jax(spec, method, precond, harness,
                                  numpy_branch):  # noqa: F811
    """The superblock solves built from host CSR under the source's grid
    colour spec in both packages: the same count and history (rtol 1e-8),
    GMRES(30) with its restarts.  BiCGSTAB + GS on fdm:16 amplifies a
    one-ulp difference of iteration 1 (reduction order) ~100× an
    iteration from its 10th on, the same in either package's two
    harnesses (each pair equal bit for bit): its history holds rtol 1e-8
    down to 1e-6·‖r0‖ and rtol 1e-4 below (5.6e-5 at its end)."""
    rj, rt, st = _host_both(
        spec, harness, method=method, precond=precond, gs_mode="colored",
        color_spec=bis.generators.color_spec_for_source(spec),
        tolerance=1e-10, restart_length=30)
    B = st.M.L_block or st.M.U_block
    assert isinstance(B, tbt.SuperBlockTriSolve)
    assert (st.M.L_block is None) == (precond == "BACKWARDS_GAUSS_SEIDEL")
    assert (st.M.U_block is None) == (precond == "GAUSS_SEIDEL")
    assert rt.converged and rt.iter_count == rj.iter_count
    if method != "BICGSTAB":
        _check_parity(rj, rt)
        return
    h, g = rj.residual_norms[:-1], rt.residual_norms[:-1]
    above = h >= 1e-6 * h[0]
    np.testing.assert_allclose(g[above], h[above], rtol=1e-8)
    np.testing.assert_allclose(g, h, rtol=1e-4)
