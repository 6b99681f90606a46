"""Coloured solves on the port's host-CSR path against the JAX package's,
in both harnesses: gs_mode "colored" with a mod colour spec (the
rank-space solves: BiCGSTAB + SGS, BiCGSTAB + ILU(0), GMRES + GS,
BiCGSTAB + backward GS), with greedy colours (masked sweeps), and the
slice-5b refusal of a grid colour spec on host CSR.  float64 on the CPU,
the same inputs in both packages; the JAX side's host code runs its NumPy
branch (`numpy_branch`).
"""
import pytest

import basic_iterative_solvers_tpu as bis
import basic_iterative_solvers_tpu_torch as bt
from basic_iterative_solvers_tpu_torch import generators as tgen
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
def test_grid_spec_on_host_csr_names_slice_5b(precond):
    """gs_mode "colored" on host CSR with a grid colour spec takes the JAX
    package's superblock form built from CSR, which is not ported: it
    raises NotImplementedError naming ROADMAP slice 5b."""
    spec = "hpcg:8x8x8"
    cfg = bt.SolverConfig(preconditioner=bt.PrecondType[precond],
                          gs_mode="colored",
                          color_spec=tgen.color_spec_for_source(spec))
    with pytest.raises(NotImplementedError, match="slice 5b"):
        bt.preprocessing(tgen.from_source(spec), cfg, device=CPU)
