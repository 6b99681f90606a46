"""DIA solves from the device builders, and the host-CSR path's options,
against the JAX package's, in both harnesses: DIA CG/BiCGSTAB/GMRES and
two-stage-preconditioned BiCGSTAB, num_scale, perm_mode "rcm" and
auto_rcm, dense/scipy/.mtx sources and A_dev injection.  float64 on the CPU, the same
inputs in both packages; the JAX side's host code runs its NumPy branch
(`numpy_branch`).
"""
import numpy as np
import pytest
import torch

import basic_iterative_solvers_tpu as bis
import basic_iterative_solvers_tpu_torch as bt
from basic_iterative_solvers_tpu_torch import generators as tgen
from tests.test_torch_host_solve import _host_both
from tests.test_torch_ilu0_factor import numpy_branch  # noqa: F401
from tests.test_torch_methods import _check_parity

CPU = "cpu"
HARNESSES = ["host", "fused"]


@pytest.mark.parametrize("harness", HARNESSES)
@pytest.mark.parametrize("method,kw,iters", [
    ("cg", {}, 27), ("bi", {}, 18), ("gm", {"restart_length": 50}, 27),
    ("bi", {"preconditioner": "s2st", "precond_inner_iters": 1}, 16),
    ("cg", {"num_scale": True}, 26)])
def test_dia_device_path_matches_jax(method, kw, iters, harness):
    """DIA solves of hpcg:16x16x16 from the device builders, b = 2, x0 =
    1, tol 1e-10: the JAX package's counts and histories."""
    kw = dict(kw)
    precond = kw.pop("preconditioner", None)
    n = 16 ** 3
    args = dict(tolerance=1e-10, harness=harness, b=np.full(n, 2.0),
                x0=np.full(n, 1.0), **kw)
    rj = bis.solve_system("hpcg:16x16x16", method, precond,
                          matrix_format="dia", dtype=np.float64, **args)
    rt = bt.solve_system("hpcg:16x16x16", method, precond,
                         matrix_format="dia", dtype=torch.float64,
                         device=CPU, **args)
    assert rt.iter_count == rj.iter_count == iters and rt.converged
    _check_parity(rj, rt)


@pytest.mark.parametrize("harness", HARNESSES)
@pytest.mark.parametrize("cfg", [
    dict(method="CONJUGATE_GRADIENT", precond="JACOBI", num_scale=True),
    dict(method="CONJUGATE_GRADIENT", perm_mode="rcm"),
    dict(method="BICGSTAB", precond="SYMMETRIC_GAUSS_SEIDEL",
         perm_mode="rcm"),
    dict(method="GMRES", precond="ILU0", perm_mode="rcm",
         restart_length=20)],
    ids=["num_scale", "rcm_cg", "rcm_bi_sgs", "rcm_gm_ilu0"])
def test_scale_and_rcm_match_jax(cfg, harness, numpy_branch):  # noqa: F811
    """num_scale and perm_mode "rcm" on the host path: the same counts and
    histories, and x* mapped back to the caller's ordering."""
    rj, rt, st = _host_both("sband:1500,6,260", harness, tolerance=1e-10,
                            **dict(cfg))
    assert rt.iter_count == rj.iter_count and rt.converged
    _check_parity(rj, rt)
    np.testing.assert_allclose(rt.x_star.numpy(), np.asarray(rj.x_star),
                               rtol=1e-8, atol=1e-12)
    if cfg.get("perm_mode") == "rcm":
        assert st.inv_perm is not None


def test_auto_rcm_avoids_the_gather_ell(numpy_branch):  # noqa: F811
    """A scattered pattern past the lane-ELL window takes RCM (as the JAX
    package does) and then lane-ELL; with auto_rcm off it falls to the
    gather ELL and warns."""
    from basic_iterative_solvers_tpu_torch.device_matrix import (
        GatherFallbackWarning, LANE_ELL_MAX_SPAN)
    import basic_iterative_solvers_tpu_torch.device_matrix as tdm
    A = tgen.from_source("sband:1500,6,260")
    cfg = bt.SolverConfig(tolerance=1e-8)
    orig = tdm.LANE_ELL_MAX_SPAN
    try:
        tdm.LANE_ELL_MAX_SPAN = 1
        with pytest.warns(GatherFallbackWarning):
            st = bt.preprocessing(A, cfg, device=CPU)
        assert type(st.A).__name__ == "DeviceELL"
        r = bt.solve(st)
        assert r.converged
    finally:
        tdm.LANE_ELL_MAX_SPAN = orig
    assert LANE_ELL_MAX_SPAN == 2048
    st = bt.preprocessing(A, bt.SolverConfig(tolerance=1e-8,
                                             auto_rcm=False), device=CPU)
    assert type(st.A).__name__ == "DeviceLaneELL" and st.inv_perm is None


def test_dense_scipy_and_mtx_sources(tmp_path):
    """solve_system takes a dense ndarray, a scipy matrix and a .mtx path,
    each through the host route."""
    import scipy.sparse as sp
    from basic_iterative_solvers_tpu_torch.io import write_mtx
    A = tgen.from_source("fdm:8")
    path = tmp_path / "fdm8.mtx"
    write_mtx(path, A)
    dense = A.to_dense()
    counts = {bt.solve_system(src, "cg", tolerance=1e-10,
                              device=CPU).iter_count
              for src in (dense, sp.csr_matrix(dense), str(path), A)}
    assert len(counts) == 1
    with pytest.raises(TypeError, match="unsupported matrix source"):
        bt.solve_system([[1.0]], device=CPU)


def test_a_dev_injection(numpy_branch):  # noqa: F811
    """preprocessing(A, A_dev=stencil): the stencil serves every SpMV while
    the host CSR drives the natural-order SGS set-up; the same iterations
    as the CSR's own DIA operator and the JAX package's injection.  With a
    reordering or scaling the injection is refused."""
    A = tgen.from_source("fdm:16")
    cfg = dict(method="CONJUGATE_GRADIENT",
               preconditioner="SYMMETRIC_GAUSS_SEIDEL", tolerance=1e-10)
    op = bt.stencil_op.from_source_operator("fdm:16", torch.float64,
                                            device=CPU)
    tc = lambda **k: bt.SolverConfig(  # noqa: E731
        method=bt.SolverType[cfg["method"]],
        preconditioner=bt.PrecondType[cfg["preconditioner"]],
        tolerance=cfg["tolerance"], **k)
    st = bt.preprocessing(A, tc(), A_dev=op, device=CPU)
    assert st.A is op and st.M.L_solve is not None
    rt = bt.solve(st)
    r_dia = bt.solve(bt.preprocessing(A, tc(), device=CPU))
    Aj = bis.generators.from_source("fdm:16")
    rj = bis.solve(bis.preprocessing(Aj, bis.SolverConfig(
        method=bis.SolverType[cfg["method"]],
        preconditioner=bis.PrecondType[cfg["preconditioner"]],
        tolerance=cfg["tolerance"], dtype=np.float64),
        A_dev=bis.stencil_op.from_source_operator("fdm:16",
                                                  dtype=np.float64)))
    assert rt.iter_count == r_dia.iter_count == rj.iter_count
    assert rt.converged
    _check_parity(rj, rt)
    for bad in (dict(perm_mode="rcm"), dict(num_scale=True)):
        with pytest.raises(ValueError, match="A_dev injection"):
            bt.preprocessing(A, tc(**bad), A_dev=op, device=CPU)
