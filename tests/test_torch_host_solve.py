"""Whole solves through the port's host-CSR routes against the JAX
package's, in both harnesses: solve_system's routing (a generator spec
takes DIA as in the JAX package) and lane-ELL CG.  float64 on the CPU,
the same inputs in both packages; the JAX side's host code runs its NumPy
branch (`numpy_branch`).  The coloured solves are in
test_torch_host_colored.py, the DIA device path and the host path's
options in test_torch_host_options.py.
"""
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


@pytest.mark.parametrize("harness", HARNESSES)
@pytest.mark.parametrize("precond,iters,converged", [("sgs", 22, True),
                                                     ("gs", 1000, False)])
def test_solve_system_routes_specs_to_dia(precond, iters, converged,
                                          harness):
    """The routing repair: solve_system("hpcg:16x16x16", "cg", "sgs"/"gs")
    builds a DeviceDIA in both packages, so both run the masked sweeps in
    the mod colouring and take the same counts (22; 1000, not converged)
    and histories (rtol 1e-8).  The port used to build the stencil here,
    with its grid colouring: 23 iterations and ‖r₁‖ = 127.859 against the
    JAX package's 22 and 116.746."""
    kw = dict(tolerance=1e-10, harness=harness)
    rj = bis.solve_system("hpcg:16x16x16", "cg", precond, dtype=np.float64,
                          **kw)
    rt = bt.solve_system("hpcg:16x16x16", "cg", precond, dtype=torch.float64,
                         device=CPU, **kw)
    assert rt.iter_count == rj.iter_count == iters
    assert rt.converged == converged
    assert rt.residual_norms[1] == pytest.approx(
        116.74633738 if precond == "sgs" else 110.75266434, rel=1e-8)
    _check_parity(rj, rt, final_rtol=1e-3)


def test_solve_system_builds_dia_by_default(monkeypatch):
    """A spec with a device-native method builds DIA ("auto", "dia"), a
    stencil when asked ("stencil"), and host CSR otherwise."""
    built = []
    for name in ("preprocessing", "preprocessing_device"):
        orig = getattr(bt, name)
        monkeypatch.setattr(bt, name, lambda A, *a, _o=orig, **k: (
            built.append(type(A).__name__), _o(A, *a, **k))[1])
    for fmt, method, precond, kw in (
            ("auto", "cg", None, {}), ("dia", "bi", "j", {}),
            ("stencil", "cg", "sgs", {}), ("auto", "cg", "ilu0", {}),
            ("auto", "gs", None, {"gs_mode": "levels"}),
            ("auto", "cg", None, {"perm_mode": "rcm"})):
        bt.solve_system("fdm:8", method, precond, matrix_format=fmt,
                        tolerance=1e-6, device=CPU, **kw)
    assert built == ["DeviceDIA", "DeviceDIA", "DeviceStencil", "MatrixCSR",
                     "MatrixCSR", "MatrixCSR"]
    with pytest.raises(ValueError, match="matrix_format='stencil'"):
        bt.solve_system("fdm:8", "gs", matrix_format="stencil",
                        gs_mode="levels", device=CPU)


def _host_both(spec, harness, **cfg):
    """The same host-CSR solve in both packages, b = 2, x0 = 1."""
    A = tgen.from_source(spec)
    Aj = bis.generators.from_source(spec)
    bv, xv = np.full(A.n_rows, 2.0), np.full(A.n_rows, 1.0)
    S, P = cfg.pop("method"), cfg.pop("precond", "NONE")
    rj = bis.solve(bis.preprocessing(Aj, bis.SolverConfig(
        method=bis.SolverType[S], preconditioner=bis.PrecondType[P],
        dtype=np.float64, harness=harness, **cfg), b=bv, x0=xv))
    s = cfg.get("color_spec")
    if s is not None:
        cfg["color_spec"] = bt.coloring.ColorSpec(s.kind, s.n_colors,
                                                  s.params)
    st = bt.preprocessing(A, bt.SolverConfig(
        method=bt.SolverType[S], preconditioner=bt.PrecondType[P],
        dtype=torch.float64, harness=harness, **cfg),
        b=torch.from_numpy(bv), x0=torch.from_numpy(xv), device=CPU)
    return rj, bt.solve(st), st


@pytest.mark.parametrize("harness", HARNESSES)
def test_lane_ell_cg_matches_jax(harness, numpy_branch):  # noqa: F811
    """CG on sband:1500,6,260 through preprocessing: "auto" picks lane-ELL
    in both packages; the same count and history."""
    rj, rt, st = _host_both("sband:1500,6,260", harness,
                            method="CONJUGATE_GRADIENT", tolerance=1e-10)
    assert type(st.A).__name__ == "DeviceLaneELL"
    assert rt.iter_count == rj.iter_count and rt.converged
    _check_parity(rj, rt)
