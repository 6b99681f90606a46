"""Whole solves on the port's 8-shard mesh against the JAX package:
the lane-ELL cases of tests/test_mesh_pallas.py (general sparsity through
the shard-local #5), float64, with its `_check` rule, as in
test_torch_mesh_solve.py: its default-lane case against the JAX package's
shard_map mode, its slow cases against the JAX package's single-device
solve.  The JAX side's host code runs its NumPy branch (`numpy_branch`).
"""
import pytest
import torch

import basic_iterative_solvers_tpu as bis
from basic_iterative_solvers_tpu.parallel import make_mesh as jmake_mesh
from basic_iterative_solvers_tpu.parallel import shard_setup as jshard_setup

import basic_iterative_solvers_tpu_torch as bt
from basic_iterative_solvers_tpu_torch.parallel import make_mesh, shard_setup
from basic_iterative_solvers_tpu_torch.parallel import mesh_ops as tmo
from tests.test_torch_ilu0_factor import numpy_branch  # noqa: F401
from tests.test_torch_mesh_solve import (CPU, _cfgs, _check,  # noqa: F401
                                         interpret)


def _sband():
    return (bis.generators.scattered_band(2048, 6, 200, seed=3),
            bt.generators.scattered_band(2048, 6, 200, seed=3))


def test_mesh_lane_ell_cg_jacobi(interpret, numpy_branch):  # noqa: F811
    """Scattered-pattern CG + Jacobi through the shard-local #5 against
    the JAX package's mesh solve."""
    Aj, At = _sband()
    cj, ct = _cfgs("CONJUGATE_GRADIENT", "JACOBI", matrix_format="lane_ell")
    rj = bis.solve(jshard_setup(bis.preprocessing(Aj, cj), jmake_mesh(8),
                                mode="shard_map"))
    s8 = shard_setup(bt.preprocessing(At, ct, device=CPU),
                     make_mesh(8, device=CPU), mode="shard_map")
    assert isinstance(s8.A, tmo.MeshLaneELL)
    _check(bt.solve(s8), rj)


LANE_CASES = {
    "two_stage_bicgstab": ("BICGSTAB", "TWO_STAGE_GS", {}),
    "chebyshev": ("CONJUGATE_GRADIENT", "CHEBYSHEV", {}),
    "greedy_sgs": ("SYMMETRIC_GAUSS_SEIDEL", "NONE",
                   dict(gs_mode="colored")),
    "greedy_pcg_sgs": ("CONJUGATE_GRADIENT", "SYMMETRIC_GAUSS_SEIDEL",
                       dict(gs_mode="colored")),
}


@pytest.mark.parametrize("case", sorted(LANE_CASES))
def test_mesh_lane_ell_solves_match_jax(case, numpy_branch):  # noqa: F811
    """BiCGSTAB + two-stage (the strict parts as mesh lane-ELL), CG +
    Chebyshev (the full operator mesh-wrapped), and exact greedy-coloured
    SGS as the method and as CG's preconditioner (the colour array a row
    vector like the others, each sweep step one mesh SpMV)."""
    method, precond, kw = LANE_CASES[case]
    Aj, At = _sband()
    cj, ct = _cfgs(method, precond, matrix_format="lane_ell", **kw)
    r1 = bis.solve(bis.preprocessing(Aj, cj))
    s8 = shard_setup(bt.preprocessing(At, ct, device=CPU),
                     make_mesh(8, device=CPU), mode="shard_map")
    assert isinstance(s8.A, tmo.MeshLaneELL)
    if case == "two_stage_bicgstab":
        assert isinstance(s8.M.L_strict_dev, tmo.MeshLaneELL)
    if case == "chebyshev":
        assert s8.M.A_full_dev is s8.A
    if case.startswith("greedy"):
        carr = s8.color_arr if precond == "NONE" else s8.M.color_arr
        assert carr is not None and carr.shape == (At.n_rows,)
    _check(bt.solve(s8), r1)
