"""The port's GS-family solves against the JAX package's on fdm:16 (the
masked colour sweeps: red-black is no grid colouring, so no superblock
pair), both harnesses, with the case table and settings of
tests/test_torch_gs_solve_hpcg.py; and the GS family's routing and
refusals."""
import pytest
import torch

import basic_iterative_solvers_tpu_torch as bt
from basic_iterative_solvers_tpu_torch import stencil_op as tso
from basic_iterative_solvers_tpu_torch.ops import block_trisolve as tbt
from tests.test_torch_gs_solve_hpcg import cases, route, run_parity

#: the port's entry points run on the card unless asked; these tests
#: run on the CPU
CPU = "cpu"


@pytest.mark.parametrize("harness", ["host", "fused"])
@pytest.mark.parametrize("method,precond,cfg,_hpcg,iters", cases())
def test_fdm_parity(method, precond, cfg, _hpcg, iters, harness):
    """CG's explicit final residual here is ~1e-11·‖r0‖ (3.5e-10 and
    1.2e-9), where one ulp of x* (~2e-14) can move ‖b − A·x*‖ by ~1e-12:
    the two packages' differ by 1.7e-4 relative, so rtol 1e-3 there."""
    run_parity("fdm:16", harness, method, precond, cfg, iters,
               1e-3 if method == "CONJUGATE_GRADIENT" else 1e-4)
    assert route("fdm:16", method, precond, cfg) == (False, False)


def test_cpu_gs_family_launches_no_kernel():
    tso.stencil_gs_color_step.launches = tbt.super_level.launches = 0
    for spec in ("hpcg:8x8x8", "fdm:8"):
        res = bt.solve_system(spec, "cg", "sgs", tolerance=1e-8,
                              matrix_format="stencil", device=CPU)
        assert res.converged
    assert tso.stencil_gs_color_step.launches == 0
    assert tbt.super_level.launches == 0


@pytest.mark.parametrize("kwargs", [
    {"method": bt.SolverType.GAUSS_SEIDEL, "gs_mode": "levels"},
    {"preconditioner": bt.PrecondType.SYMMETRIC_GAUSS_SEIDEL,
     "gs_mode": "levels"},
], ids=["gs_method", "sgs_precond"])
def test_levels_mode_needs_the_host_csr_path(kwargs):
    A = tso.from_source_operator("hpcg:8x6x4", torch.float64, device=CPU)
    with pytest.raises(ValueError, match="host CSR path"):
        bt.preprocessing_device(A, bt.SolverConfig(**kwargs))


@pytest.mark.parametrize("precond", ["gs", "bgs", "sgs"])
def test_gs_preconditioners_take_one_triangle_or_both(precond):
    """-p gs keeps L, -p bgs keeps U, -p sgs both (L with D), as the JAX
    package's setup does; Anderson's dense diagonal takes the sweeps."""
    A = tso.from_source_operator("hpcg:8x8x8", torch.float64, device=CPU)
    pt = bt.PRECOND_CLI_NAMES[precond]
    M = bt.preprocessing_device(A, bt.SolverConfig(preconditioner=pt)).M
    assert (M.L_block is not None) == (precond != "bgs")
    assert (M.U_block is not None) == (precond != "gs")
    assert M.A_full_dev is None
    if precond == "sgs":
        assert M.L_block.d == 26.0
    An = tso.from_source_operator("anderson:Lx=4,Ly=4,Lz=4,ranpot=1.0",
                                  torch.float64, device=CPU)
    Mn = bt.preprocessing_device(An, bt.SolverConfig(preconditioner=pt)).M
    assert Mn.L_block is None and Mn.U_block is None
    assert Mn.A_full_dev is An and Mn.color_spec.kind == "parity"
