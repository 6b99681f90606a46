"""The one-call entry point with exact coloured ILU(0) against the JAX
package's, and the operators that ILU(0) on the device path refuses."""
import numpy as np
import pytest
import torch

import basic_iterative_solvers_tpu as bis
import basic_iterative_solvers_tpu_torch as bt
from tests.test_torch_methods import _check_parity

#: the port's entry points run on the card unless asked; these tests
#: run on the CPU
CPU = "cpu"

ANDERSON = "anderson:Lx=4,Ly=4,Lz=4,ranpot=1.0"


@pytest.mark.parametrize("spec,iters", [("hpcg:16x16x16", 19),
                                        ("hpcg:32x24x20", 29)])
def test_solve_system_cg_ilu0_matches_jax(spec, iters):
    """solve_system(spec, "cg", "ilu0") with the default b and x₀, host
    harness, float64, tolerance 1e-8: the JAX package's iteration count."""
    kw = dict(harness="host", tolerance=1e-8)
    rj = bis.solve_system(spec, "cg", "ilu0", dtype=np.float64, **kw)
    rt = bt.solve_system(spec, "cg", "ilu0", dtype=torch.float64,
                         device=CPU, **kw)
    assert rj.iter_count == rt.iter_count == iters
    assert rt.converged and rt.preconditioner == bt.PrecondType.ILU0
    _check_parity(rj, rt)


@pytest.mark.parametrize("spec", ["fdm:16", ANDERSON])
def test_ilu0_refused_off_the_grid_stencils(spec):
    """Red-black FDM and Anderson (a dense diagonal) have no factor-table
    pair: preprocessing_device raises ValueError naming the host-CSR path
    in both packages, and so does solve_system on the port's stencil; from
    the spec, solve_system takes the host-CSR route in both packages
    (natural-order ILU(0)) and both converge in the same count."""
    Aj = bis.stencil_op.from_source_operator(spec, dtype=np.float64)
    At = bt.stencil_op.from_source_operator(spec, torch.float64, device=CPU)
    with pytest.raises(ValueError, match="host CSR path"):
        bis.preprocessing_device(Aj, bis.SolverConfig(
            preconditioner=bis.PrecondType.ILU0, dtype=np.float64))
    with pytest.raises(ValueError, match="host CSR path"):
        bt.preprocessing_device(At, bt.SolverConfig(
            preconditioner=bt.PrecondType.ILU0, dtype=torch.float64))
    assert not bt.ilu0_device_eligible(At, bt.SolverConfig())
    rj = bis.solve_system(spec, "cg", "ilu0", dtype=np.float64,
                          tolerance=1e-8)
    rt = bt.solve_system(spec, "cg", "ilu0", tolerance=1e-8, device=CPU)
    assert rt.converged and rt.iter_count == rj.iter_count
    with pytest.raises(ValueError, match="host CSR path"):
        bt.solve_system(At, "cg", "ilu0", device=CPU)
