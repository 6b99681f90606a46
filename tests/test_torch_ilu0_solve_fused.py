"""The port's CG, BiCGSTAB and GMRES(50) with exact coloured ILU(0)
against the JAX package's, fused harness (the cases and settings of
tests/test_torch_ilu0_solve_host.py)."""
import pytest

from basic_iterative_solvers_tpu_torch.ops import block_trisolve as tbt
from tests.test_torch_ilu0_solve_host import cases, run_parity


@pytest.mark.parametrize("spec,method,cfg,iters", cases())
def test_ilu0_fused_parity(spec, method, cfg, iters):
    tbt.super_level.table_launches = 0
    run_parity(spec, "fused", method, cfg, iters)
    assert tbt.super_level.table_launches == 0      # CPU: plain versions
