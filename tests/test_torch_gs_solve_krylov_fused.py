"""The port's GMRES(50) + SGS and BiCGSTAB + SGS solves against the JAX
package's on HPCG 16³, fused harness (the case table and settings of
tests/test_torch_gs_solve_hpcg.py; a file of their own because the JAX
package's fused GMRES takes ~20 s to compile here)."""
import pytest

from tests.test_torch_gs_solve_hpcg import HPCG, cases, run_parity


@pytest.mark.parametrize("method,precond,cfg,iters,_fdm",
                         cases(("gm_sgs", "bi_sgs")))
def test_hpcg_fused_krylov_parity(method, precond, cfg, iters, _fdm):
    run_parity(HPCG, "fused", method, precond, cfg, iters)
