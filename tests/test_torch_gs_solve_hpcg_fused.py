"""The port's GS, SGS, CG + SGS, BiCGSTAB + BGS and CG + s2st solves
against the JAX package's on HPCG 16³, fused harness (the case table and
settings of tests/test_torch_gs_solve_hpcg.py)."""
import pytest

from tests.test_torch_gs_solve_hpcg import HPCG, cases, run_parity


@pytest.mark.parametrize("method,precond,cfg,iters,_fdm",
                         cases(("gs", "sgs", "cg_sgs", "bi_bgs", "cg_s2st")))
def test_hpcg_fused_parity(method, precond, cfg, iters, _fdm):
    run_parity(HPCG, "fused", method, precond, cfg, iters)
