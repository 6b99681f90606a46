"""CG + geometric multigrid in the fused harness (the main path's loop):
the port against the JAX package in float64, with test_torch_mg_solve.py's
checks (equal counts; histories within rtol 1e-8 down to 1e-8·‖r₀‖ and
1e-5 below, where the solve amplifies last-bit differences).
"""
import pytest

from test_torch_mg_solve import SPECS, _check, _solve_both


@pytest.mark.parametrize("spec", SPECS)
def test_cg_mg_f64_parity_fused(spec):
    rj, rt = _solve_both(spec, "fused")
    _check(rj, rt)
    assert rt.iter_count <= 15
