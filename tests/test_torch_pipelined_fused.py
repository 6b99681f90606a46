"""Pipelined CG in the fused harness, the port against the JAX package
(test_torch_pipelined_cg.py's preconditioners, dtypes and checks): equal
iteration counts, as many replacements as the port's host-harness solve
(which test_torch_pipelined_cg.py ties to the JAX package's replacement
steps), histories up to the first replacement within rtol 1e-8 (float64)
or 1e-3 (float32), and within 1e-4 after it in float64.
"""
import numpy as np
import pytest

import basic_iterative_solvers_tpu as bis

import basic_iterative_solvers_tpu_torch as bt
from basic_iterative_solvers_tpu_torch.solvers import make_method as tmake

from test_torch_pipelined_cg import PRECONDS, _check_history, _setups


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("pname", PRECONDS)
def test_pipelined_fused_matches_jax(pname, dtype):
    sj, st = _setups(pname, dtype, "fused")
    rj = bis.solve(sj)
    mt = tmake(st)
    rt = bt.solve(st, method=mt)
    assert rj.converged and rt.converged
    assert rt.iter_count == rj.iter_count
    _, sh = _setups(pname, dtype, "host")
    mh = tmake(sh)
    rh = bt.solve(sh, method=mh)
    assert rh.iter_count == rt.iter_count
    assert mt.replacements == mh.replacements > 0
    # the fused loop runs the host loop's arithmetic (its gate passes the
    # step scalars through while the loop is active)
    np.testing.assert_array_equal(rt.residual_norms[:-1],
                                  rh.residual_norms[:-1])
    _check_history(rj, rt, _first_replacement(sh) + 1, dtype)


def _first_replacement(setup):
    """The step (from 0) of the port's first residual replacement."""
    m = tmake(setup)
    state = m.init_state()
    for k in range(setup.config.max_iters):
        state = m.iterate(state)
        if int(state["k_rep"]) == 0:
            return k
    raise AssertionError("no replacement")
