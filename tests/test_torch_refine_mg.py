"""cg_mg_refine's configuration at 16³ (the JAX bench's row,
bench.py:334-384, scaled down): CG + MG with float32 inners to 1e-6 and
float64 outers to 1e-11·‖r₀‖, through the single-dispatch form.  Equal
outer counts and inner totals; the outer norms after the first are the
float32 inner solves' rounding floor, reached by differently ordered
float32 sums in the two packages (measured 3% and 12% apart), so they are
held within a factor of two (test_torch_refine.py's float32 rule), and
both reach the float64 criterion.
"""
import numpy as np

import basic_iterative_solvers_tpu as bis

import basic_iterative_solvers_tpu_torch as bt

from test_torch_refine import _check, _setups, t_eligible


def test_cg_mg_refine_f32_inner():
    sj, st = _setups("stencil", "hpcg:16x16x16", "cg", "mg", np.float32,
                     refine_outer=8, tolerance=1e-11, max_iters=300)
    assert t_eligible(st)
    rj, rt = bis.solve(sj), bt.solve(st)
    _check(rj, rt, 0.5)
    assert rt.refine_outer_count >= 2
