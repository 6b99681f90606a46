"""Gauss-Seidel and symmetric Gauss-Seidel solvers (the reference's
GaussSeidelSolver / SymmetricGaussSeidelSolver,
methods/gauss_seidel.hpp:26-141) in the colour-sorted ordering:

    forward sweep:  x ← (L_c + D)⁻¹ (b − U_c·x)
    backward sweep: x ← (U_c + D)⁻¹ (b − L_c·x)

Three exact forms, as in the JAX package's solvers/gauss_seidel.py:

* blocked — where the operator has the const-mode superblock pair
  (setup.gs_L_block): residual form x ← x + M⁻¹r through
  ops/block_trisolve.py, with r = b − A·x carried, so each iteration
  applies A once and r feeds both the next sweep and the sampled norm.
* coloured — a structural or greedy colouring: the masked colour sweeps of
  coloring.py.
* levels — the host-CSR path's natural ordering (gs_mode "levels"): the
  strict upper (lower) part's SpMV, then the level-scheduled solve of
  ops/trisolve.py, the reference's arithmetic order.
The coloured and level forms sample ‖b − A·x‖ anew (gauss_seidel.hpp:
99-104).
"""
from __future__ import annotations

from ..ops.blas1 import euclidean_vec_norm, subtract_vectors
from ..ops.spmv import spmv
from ..ops.trisolve import trisolve
from .base import SolverSetup
from .fused import fused_solve, keep_if_stopped


class GaussSeidelMethod:
    supports_fused = True
    symmetric = False

    def __init__(self, setup: SolverSetup):
        self.blocked = setup.gs_L_block is not None
        self.colored = setup.n_colors > 0 and not self.blocked
        if self.colored:
            if setup.A_D is None:
                raise ValueError("colored Gauss-Seidel requires the diagonal")
            self.D_inv = 1.0 / setup.A_D
        elif not self.blocked and (
                setup.L_solve is None or setup.U_strict_dev is None
                or (self.symmetric and (setup.U_solve is None
                                        or setup.L_strict_dev is None))):
            raise ValueError("Gauss-Seidel requires a colouring or the "
                             "level-scheduled solves (preprocessing sets "
                             "them)")
        self.setup = setup
        self.A = setup.A
        self.b = setup.b

    def init_state(self):
        x = self.setup.x0
        r = subtract_vectors(self.b, spmv(self.A, x))
        if self.blocked:
            return {"x": x, "r": r, "residual_norm": euclidean_vec_norm(r)}
        return {"x": x, "residual_norm": euclidean_vec_norm(r)}

    def initial_residual_norm(self, state):
        return state["residual_norm"]

    def _sweep(self, x, reverse: bool):
        from ..coloring import colored_sweep
        s = self.setup
        return colored_sweep(self.A, self.D_inv, self.b, x, s.color_spec,
                             s.n_colors, reverse=reverse,
                             color_arr=s.color_arr)

    def iterate(self, state, active=None):
        """One GS (SGS) iteration.  `active` (fused harness) is a 0-d bool
        tensor; where it is False x stays, and so do r and its norm (the
        operator apply is deterministic)."""
        x = state["x"]
        if self.blocked:
            from ..ops.block_trisolve import blocked_sgs, blocked_trisolve
            r = state["r"]
            if self.symmetric:
                dx = blocked_sgs(self.setup.gs_L_block,
                                 self.setup.gs_U_block, r)
            else:
                dx = blocked_trisolve(self.setup.gs_L_block, r)
            x = keep_if_stopped(x + dx, x, active)
            r_new = subtract_vectors(self.b, spmv(self.A, x))
            return {"x": x, "r": r_new,
                    "residual_norm": euclidean_vec_norm(r_new)}
        if self.colored:
            x_new = self._sweep(x, reverse=False)
            if self.symmetric:
                x_new = self._sweep(x_new, reverse=True)
        else:
            s = self.setup
            x_new = trisolve(s.L_solve, self.b - spmv(s.U_strict_dev, x))
            if self.symmetric:
                x_new = trisolve(s.U_solve,
                                 self.b - spmv(s.L_strict_dev, x_new))
        return dict(state, x=keep_if_stopped(x_new, x, active))

    def sample_norm(self, state):
        if self.blocked:
            # already the explicit ||b − A·x|| of the carried residual
            return state["residual_norm"]
        r = subtract_vectors(self.b, spmv(self.A, state["x"]))
        return euclidean_vec_norm(r)

    def check_restart(self, state, iter_count, residual_norm, stopping):
        return state, False, residual_norm

    def final_x(self, state):
        return state["x"]

    def solve_fused(self):
        return fused_solve(self.setup, self.init_state, self.iterate,
                           self.sample_norm, self.final_x)


class SymmetricGaussSeidelMethod(GaussSeidelMethod):
    """Forward then backward sweep per iteration (gauss_seidel.hpp:126-129)."""

    symmetric = True
