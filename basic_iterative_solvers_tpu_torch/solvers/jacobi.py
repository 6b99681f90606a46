"""Jacobi solver (the reference's JacobiSolver, methods/jacobi.hpp): the
"separate" iteration the reference runs (jacobi.hpp:43-52), a full SpMV
then a normalize step:

    x' = (b − (A·x − D·x)) / D        [normalize_x, jacobi.hpp:27-40]

One SpMV per iteration: A·x' feeds both the sampled norm ‖b − A·x'‖
(jacobi.hpp:102-107 recomputes it) and the next step's A·x, as in the JAX
package.
"""
from __future__ import annotations

from ..ops.blas1 import euclidean_vec_norm, subtract_vectors
from ..ops.spmv import spmv
from .base import SolverSetup
from .fused import fused_solve, keep_if_stopped


class JacobiMethod:
    supports_fused = True

    def __init__(self, setup: SolverSetup):
        if setup.A_D is None:
            raise ValueError("Jacobi requires the matrix diagonal")
        self.setup = setup
        self.A = setup.A
        self.b = setup.b
        self.D = setup.A_D

    def init_state(self):
        x = self.setup.x0
        Ax = spmv(self.A, x)
        return {"x": x, "Ax": Ax,
                "residual_norm": euclidean_vec_norm(subtract_vectors(self.b,
                                                                     Ax))}

    def initial_residual_norm(self, state):
        return state["residual_norm"]

    def iterate(self, state, active=None):
        """One Jacobi step.  `active` (fused harness) is a 0-d bool tensor;
        where it is False x stays, and so does A·x (the SpMV kernel is
        deterministic)."""
        x, Ax = state["x"], state["Ax"]
        x_new = keep_if_stopped((self.b - (Ax - self.D * x)) / self.D, x,
                                active)
        return dict(state, x=x_new, Ax=spmv(self.A, x_new))

    def sample_norm(self, state):
        return euclidean_vec_norm(subtract_vectors(self.b, state["Ax"]))

    def check_restart(self, state, iter_count, residual_norm, stopping):
        return state, False, residual_norm

    def final_x(self, state):
        return state["x"]

    def solve_fused(self):
        return fused_solve(self.setup, self.init_state, self.iterate,
                           self.sample_norm, self.final_x)
