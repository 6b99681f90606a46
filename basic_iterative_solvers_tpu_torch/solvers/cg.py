"""Preconditioned Conjugate Gradient (the reference's
ConjugateGradientSolver, methods/cg.hpp:6-54):

    t      = A·p
    ρ      = (r, z)
    α      = ρ / (t, p)
    x'     = x + α·p
    r'     = r − α·t
    z'     = M⁻¹·r'
    β      = (r', z') / ρ
    p'     = z' + β·p

Initialization (cg.hpp:100-120): r₀ = b − A·x₀, z₀ = M⁻¹r₀, p₀ = z₀; the
recorded norm is ||r||₂ of the recurrence residual (cg.hpp:162-166).
(t, p) comes fused out of the SpMV kernel (ops.spmv.spmv_dot).
"""
from __future__ import annotations

from ..ops.blas1 import dot, euclidean_vec_norm, subtract_vectors, sum_vectors
from ..ops.spmv import spmv, spmv_dot
from ..precond import apply_preconditioner
from ..types import PrecondType
from .base import SolverSetup
from .fused import finite_or_zero, fused_solve, gate


class ConjugateGradientMethod:
    supports_fused = True

    def __init__(self, setup: SolverSetup):
        self.setup = setup
        self.A = setup.A
        self.M = setup.M
        self.b = setup.b
        # With the identity preconditioner z IS r: the specialization drops
        # z and reads ρ = (r, r) off the carried norm.
        self._identity_M = self.M.ptype == PrecondType.NONE
        self._stall = setup.config.breakdown_stall

    def init_state(self):
        x = self.setup.x0
        r = subtract_vectors(self.b, spmv(self.A, x))
        rn = euclidean_vec_norm(r)
        if self._identity_M:
            return {"x": x, "r": r, "p": r, "residual_norm": rn}
        z = apply_preconditioner(self.M, r)
        return {"x": x, "r": r, "z": z, "p": z, "residual_norm": rn}

    def initial_residual_norm(self, state):
        return state["residual_norm"]

    def iterate(self, state, active=None):
        """One CG step.  `active` (fused harness) is a 0-d bool tensor;
        where it is False the step leaves x and r unchanged."""
        if self._identity_M:
            x, r, p = state["x"], state["r"], state["p"]
            rn = state["residual_norm"]
            t, tp = spmv_dot(self.A, p)
            rz = rn * rn                      # ρ = (r, r) = ||r||²
            alpha = gate(rz / tp, active)
            x = sum_vectors(x, p, alpha)
            r_new = subtract_vectors(r, t, alpha)
            rn_new = euclidean_vec_norm(r_new)
            beta = gate((rn_new * rn_new) / rz, active)
            p_new = sum_vectors(r_new, p, beta)
            return {"x": x, "r": r_new, "p": p_new, "residual_norm": rn_new}
        x, r, z, p = state["x"], state["r"], state["z"], state["p"]
        t, tp = spmv_dot(self.A, p)
        rz = dot(r, z)
        alpha = rz / tp
        if self._stall:
            alpha = finite_or_zero(alpha)
        alpha = gate(alpha, active)
        x = sum_vectors(x, p, alpha)
        r_new = subtract_vectors(r, t, alpha)
        z_new = apply_preconditioner(self.M, r_new)
        beta = dot(r_new, z_new) / rz
        if self._stall:
            beta = finite_or_zero(beta)
        beta = gate(beta, active)
        p_new = sum_vectors(z_new, p, beta)
        return {"x": x, "r": r_new, "z": z_new, "p": p_new,
                "residual_norm": euclidean_vec_norm(r_new)}

    def sample_norm(self, state):
        return state["residual_norm"]

    def check_restart(self, state, iter_count, residual_norm, stopping):
        return state, False, residual_norm

    def final_x(self, state):
        return state["x"]

    def solve_fused(self):
        return fused_solve(self.setup, self.init_state, self.iterate,
                           self.sample_norm, self.final_x)
