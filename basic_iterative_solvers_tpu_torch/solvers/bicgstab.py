"""Preconditioned BiCGSTAB (the reference's BiCGSTABSolver,
methods/bicgstab.hpp, flexible formulation; bicgstab_separate_iteration,
bicgstab.hpp:8-83):

    y    = M⁻¹·p
    v    = A·y
    α    = ρ / (r̂₀, v)
    s    = r − α·v
    ŝ    = M⁻¹·s
    t    = A·ŝ
    ω    = (t, s) / (t, t)
    x'   = (x + α·y) + ω·ŝ
    r'   = s − ω·t
    ρ'   = (r̂₀, r')
    β    = (ρ'/ρ)(α/ω)
    p'   = r' + β(p − ω·v)

Initialization (bicgstab.hpp:147-169): r = b − A·x₀ (unpreconditioned),
r̂₀ = p₀ = M⁻¹r₀, ρ₀ = (r₀, M⁻¹r₀).  The sampled norm is ‖r'‖₂
(bicgstab.hpp:220-223).  (r̂₀, v) and (t, s), (t, t) come fused out of the
SpMV kernel (ops.spmv.spmv_dots).
"""
from __future__ import annotations

from ..ops.blas1 import dot, euclidean_vec_norm, subtract_vectors, sum_vectors
from ..ops.spmv import spmv, spmv_dots
from ..precond import apply_preconditioner
from .base import SolverSetup
from .fused import finite_or_zero, fused_solve, gate


class BiCGSTABMethod:
    supports_fused = True

    def __init__(self, setup: SolverSetup):
        self.setup = setup
        self.A = setup.A
        self.M = setup.M
        self.b = setup.b
        # tolerance=0 runs: past the attainable floor ρ/ω divide ~0/~0;
        # zeroed scalars freeze the state instead of poisoning it
        self._stall = setup.config.breakdown_stall

    def init_state(self):
        x = self.setup.x0
        r = subtract_vectors(self.b, spmv(self.A, x))
        r_prec = apply_preconditioner(self.M, r)
        return {"x": x, "r": r, "p": r_prec, "r0hat": r_prec,
                "rho": dot(r, r_prec), "residual_norm": euclidean_vec_norm(r)}

    def initial_residual_norm(self, state):
        return state["residual_norm"]

    def iterate(self, state, active=None):
        """One BiCGSTAB step.  `active` (fused harness) is a 0-d bool
        tensor; where it is False α, ω and β are 0, so x and r stay and p
        stays finite."""
        x, r, p = state["x"], state["r"], state["p"]
        r0hat, rho = state["r0hat"], state["rho"]
        y = apply_preconditioner(self.M, p)
        v, r0hat_v = spmv_dots(self.A, y, aux=r0hat)
        alpha = rho / r0hat_v
        if self._stall:
            alpha = finite_or_zero(alpha)
        alpha = gate(alpha, active)
        s = subtract_vectors(r, v, alpha)
        s_hat = apply_preconditioner(self.M, s)
        t, t_s, t_t = spmv_dots(self.A, s_hat, aux=s, with_self=True)
        omega = t_s / t_t
        if self._stall:
            omega = finite_or_zero(omega)
        omega = gate(omega, active)
        x_new = sum_vectors(sum_vectors(x, y, alpha), s_hat, omega)
        r_new = subtract_vectors(s, t, omega)
        rho_new = dot(r0hat, r_new)
        beta = (rho_new / rho) * (alpha / omega)
        if self._stall:
            beta = finite_or_zero(beta)
        beta = gate(beta, active)
        p_new = sum_vectors(r_new, subtract_vectors(p, v, omega), beta)
        return {"x": x_new, "r": r_new, "p": p_new, "r0hat": r0hat,
                "rho": rho_new, "residual_norm": euclidean_vec_norm(r_new)}

    def sample_norm(self, state):
        return state["residual_norm"]

    def check_restart(self, state, iter_count, residual_norm, stopping):
        return state, False, residual_norm

    def final_x(self, state):
        return state["x"]

    def solve_fused(self):
        return fused_solve(self.setup, self.init_state, self.iterate,
                           self.sample_norm, self.final_x)
