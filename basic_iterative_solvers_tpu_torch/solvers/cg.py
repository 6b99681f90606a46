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

import torch

from ..ops.blas1 import (dot, euclidean_vec_norm, full_value,
                         subtract_vectors, sum_vectors)
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


class PipelinedCGMethod:
    """Ghysels–Vanroose pipelined PCG (config.cg_flavor="pipelined"), the
    JAX package's PipelinedCGMethod:

        γ = (r, u)    δ = (w, u)
        m = M⁻¹·w ;  n = A·m
        β = γ/γ_old ;  α = γ / (δ − β·γ/α_old)
        z ← n + β·z ;  q ← m + β·q ;  s ← w + β·s ;  p ← u + β·p
        x ← x + α·p ;  r ← r − α·s ;  u ← u − α·q ;  w ← w − α·z

    with u = M⁻¹r and w = A·u kept by recurrence (identity M: u ≡ r and
    q ≡ s, so only x, r, w, p, s, z are carried and γ = ‖r‖²).  γ_old = ∞
    on the first step makes β exactly 0.

    Residual replacement (Cools & Vanroose): r = b − A·x, u = M⁻¹r,
    w = A·u, s = A·p, q = M⁻¹s, z = A·q, when the recurrence norm drops
    below cg_rr_theta × its maximum since the last replacement (the flying
    restart), or every cg_rr_period steps as a backstop; cg_rr_period = 0
    turns it off.  The JAX package branches on the device (`lax.cond`);
    here the trigger is read on the host every step, so the replacement
    costs its SpMVs and M-applies only when it fires, and the fused
    harness waits for the device once an iteration (its other methods never
    wait inside one).  `replacements` counts the replacements made."""

    supports_fused = True

    def __init__(self, setup: SolverSetup):
        self.setup = setup
        self.A = setup.A
        self.M = setup.M
        self.b = setup.b
        self.rr_period = int(setup.config.cg_rr_period)
        self.rr_theta = float(setup.config.cg_rr_theta)
        self._identity_M = self.M.ptype == PrecondType.NONE
        self.replacements = 0

    def init_state(self):
        x = self.setup.x0
        r = subtract_vectors(self.b, spmv(self.A, x))
        rn = euclidean_vec_norm(r)
        inf = torch.full((), float("inf"), dtype=rn.dtype, device=rn.device)
        one = torch.ones((), dtype=rn.dtype, device=rn.device)
        k0 = torch.zeros((), dtype=torch.int64, device=rn.device)
        zero = torch.zeros_like(r)
        state = {"x": x, "r": r, "p": zero, "s": zero, "z": zero,
                 "gamma_old": inf, "alpha_old": one,
                 "residual_norm": rn, "rn_max": rn, "k_rep": k0}
        if self._identity_M:
            state["w"] = spmv(self.A, r)
        else:
            state["u"] = apply_preconditioner(self.M, r)
            state["w"] = spmv(self.A, state["u"])
            state["q"] = zero
        return state

    def initial_residual_norm(self, state):
        return state["residual_norm"]

    def _replace(self, x, p):
        """The replaced vectors (r, u, w, s, q, z) from x and p."""
        r = subtract_vectors(self.b, spmv(self.A, x))
        if self._identity_M:
            w = spmv(self.A, r)
            s = spmv(self.A, p)
            return r, None, w, s, None, spmv(self.A, s)
        u = apply_preconditioner(self.M, r)
        w = spmv(self.A, u)
        s = spmv(self.A, p)
        q = apply_preconditioner(self.M, s)
        return r, u, w, s, q, spmv(self.A, q)

    def iterate(self, state, active=None):
        """One pipelined step.  `active` (fused harness) is a 0-d bool
        tensor; where it is False the step leaves x and r unchanged and
        makes no replacement."""
        x, r, w = state["x"], state["r"], state["w"]
        p, s, z = state["p"], state["s"], state["z"]
        if self._identity_M:
            u = r
            gamma = state["residual_norm"] * state["residual_norm"]
            delta = dot(w, r)
            m = w
        else:
            u, q = state["u"], state["q"]
            gamma = dot(r, u)
            delta = dot(w, u)
            m = apply_preconditioner(self.M, w)
        n = spmv(self.A, m)
        beta = gamma / state["gamma_old"]
        alpha = gamma / (delta - beta * gamma / state["alpha_old"])
        beta_g, alpha_g = gate(beta, active), gate(alpha, active)
        z = sum_vectors(n, z, beta_g)
        s = sum_vectors(w, s, beta_g)
        p = sum_vectors(u, p, beta_g)
        x = sum_vectors(x, p, alpha_g)
        r = subtract_vectors(r, s, alpha_g)
        w = subtract_vectors(w, z, alpha_g)
        if not self._identity_M:
            q = sum_vectors(m, q, beta_g)
            u = subtract_vectors(u, q, alpha_g)
        rn_new = euclidean_vec_norm(r)
        rn_max, k_rep = state["rn_max"], state["k_rep"]
        if self.rr_period:
            k_rep = k_rep + 1
            trigger = ((rn_new < self.rr_theta * rn_max)
                       | (k_rep >= self.rr_period))
            if bool(full_value(trigger if active is None
                               else trigger & active)):
                r, u2, w, s, q2, z = self._replace(x, p)
                if not self._identity_M:
                    u, q = u2, q2
                rn_new = euclidean_vec_norm(r)
                rn_max = rn_new
                k_rep = torch.zeros_like(k_rep)
                self.replacements += 1
            else:
                rn_max = torch.maximum(rn_max, rn_new)
        out = {"x": x, "r": r, "w": w, "p": p, "s": s, "z": z,
               "gamma_old": gamma, "alpha_old": alpha,
               "residual_norm": rn_new,
               "rn_max": rn_max, "k_rep": k_rep}
        if not self._identity_M:
            out["u"], out["q"] = u, q
        return out

    def sample_norm(self, state):
        return state["residual_norm"]

    def check_restart(self, state, iter_count, residual_norm, stopping):
        return state, False, residual_norm

    def final_x(self, state):
        return state["x"]

    def solve_fused(self):
        return fused_solve(self.setup, self.init_state, self.iterate,
                           self.sample_norm, self.final_x)
