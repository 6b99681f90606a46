"""Restarted, preconditioned GMRES(m) (the reference's GMRESSolver,
methods/gmres.hpp), as the JAX package runs it (solvers/gmres.py):

* Arnoldi against the stored basis V, (m+1, n) with one row per basis
  vector (gmres.hpp:158-160), orthogonalized by `orthog_mode`:
  - "mgs": modified Gram-Schmidt, a (j+1)-deep dot/axpy chain
    (orthogonalize_V, gmres.hpp:6-53);
  - "cgs2": classical Gram-Schmidt with one re-orthogonalization;
  - "lowsync": CGS2 whose second projection comes from the running Gram
    matrix G = V·Vᵀ, h2 = (I − G)·h1, so V is streamed twice per step;
  - "fused": lowsync with both basis passes in the hand-written kernels of
    ops/gmres_basis.py, over a scaled-raw basis (below).
* Givens least squares through an accumulated (m+1)² rotation Q, of which
  each step rewrites rows j and j+1 (least_squares, gmres.hpp:55-121); the
  implicit residual is |g[j+1]| with g = β·Q[:, 0] (update_g,
  gmres.hpp:123-148).
* x = x₀ + Σ y_k V_k with y = R⁻¹g, R = Q·H (get_explicit_x,
  gmres.hpp:326-375), and a restart after every m unconverged steps:
  recover x, recompute and re-precondition the residual, reset the Krylov
  state (check_restart, gmres.hpp:388-415).

`gmres_basis_dtype` stores V narrower than the solve dtype (bfloat16 or
float32); the contractions accumulate in the solve dtype.

The basis row index j travels by value (state["jh"], a host int): the
harnesses know each step's index within its restart cycle, so V[:j+1] and
the kernels' row counts need no device read.  state["j"] is the device
count of active steps, n_it for `explicit_x`; it stops at the last active
step of the fused harness, whose later steps are gated no-ops that change
none of x, H, Q, g, G and s, and write only rows beyond n_it of V.

Fused mode stores rows scaled-raw (gmres.py:158-184): V[i] = c_i·v_i with
v_i the unit Arnoldi vector, and carries s_i = 1/‖stored row i‖ of the
rounded values, so s_i·V[i] is exactly unit in storage.  The raw products
of `project_gram` map back through s: h1_i = s_i·⟨V_i, w·s_j⟩, the Gram
column s_i·s_j·⟨V_i, V_j⟩, the correction weights h̃_i = h_i·s_i; the new
row's norm comes out of `correct_write`.

In the GSPMD mode (parallel/gspmd.py) the vectors are Shard(0) DTensors
and V a Shard(1) DTensor: every rank runs the basis passes (#6, #7 in
fused mode, the matrix products otherwise) on its own columns, and one
all-reduce sums each pass's partial products.  In the shard_map mode the
vectors are MeshVectors and V one too, rows per shard (parallel/
mesh_vector.py): the passes run on each shard's columns on its device,
and Mesh.psum sums their partial products.  H, Q, g, G and s stay plain
tensors (every rank's, or on the mesh's first device).
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from ..config import torch_dtype
from ..ops import gmres_basis
from ..ops.blas1 import (dot, euclidean_vec_norm, full_value, is_dtensor,
                         is_mesh_vector, replicated, subtract_vectors)
from ..ops.spmv import spmv
from ..precond import apply_preconditioner
from ..utils.ktimers import ktime
from .base import SolverSetup
from .fused import fused_solve, gate, keep_if_stopped

ORTHOG_MODES = ("mgs", "cgs2", "lowsync", "fused")


def _parts(t):
    """t's local parts: a DTensor's rank-local rows or columns, a
    MeshVector's shards, else [t]."""
    if is_dtensor(t):
        return [t.to_local()]
    if is_mesh_vector(t):
        return list(t.shards)
    return [t]


def _like(parts, x):
    """A vector laid out like x from its local parts (`_parts`)."""
    if is_dtensor(x):
        from ..parallel.gspmd import rows_like
        return rows_like(parts[0], x)
    if is_mesh_vector(x):
        from ..parallel.mesh_vector import MeshVector
        return MeshVector(parts, x.blocks, check=False)
    return parts[0]


def _summed(per_part, x):
    """Partial products summed across the parts, `per_part` one tuple of
    plain tensors a local part: one all-reduce of the ranks' where x is a
    DTensor, Mesh.psum of the shards' where x is a MeshVector (every
    rank's whole value, or on the mesh's first device); the one part's
    tuple otherwise."""
    if is_dtensor(x):
        from ..parallel.gspmd import sum_partials
        return sum_partials(per_part[0], x.device_mesh)
    if is_mesh_vector(x):
        return tuple(x.mesh.psum(list(p)) for p in zip(*per_part))
    return per_part[0]


def _on(t, like):
    """A small plain tensor (coefficients) on the device of `like`."""
    return t.to(like.device)


def _new_basis(rows: int, dtype, x):
    """A zero (rows, n) basis laid out like x: a Shard(1) DTensor of the
    ranks' columns, or a MeshVector of the shards' columns."""
    if is_mesh_vector(x):
        return x.blocks.zeros(dtype, lead=(rows,))
    if not is_dtensor(x):
        return torch.zeros((rows, x.numel()), dtype=dtype, device=x.device)
    from torch.distributed.tensor import DTensor, Shard
    n = x.shape[0]
    local = torch.zeros((rows, x.to_local().numel()), dtype=dtype,
                        device=x.device)
    return DTensor.from_local(local, x.device_mesh, [Shard(1)],
                              run_check=False, shape=torch.Size([rows, n]),
                              stride=(n, 1))


class GMRESMethod:
    supports_fused = True

    def __init__(self, setup: SolverSetup):
        self.setup = setup
        self.A = setup.A
        self.M = setup.M
        self.b = setup.b
        self.m = setup.config.restart_length
        self.orthog = setup.config.orthog_mode
        if self.orthog not in ORTHOG_MODES:
            raise ValueError(f"unknown orthog_mode: {self.orthog}")
        bd = setup.config.gmres_basis_dtype
        #: None: V in the solve dtype
        self.basis_dtype = None if bd is None else torch_dtype(bd)
        if self.orthog == "fused":
            why = self._fused_unavailable()
            if why:
                warnings.warn(f"orthog_mode='fused' unavailable ({why}); "
                              "falling back to 'lowsync'", stacklevel=2)
                self.orthog = "lowsync"
        # every layout stores V flat: it has no numerical effect here
        lay = setup.config.gmres_basis_layout
        if lay not in ("auto", "flat", "tiled"):
            raise ValueError(f"unknown gmres_basis_layout: {lay}")
        if lay == "tiled" and setup.b.numel() % 128:
            raise ValueError(
                "gmres_basis_layout='tiled' needs a lane-divisible vector "
                f"size (got {setup.b.numel()})")

    def _fused_unavailable(self) -> str:
        """Why the fused basis kernels cannot take this solve ("" when
        they can): the solve and basis dtypes.  Both modes of the mesh
        take them, on each rank's or shard's columns of V (the JAX
        package's mesh GMRES runs lowsync instead, gmres.py:99-104: its
        Pallas kernels do not partition)."""
        if self.b.dtype != torch.float32:
            return f"needs a float32 solve dtype (got {self.b.dtype})"
        vdt = self.basis_dtype or torch.float32
        if gmres_basis.plan_for(self.m, vdt) is None:
            return (f"no kernel for a {vdt} basis of {self.m + 1} rows "
                    "(float32 or bfloat16 only)")
        return ""

    # -- state ---------------------------------------------------------------

    def _krylov_reset(self, x, r_prec, beta, V=None):
        """Fresh Krylov state from the preconditioned residual.  A restart
        hands in the old V and gets it back with row 0 rewritten: no step
        reads a row it has not written in the current cycle."""
        m, dtype = self.m, x.dtype
        vdt = self.basis_dtype or dtype
        if V is None:
            V = _new_basis(m + 1, vdt, x)
        beta = full_value(beta)
        state = {"x_old": x, "V": V, "beta": beta, "jh": 0,
                 "j": torch.zeros((), dtype=torch.int64, device=x.device),
                 "H": torch.zeros((m + 1, m), dtype=dtype, device=x.device),
                 "Q": torch.eye(m + 1, dtype=dtype, device=x.device),
                 "g": torch.zeros(m + 1, dtype=dtype, device=x.device)}
        state["g"][0] = beta
        if self.orthog in ("lowsync", "fused"):
            # running Gram matrix of the computed (unit) basis
            state["G"] = torch.zeros((m + 1, m + 1), dtype=dtype,
                                     device=x.device)
            state["G"][0, 0] = 1.0
        if self.orthog == "fused":
            v0 = r_prec.to(vdt)
            v0f = v0.to(torch.float32)
            c0sq = full_value(replicated(torch.dot(v0f, v0f)))
            s = torch.zeros(m + 1, dtype=torch.float32, device=x.device)
            s[0] = torch.where(c0sq > 0, torch.rsqrt(c0sq), 0.0)
            for Vk, vk in zip(_parts(V), _parts(v0)):
                Vk[0] = vk
            state.update(s=s, v_cur=v0f)
            return state
        # v_cur carries the stored (basis-dtype-rounded) current row
        v0 = (r_prec / beta).to(vdt)
        for Vk, vk in zip(_parts(V), _parts(v0)):
            Vk[0] = vk
        state["v_cur"] = v0
        return state

    def init_state(self):
        x = self.setup.x0
        r = subtract_vectors(self.b, spmv(self.A, x))
        r_prec = apply_preconditioner(self.M, r)
        state = self._krylov_reset(x, r_prec, euclidean_vec_norm(r_prec))
        state["residual_norm"] = euclidean_vec_norm(r)
        return state

    def initial_residual_norm(self, state):
        return state["residual_norm"]

    # -- iteration -----------------------------------------------------------

    def iterate(self, state, active=None):
        """One Arnoldi step and Givens update.  `active` (fused harness) is
        a 0-d bool tensor; where it is False the step changes none of the
        quantities `explicit_x` reads."""
        j = state["jh"]
        V, H, Q, beta = state["V"], state["H"], state["Q"], state["beta"]
        Vp = _parts(V)
        # w = M⁻¹ A v_j (gmres.hpp:168-176), the stored row upcast
        vj = state["v_cur"]
        w = apply_preconditioner(self.M, spmv(self.A, vj.to(self.b.dtype)))
        sdtype = w.dtype
        H_new = H.clone()

        def orthog(w):
            """The Arnoldi orthogonalization of w against V (H_new's
            column j filled in place): (v_next, extra state)."""
            extra = {}
            if self.orthog == "fused":
                s, G = state["s"], state["G"].clone()
                sj = s[j]
                wf = w * sj
                Pw, Pv = _summed([gmres_basis.project_gram(Vk, wk, vk, j)
                                  for Vk, wk, vk in zip(Vp, _parts(wf),
                                                        _parts(vj))], w)
                h1 = s * Pw
                gc = s * (sj * Pv)
                G[:, j] = gc
                G[j, :] = gc
                h2 = h1 - G @ h1
                h = h1 + h2
                ht = gate(h * s, active)
                outs = [gmres_basis.correct_write(Vk, wk, _on(ht, Vk), j)
                        for Vk, wk in zip(Vp, _parts(wf))]
                v_next = _like([o[0] for o in outs], w)
                (nrm2,) = _summed([(o[1],) for o in outs], w)
                H_new[:, j] = h
                H_new[j + 1, j] = torch.sqrt(nrm2)
                s_new = s.clone()
                s_new[j + 1] = torch.where(
                    nrm2 > 0, torch.rsqrt(torch.where(nrm2 > 0, nrm2, 1.0)),
                    0.0)
                extra = {"G": keep_if_stopped(G, state["G"], active),
                         "s": keep_if_stopped(s_new, s, active)}
            else:
                if self.orthog == "lowsync":
                    G = state["G"].clone()
                    Vb = [Vk[:j + 1].to(sdtype) for Vk in Vp]
                    P = torch.zeros((self.m + 1, 2), dtype=sdtype,
                                    device=w.device)
                    (P[:j + 1],) = _summed([(
                        Vbk @ torch.stack([wk.to(V.dtype), vk],
                                          dim=1).to(sdtype),)
                        for Vbk, wk, vk in zip(Vb, _parts(w), _parts(vj))],
                        w)
                    h1, gc = P[:, 0], P[:, 1]
                    G[:, j] = gc               # the exact V·v_j column
                    G[j, :] = gc
                    h2 = h1 - G @ h1           # = V·(w − h1ᵀV), G-corrected
                    h = h1 + h2
                    hc = h[:j + 1].to(V.dtype).to(sdtype)
                    w = w - _like([_on(hc, Vbk) @ Vbk for Vbk in Vb], w)
                    H_new[:, j] = h
                    extra = {"G": keep_if_stopped(G, state["G"], active)}
                elif self.orthog == "cgs2":
                    Vb = [Vk[:j + 1].to(sdtype) for Vk in Vp]

                    def proj(v):
                        return _summed([
                            (Vbk @ vk.to(V.dtype).to(sdtype),)
                            for Vbk, vk in zip(Vb, _parts(v))], w)[0]

                    def expand(c):
                        c = c.to(V.dtype).to(sdtype)
                        return _like([_on(c, Vbk) @ Vbk for Vbk in Vb], w)

                    h1 = proj(w)
                    w1 = w - expand(h1)
                    h2 = proj(w1)
                    w = w1 - expand(h2)
                    H_new[:j + 1, j] = h1 + h2
                else:
                    # modified Gram-Schmidt against v_0..v_j (gmres.hpp:6-30)
                    for i in range(j + 1):
                        vi = _like([Vk[i] for Vk in Vp], w).to(sdtype)
                        hi = dot(w, vi)
                        H_new[i, j] = full_value(hi)
                        w = w - hi * vi
                h_next = euclidean_vec_norm(w)  # H[j+1, j], gmres.hpp:36-38
                H_new[j + 1, j] = full_value(h_next)
                # happy breakdown (h_next == 0): a zero row instead of w/0
                v_next = torch.where(
                    h_next > 0, w / torch.where(h_next > 0, h_next, 1.0),
                    0.0).to(V.dtype)
                for Vk, vk in zip(Vp, _parts(v_next)):
                    Vk[j + 1] = vk             # gmres.hpp:43-46
            return v_next, extra

        v_next, extra = ktime("orthog", orthog, w)

        # Givens least squares (gmres.hpp:55-121): rotate column j of H by
        # the accumulated Q, derive the new rotation, fold it into Q
        def least_squares(Q, H_new):
            h_col = Q @ H_new[:, j]
            hjj, hj1j = h_col[j], h_col[j + 1]
            denom = torch.sqrt(hjj * hjj + hj1j * hj1j)
            c, sn = hjj / denom, hj1j / denom
            Q_new = Q.clone()
            Q_new[j] = c * Q[j] + sn * Q[j + 1]
            Q_new[j + 1] = -sn * Q[j] + c * Q[j + 1]
            return Q_new

        Q_new = ktime("least_sq", least_squares, Q, H_new)
        # g = Q (β e₁); implicit ‖r‖ = |g[j+1]| (update_g, gmres.hpp:123-148)
        g = ktime("update_g", lambda Q_new: beta * Q_new[:, 0], Q_new)
        return dict(state, **extra,
                    H=keep_if_stopped(H_new, H, active),
                    Q=keep_if_stopped(Q_new, Q, active),
                    g=keep_if_stopped(g, state["g"], active),
                    j=state["j"] + (1 if active is None else active),
                    jh=j + 1, residual_norm=g[j + 1].abs(), v_cur=v_next)

    def sample_norm(self, state):
        return state["residual_norm"]

    # -- solution recovery & restart ------------------------------------------

    def explicit_x(self, state, n_it: int):
        """y = R⁻¹g over the first n_it rows, x = x_old + Σ_{k<n_it} y_k V_k
        (get_explicit_x, gmres.hpp:326-375)."""
        Q, H, g, V = state["Q"], state["H"], state["g"], state["V"]
        R = Q @ H                              # (m+1, m), gmres.hpp:114-116
        y = torch.linalg.solve_triangular(
            R[:n_it, :n_it], g[:n_it, None], upper=True)[:, 0]
        if self.orthog == "fused":
            y = y * state["s"][:n_it].to(y.dtype)   # v_k = s_k·Vraw_k
        c = y.to(V.dtype).to(y.dtype)
        dx = [_on(c, Vk) @ Vk[:n_it].to(y.dtype) for Vk in _parts(V)]
        return state["x_old"] + _like(dx, state["x_old"])

    def _restart_state(self, state):
        """The reference's restart: recover x, recompute and re-precondition
        the residual, reset the Krylov state (gmres.hpp:396-413 and
        init_residual, 274-316).  Every step of the cycle was active, so
        n_it is the cycle length."""
        x = self.explicit_x(state, state["jh"])
        r_prec = apply_preconditioner(
            self.M, subtract_vectors(self.b, spmv(self.A, x)))
        beta = euclidean_vec_norm(r_prec)
        new = self._krylov_reset(x, r_prec, beta, V=state["V"])
        new["residual_norm"] = beta
        return new

    def check_restart(self, state, iter_count, residual_norm, stopping):
        """Host-harness restart hook (gmres.hpp:388-415)."""
        norm_conv = residual_norm < stopping
        over_max = iter_count > self.setup.config.max_iters
        cycle = iter_count % self.m == 0 and iter_count != 0
        if not norm_conv and not over_max and cycle:
            state = self._restart_state(state)
            return state, True, float(full_value(state["residual_norm"]))
        return state, False, residual_norm

    def debug_check(self, state, iter_count):
        """SanityChecker analogs (reference common.hpp:428-530, run under
        IF_DEBUG_MODE at gmres.hpp:50,120): orthonormality of the current
        basis and upper-triangularity of R = Q·H."""
        j = int(state["j"])
        if j == 0:
            return
        # rows 0..j-1 are the established basis; row j is meaningless at
        # (happy) breakdown
        V = full_value(state["V"])[:j]
        if self.orthog == "fused":
            V = V.to(torch.float32) * state["s"][:j, None]
        # the bound scales with the basis dtype: MGS drift grows like
        # eps·κ(A); the check is for gross (O(1)) loss
        tol = 1e4 * torch.finfo(V.dtype).eps * max(1, j)
        Vn = V.to(torch.float64).cpu().numpy()
        err = np.max(np.abs(Vn @ Vn.T - np.eye(j)))
        if err > tol:
            raise AssertionError(
                f"GMRES V lost orthonormality at iter {iter_count}: "
                f"max |VVᵀ - I| = {err:.3e} (tol {tol:.3e})")
        R = (state["Q"] @ state["H"]).to(torch.float64).cpu().numpy()
        below = np.tril(R[:, :j], k=-1)[:j]
        if np.max(np.abs(below)) > tol * max(1.0, np.max(np.abs(R))):
            raise AssertionError(
                f"GMRES R = Q·H not upper-triangular at iter {iter_count}")

    def final_x(self, state):
        return self.explicit_x(state, int(state["j"]))

    def solve_fused(self):
        return fused_solve(self.setup, self.init_state, self.iterate,
                           self.sample_norm, self.final_x,
                           restart_state_fn=self._restart_state,
                           cycle_len=self.m)
