"""Solver framework: setup, state, harness.

The reference's solver core (solver.hpp:9-193) and harness
(solver_harness.hpp:7-61) in PyTorch:

* `SolverSetup`  — what preprocessing produces (device operator,
                   preconditioner, b, x0); preprocessing.hpp:26-100.
* method objects — per-method `iterate(state) -> state` plus state init
                   and residual accessors (solvers/{cg,jacobi,
                   gauss_seidel,bicgstab,gmres}.py).
* `solve()`      — the do{iterate; sample; check}while loop, in two modes:
                   "host" reads the sampled norm on the host every
                   iteration, like the reference; "fused" keeps the loop
                   condition on the device (solvers/fused.py).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..config import SolverConfig
from ..ops.blas1 import euclidean_vec_norm
from ..precond import (Preconditioner, resolve_gs_mode,
                       setup_preconditioner)
from ..stencil_op import (DeviceStencil, stencil_astype, stencil_diag_vec,
                          stencil_spmv)
from ..types import PrecondType, SolverType
from ..utils.timers import Timers


@dataclasses.dataclass
class SolverSetup:
    """Outputs of preprocessing (the reference's preprocessing.hpp:26-100),
    with the JAX package's fields.  The device-native path fills config,
    A, M, b, x0, n and A_D, and for the GS and SGS methods color_spec,
    n_colors and (on the superblock route) gs_L_block/gs_U_block; the rest
    belong to the host-CSR and permutation paths of later slices and stay
    at their defaults."""

    config: SolverConfig
    A: Any                       # device operator (DeviceStencil)
    M: Preconditioner
    b: torch.Tensor
    x0: torch.Tensor
    n: int
    A_host: Any = None
    factors: Any = None
    L_solve: Any = None
    U_solve: Any = None
    U_strict_dev: Any = None
    L_strict_dev: Any = None
    A_D: Optional[torch.Tensor] = None
    scale_vec: Optional[torch.Tensor] = None
    inv_perm: Optional[torch.Tensor] = None
    x_decode: Optional[Callable] = None
    color_spec: Any = None
    color_arr: Optional[torch.Tensor] = None
    n_colors: int = 0
    gs_L_block: Any = None
    gs_U_block: Any = None

    @property
    def dtype(self) -> torch.dtype:
        return self.b.dtype


def _vector(v, n: int, fill: float, dtype, device) -> torch.Tensor:
    if v is None:
        return torch.full((n,), fill, dtype=dtype, device=device)
    v = torch.as_tensor(v, dtype=dtype, device=device).contiguous()
    if v.shape != (n,):
        raise ValueError(f"vector has shape {tuple(v.shape)}, expected ({n},)")
    return v


def preprocessing_device(A_dev, config: SolverConfig, b: Optional[Any] = None,
                         x0: Optional[Any] = None,
                         timers: Optional[Timers] = None) -> SolverSetup:
    """Device-native preprocessing for a matrix-free stencil operator: cast
    it to the configured storage dtype, make b and x0 (config.b_val and
    config.init_x_val unless given) on the operator's device, set up the
    preconditioner and, for the GS and SGS methods, the colouring and,
    where the operator allows it, the const-mode superblock pair
    (ops/block_trisolve.py; else the masked colour sweeps)."""
    if not isinstance(A_dev, DeviceStencil):
        raise TypeError(
            f"unsupported operator type {type(A_dev).__name__}: the DIA and "
            "general-sparsity formats arrive with ROADMAP Queue 1 slice 5")
    timers = timers or Timers()
    dtype = config.spec_dtype()
    n = A_dev.n_rows
    if A_dev.n_rows != A_dev.n_cols:
        raise ValueError("Matrix must be square.")
    if config.num_scale:
        raise ValueError(
            "num_scale breaks the constant-coefficient structure; use the "
            "DIA format (matrix_format='dia') for scaled solves")
    if config.mat_dtype() != dtype:
        raise NotImplementedError(
            "an operator dtype other than the vector dtype (matrix_dtype) "
            "arrives with ROADMAP Queue 1 slice 6")
    gs_method = config.method in (SolverType.GAUSS_SEIDEL,
                                  SolverType.SYMMETRIC_GAUSS_SEIDEL)
    if gs_method and resolve_gs_mode(config, device_native=True) != "colored":
        raise ValueError(
            f"method {config.method} with gs_mode={config.gs_mode!r} needs "
            "exact triangular solves in the natural ordering: the host CSR "
            "path, which arrives with ROADMAP Queue 1 slice 5")
    A_dev = stencil_astype(A_dev, dtype)
    device = A_dev.device
    b_dev = _vector(b, n, config.b_val, dtype, device)
    x0_dev = _vector(x0, n, config.init_x_val, dtype, device)
    with timers.time("preprocessing_device"):
        M = setup_preconditioner(A_dev, config)
        A_D = (M.A_D if M.A_D is not None
               else stencil_diag_vec(A_dev).to(dtype))
        setup = SolverSetup(config=config, A=A_dev, M=M, b=b_dev, x0=x0_dev,
                            n=n, A_D=A_D)
        if gs_method:
            from ..coloring import spec_for_device
            from ..ops.block_trisolve import (
                build_superblock_gs_pair_stencil, stencil_blocked_eligible)
            setup.color_spec = spec_for_device(A_dev)
            setup.n_colors = setup.color_spec.n_colors
            if stencil_blocked_eligible(A_dev, setup.color_spec):
                # residual-form sweeps through the const-mode superblock
                # solves: x ← x + M⁻¹(b − A·x), M the exact GS/SGS operator
                # of the coloured ordering
                sym = config.method == SolverType.SYMMETRIC_GAUSS_SEIDEL
                L_blk, U_blk = build_superblock_gs_pair_stencil(
                    A_dev, setup.color_spec, dtype=dtype, need_d=sym)
                setup.gs_L_block = L_blk
                setup.gs_U_block = U_blk if sym else None
        return setup


def _f64_operands(setup: SolverSetup):
    """(A64, b64): the operator and right-hand side upcast to float64 on
    their device, cached on the setup (one-time device work)."""
    cached = getattr(setup, "_f64_ops_cache", None)
    if cached is None:
        cached = (stencil_astype(setup.A, torch.float64),
                  setup.b.to(torch.float64))
        setup._f64_ops_cache = cached
    return cached


def residual_f64(setup: SolverSetup, x: torch.Tensor) -> torch.Tensor:
    """b − A·x in float64 on x's device; on a card this runs the float64
    stencil kernel."""
    A64, b64 = _f64_operands(setup)
    return b64 - stencil_spmv(A64, x.to(torch.float64))


def explicit_residual_norm(setup: SolverSetup, x_star: torch.Tensor) -> float:
    """||b − A·x*||₂ in float64 for the final report (the reference's
    save_x_star, solver.hpp:153-159), whatever the solve dtype."""
    return float(euclidean_vec_norm(residual_f64(setup, x_star)))


def finalize_x(setup: SolverSetup, x_star: torch.Tensor) -> torch.Tensor:
    """Map the solution back to user coordinates (vector-layout decode,
    then the inverse permutation), where the setup has them."""
    if setup.x_decode is not None:
        x_star = setup.x_decode(x_star)
    if setup.inv_perm is not None:
        return x_star[setup.inv_perm]
    return x_star


@dataclasses.dataclass
class SolveResult:
    """Postprocessing inputs (the reference's postprocessing.hpp:33-68)."""

    x_star: torch.Tensor              # on the solve's device
    iter_count: int
    converged: bool
    stopping_criteria: float
    residual_norms: np.ndarray        # sampled ||r|| history + explicit final
    time_per_iteration: np.ndarray    # seconds per sampled iteration
    final_residual_norm: float        # explicit ||b - A x_star|| in float64
    gmres_restart_count: int = 0
    method: Optional[SolverType] = None
    preconditioner: Optional[PrecondType] = None
    restart_length: int = 0
    res_check_len: int = 1
    solve_seconds: float = 0.0
    #: fused-harness runs record the solve-average per iteration
    uniform_iteration_times: bool = False
    refine_outer_count: int = 0


def _stopping(config: SolverConfig, r0_norm):
    """stopping_criteria = tol * ||b - A x0||_2 (solver.hpp:173-175)."""
    return config.tolerance * r0_norm


def solve(setup: SolverSetup, method=None, timers: Optional[Timers] = None,
          progress: Optional[Callable[[int, float], None]] = None
          ) -> SolveResult:
    """Run the solver harness named by `setup.config.harness`."""
    if setup.config.refine_outer > 0:
        raise NotImplementedError(
            "mixed-precision refinement arrives with ROADMAP Queue 1 slice 6")
    from .factory import make_method
    method = method or make_method(setup)
    if setup.config.harness == "fused" and method.supports_fused:
        return method.solve_fused()
    return _solve_host(setup, method, timers or Timers(), progress)


def _solve_host(setup: SolverSetup, method, timers: Timers,
                progress=None) -> SolveResult:
    """Host-driven loop with the semantics of solver_harness.hpp:15-51: one
    host read of the sampled norm per sample, per-iteration wall times."""
    config = setup.config
    if config.kernel_timers:
        raise NotImplementedError(
            "per-kernel timers arrive with ROADMAP Queue 1 slice 7")
    state = method.init_state()
    r0_norm = float(method.initial_residual_norm(state))
    stopping = _stopping(config, r0_norm)

    max_hist = config.max_iters * 2 + 2
    norms = np.zeros(max_hist)
    times = np.zeros(max_hist)
    norms[0] = r0_norm
    hist_count = 1

    iter_count = 0
    restart_count = 0
    residual_norm = r0_norm
    res_milestones = {1e-3: False, 1e-6: False}
    # the reference's SanityChecker hooks (IF_DEBUG_MODE), where the
    # method defines one (GMRES)
    debug_check = (getattr(method, "debug_check", None)
                   if config.debug_checks else None)
    t_solve0 = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        state = method.iterate(state)
        iter_count += 1
        if debug_check is not None:
            debug_check(state, iter_count)
        if iter_count % config.res_check_len == 0:
            residual_norm = float(method.sample_norm(state))
            norms[hist_count] = residual_norm
            times[hist_count] = time.perf_counter() - t0
            hist_count += 1
        for thresh in res_milestones:
            if (residual_norm / r0_norm < thresh
                    and not res_milestones[thresh]):
                res_milestones[thresh] = True
                if progress:
                    progress(iter_count, residual_norm)
        state, restarted, restart_norm = method.check_restart(
            state, iter_count, residual_norm, stopping)
        if restarted:
            restart_count += 1
            residual_norm = restart_norm
            norms[hist_count] = restart_norm
            times[hist_count] = time.perf_counter() - t0
            hist_count += 1
        # check_stopping_criteria (solver.hpp:177-191)
        diverged = not np.isfinite(residual_norm)
        over_max = iter_count >= (config.max_iters - restart_count)
        if abs(residual_norm) < stopping or over_max or diverged:
            break
    x_star = method.final_x(state)
    if x_star.is_cuda:
        torch.cuda.synchronize(x_star.device)
    solve_seconds = time.perf_counter() - t_solve0

    converged = residual_norm < stopping
    final_norm = explicit_residual_norm(setup, x_star)
    x_star = finalize_x(setup, x_star)
    norms[hist_count] = final_norm
    hist_count += 1
    return SolveResult(
        x_star=x_star, iter_count=iter_count, converged=converged,
        stopping_criteria=stopping,
        residual_norms=norms[:hist_count],
        time_per_iteration=times[:hist_count],
        final_residual_norm=final_norm,
        gmres_restart_count=restart_count,
        method=config.method, preconditioner=config.preconditioner,
        restart_length=config.restart_length,
        res_check_len=config.res_check_len,
        solve_seconds=solve_seconds)
