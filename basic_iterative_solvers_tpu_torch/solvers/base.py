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
from ..precond import (COLORED_PRECONDS, Preconditioner, resolve_gs_mode,
                       setup_preconditioner)
from ..stencil_op import (DeviceStencil, resolve_device, stencil_astype,
                          stencil_diag_vec)
from ..types import PrecondType, SolverType
from ..utils.timers import Timers

_GS_METHODS = (SolverType.GAUSS_SEIDEL, SolverType.SYMMETRIC_GAUSS_SEIDEL)


@dataclasses.dataclass
class SolverSetup:
    """Outputs of preprocessing (the reference's preprocessing.hpp:26-100),
    with the JAX package's fields.  The host-CSR path (`preprocessing`)
    keeps the host matrix (A_host), its factors and, for the GS methods,
    the level-scheduled solves and strict parts or the greedy colours; the
    device-native path (`preprocessing_device`) fills config, A, M, b, x0,
    n and A_D, and for the GS methods color_spec, n_colors and (on the
    superblock route) gs_L_block/gs_U_block."""

    config: SolverConfig
    A: Any                       # device operator
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


def _host_vector(v, n: int, fill: float) -> np.ndarray:
    """A float64 numpy copy of v (a tensor on any device, an array or
    None: the fill value)."""
    if v is None:
        return np.full(n, fill, dtype=np.float64)
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    v = np.asarray(v, dtype=np.float64)
    if v.shape != (n,):
        raise ValueError(f"vector has shape {v.shape}, expected ({n},)")
    return v


def _auto_rcm(A, config: SolverConfig, timers: Timers):
    """The JAX package's guard against the gather ELL: where "auto" would
    pick it, try RCM and keep it if it brings the column span within the
    lane-ELL window; else warn.  Returns (A, perm or None, inv or None)."""
    import sys
    import warnings
    from ..device_matrix import (LANE_ELL_MAX_SPAN, GatherFallbackWarning,
                                 auto_format_choice)
    from ..ops.lane_ell import lane_ell_span
    from ..permute import compute_permutation, permute_csr
    if auto_format_choice(A, config.dia_max_diags,
                          config.dia_min_fill) != "ell":
        return A, None, None
    with timers.time("preprocessing_auto_rcm"):
        perm, inv = compute_permutation(A, "rcm")
        A_rcm = permute_csr(A, perm, inv)
    if lane_ell_span(A_rcm) <= LANE_ELL_MAX_SPAN:
        print("NOTE: column span exceeds the lane-ELL window; "
              "auto-applied RCM reordering (disable with auto_rcm=False / "
              "-perm none stays the solve ordering).", file=sys.stderr)
        return A_rcm, perm, inv
    warnings.warn(
        "matrix falls back to the gather ELL path: column span "
        f"{lane_ell_span(A)} > {LANE_ELL_MAX_SPAN} even after RCM. Consider "
        "a bandwidth-reducing ordering or the DIA/stencil formats.",
        GatherFallbackWarning, stacklevel=3)
    return A, None, None


def preprocessing(A, config: SolverConfig, b: Optional[Any] = None,
                  x0: Optional[Any] = None, timers: Optional[Timers] = None,
                  A_dev=None, *, device="cuda") -> SolverSetup:
    """Host-CSR preprocessing (the JAX package's solvers/base.py:77-245):
    b and x0 (config.b_val and config.init_x_val unless given), optional
    symmetric diagonal scaling (num_scale), reordering (perm_mode, or the
    automatic RCM that keeps a scattered pattern off the gather ELL),
    L/U factors where the method or preconditioner needs them, the device
    operator (from_csr in config.matrix_format) and the preconditioner, all
    on `device`, the card unless the caller asks for the CPU.

    `A_dev` injects a device operator of the same matrix in the same row
    ordering (e.g. a matrix-free stencil) as setup.A; it requires
    perm_mode "none" and no num_scale."""
    from ..device_matrix import from_csr
    from ..factor import extract_scale, factor_LU, scale_mat
    device = resolve_device(device)
    timers = timers or Timers()
    dtype = config.spec_dtype()
    n = A.n_rows
    if A.n_rows != A.n_cols:
        raise ValueError("Matrix must be square.")
    if config.mat_dtype() != dtype:
        raise NotImplementedError(
            "an operator dtype other than the vector dtype (matrix_dtype) "
            "arrives with ROADMAP Queue 1 slice 6")
    if A_dev is not None and (config.num_scale
                              or config.perm_mode != "none"):
        raise ValueError("A_dev injection requires perm_mode='none' and "
                         "num_scale=False (the operator would not reflect "
                         "the transformed matrix)")
    b_host = _host_vector(b, n, config.b_val)
    x0_host = _host_vector(x0, n, config.init_x_val)
    scale_vec = None
    if config.num_scale:
        with timers.time("preprocessing_scale"):
            A = A.copy()
            scale_vec = extract_scale(A)
            scale_mat(A, scale_vec)
            b_host = b_host * scale_vec
            x0_host = x0_host * scale_vec
    perm = inv_perm = None
    if config.perm_mode != "none":
        from ..permute import compute_permutation, permute_csr
        with timers.time("preprocessing_permute"):
            perm, inv_perm = compute_permutation(A, config.perm_mode)
            A = permute_csr(A, perm, inv_perm)
    elif (config.auto_rcm and config.color_spec is None and A_dev is None
          and config.matrix_format in ("auto", "lane_ell") and A.nnz):
        A, perm, inv_perm = _auto_rcm(A, config, timers)
    if perm is not None:
        b_host, x0_host = b_host[perm], x0_host[perm]

    gs_colored = resolve_gs_mode(config, device_native=False) == "colored"
    pt = config.preconditioner
    # coloured ILU(0) and the coloured GS family set themselves up from A
    # (setup_preconditioner); the natural-order split is needed only where
    # the method or the preconditioner uses it
    self_sufficient = pt in COLORED_PRECONDS + (PrecondType.ILU0,) \
        and gs_colored
    factors = None
    if ((pt != PrecondType.NONE and not self_sufficient)
            or config.method in (SolverType.JACOBI,) + _GS_METHODS):
        with timers.time("preprocessing_factor"):
            factors = factor_LU(
                A, ilu0=(pt == PrecondType.ILU0 and not gs_colored),
                pivot_tolerance=config.ilu0_pivot_tolerance,
                pivot_replacement=config.ilu0_pivot_replacement)
    to_dev = lambda a, dt=dtype: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a)).to(dtype=dt, device=device)
    with timers.time("preprocessing_device"):
        if A_dev is None:
            A_dev = from_csr(A, config.mat_dtype(), config.matrix_format,
                             config.dia_max_diags, config.dia_min_fill,
                             device=device)
        M = setup_preconditioner(A, config, factors, A_dev=A_dev,
                                 device=device)
        setup = SolverSetup(
            config=config, A=A_dev, M=M, b=to_dev(b_host), x0=to_dev(x0_host),
            n=n, A_host=A, factors=factors,
            scale_vec=None if scale_vec is None else to_dev(scale_vec),
            inv_perm=(None if inv_perm is None
                      else to_dev(inv_perm, torch.int64)),
            A_D=None if factors is None else to_dev(factors.A_D))
    if config.method in _GS_METHODS:
        if gs_colored:
            from ..coloring import greedy_coloring
            with timers.time("preprocessing_coloring"):
                colors = greedy_coloring(A)
                setup.color_arr = to_dev(colors, torch.int64)
                setup.n_colors = int(colors.max()) + 1
            return setup
        from ..ops.trisolve import build_trisolve
        strict = lambda T: from_csr(  # noqa: E731
            T, dtype, config.matrix_format, config.dia_max_diags,
            config.dia_min_fill, device=device)
        with timers.time("preprocessing_levels"):
            setup.L_solve = build_trisolve(factors.L_strict, factors.A_D,
                                           upper=False, dtype=dtype,
                                           device=device)
            setup.U_strict_dev = strict(factors.U_strict)
            if config.method == SolverType.SYMMETRIC_GAUSS_SEIDEL:
                setup.U_solve = build_trisolve(factors.U_strict, factors.A_D,
                                               upper=True, dtype=dtype,
                                               device=device)
                setup.L_strict_dev = strict(factors.L_strict)
    return setup


def preprocessing_device(A_dev, config: SolverConfig, b: Optional[Any] = None,
                         x0: Optional[Any] = None,
                         timers: Optional[Timers] = None) -> SolverSetup:
    """Device-native preprocessing for a matrix-free stencil or a DIA
    matrix: cast it to the configured storage dtype, make b and x0
    (config.b_val and config.init_x_val unless given) on the operator's
    device, scale a DIA matrix symmetrically (num_scale), set up the
    preconditioner and, for the GS and SGS methods, the colouring and,
    where a stencil allows it, the const-mode superblock pair
    (ops/block_trisolve.py; else the masked colour sweeps).  Methods and
    preconditioners that need natural-order triangular solves take
    `preprocessing` on host CSR."""
    from ..device_matrix import DeviceDIA
    from ..dia import dia_diag, dia_extract_scale, dia_scale
    if not isinstance(A_dev, (DeviceStencil, DeviceDIA)):
        raise TypeError(
            f"unsupported operator type {type(A_dev).__name__}: the "
            "device-native path takes DeviceStencil and DeviceDIA; other "
            "formats go through preprocessing (host CSR)")
    timers = timers or Timers()
    dtype = config.spec_dtype()
    n = A_dev.n_rows
    is_stencil = isinstance(A_dev, DeviceStencil)
    if A_dev.n_rows != A_dev.n_cols:
        raise ValueError("Matrix must be square.")
    if config.num_scale and is_stencil:
        raise ValueError(
            "num_scale breaks the constant-coefficient structure; use the "
            "DIA format (matrix_format='dia') for scaled solves")
    if config.mat_dtype() != dtype:
        raise NotImplementedError(
            "an operator dtype other than the vector dtype (matrix_dtype) "
            "arrives with ROADMAP Queue 1 slice 6")
    gs_method = config.method in _GS_METHODS
    if gs_method and resolve_gs_mode(config, device_native=True) != "colored":
        raise ValueError(
            f"method {config.method} with gs_mode={config.gs_mode!r} needs "
            "exact triangular solves in the natural ordering: use "
            "preprocessing() (the host CSR path)")
    A_dev = (stencil_astype(A_dev, dtype) if is_stencil else
             dataclasses.replace(A_dev, data=A_dev.data.to(dtype)))
    device = A_dev.device
    b_dev = _vector(b, n, config.b_val, dtype, device)
    x0_dev = _vector(x0, n, config.init_x_val, dtype, device)
    scale_vec = None
    if config.num_scale:
        with timers.time("preprocessing_scale"):
            scale_vec = dia_extract_scale(A_dev)
            A_dev = dia_scale(A_dev, scale_vec)
            b_dev = b_dev * scale_vec
            x0_dev = x0_dev * scale_vec
    with timers.time("preprocessing_device"):
        M = setup_preconditioner(A_dev, config)
        A_D = (M.A_D if M.A_D is not None else
               (stencil_diag_vec(A_dev) if is_stencil
                else dia_diag(A_dev)).to(dtype))
        setup = SolverSetup(config=config, A=A_dev, M=M, b=b_dev, x0=x0_dev,
                            n=n, A_D=A_D, scale_vec=scale_vec)
        if gs_method:
            from ..coloring import spec_for_device
            from ..ops.block_trisolve import (
                build_superblock_gs_pair_stencil, stencil_blocked_eligible)
            setup.color_spec = spec_for_device(A_dev)
            setup.n_colors = setup.color_spec.n_colors
            if is_stencil and stencil_blocked_eligible(A_dev,
                                                       setup.color_spec):
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
    """(A64, b64): the operator and right-hand side in float64 on their
    device, cached on the setup (one-time work).  A stencil or DIA matrix
    is upcast; a host-CSR setup's operator is rebuilt from the float64
    host matrix in the same format, so the residual sees the exact
    values."""
    cached = getattr(setup, "_f64_ops_cache", None)
    if cached is not None:
        return cached
    from ..device_matrix import DeviceDIA, DeviceELL, from_csr
    A = setup.A
    if isinstance(A, DeviceStencil):
        A64 = stencil_astype(A, torch.float64)
    elif setup.A_host is not None:
        fmt = ("dia" if isinstance(A, DeviceDIA) else
               "ell" if isinstance(A, DeviceELL) else "lane_ell")
        A64 = from_csr(setup.A_host, torch.float64, fmt, device=A.device)
    else:
        A64 = dataclasses.replace(A, data=A.data.to(torch.float64))
    setup._f64_ops_cache = (A64, setup.b.to(torch.float64))
    return setup._f64_ops_cache


def residual_f64(setup: SolverSetup, x: torch.Tensor) -> torch.Tensor:
    """b − A·x in float64 on x's device, in solve coordinates; on a card
    this runs the operator's float64 kernel."""
    from ..ops.spmv import spmv
    A64, b64 = _f64_operands(setup)
    return b64 - spmv(A64, x.to(torch.float64))


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
