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
from ..ops.blas1 import (euclidean_vec_norm, full_value, is_dtensor,
                         is_mesh_vector, is_sharded)
from ..precond import (COLORED_PRECONDS, Preconditioner, resolve_gs_mode,
                       run_whole, setup_preconditioner)
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


def laid_out_like_b(setup, v: torch.Tensor):
    """v, one tensor of the setup's rows on its first device, laid out as
    the setup's b: row-sharded in the GSPMD mode, a MeshVector of b's
    layout in the shard_map mode (Mesh.scatter), v itself otherwise."""
    b = setup.b
    if is_dtensor(b):
        from ..parallel.gspmd import shard_rows
        return shard_rows(v, b.device_mesh)
    if is_mesh_vector(b):
        return b.mesh.scatter(v, b.blocks.rows)
    return v


def _host_vector(v, n: int, fill: float) -> np.ndarray:
    """A float64 numpy copy of v (a tensor on any device, an array or
    None: the fill value)."""
    if v is None:
        return np.full(n, fill, dtype=np.float64)
    if isinstance(v, torch.Tensor):
        v = full_value(v.detach()).cpu().numpy()
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
        if config.debug_checks and pt != PrecondType.ILU0:
            # the reference's SanityChecker::check_copied_L_U_elems
            # (common.hpp:532-542); ILU(0)'s factors count a unit diagonal
            from ..utils.sanity import check_lu_split_counts
            check_lu_split_counts(A, factors.L, factors.L_strict,
                                  factors.U, factors.U_strict)
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
    matrix: cast it to the configured storage dtype (config.mat_dtype():
    a stencil's coefficients and diagonal, DIA data), make b and x0
    (vector dtype, as every diagonal the preconditioner keeps)
    from config.b_val and config.init_x_val unless given, on the operator's
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
    gs_method = config.method in _GS_METHODS
    if gs_method and resolve_gs_mode(config, device_native=True) != "colored":
        raise ValueError(
            f"method {config.method} with gs_mode={config.gs_mode!r} needs "
            "exact triangular solves in the natural ordering: use "
            "preprocessing() (the host CSR path)")
    md = config.mat_dtype()
    A_dev = (stencil_astype(A_dev, md) if is_stencil else
             dataclasses.replace(A_dev, data=A_dev.data.to(md)))
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
            if (is_stencil and config.planar_vectors != "on"
                    and stencil_blocked_eligible(A_dev, setup.color_spec)):
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
    values.  A mesh setup's oracle is its mesh operator around the
    float64 copy, on the shards' rows of its MeshVectors; a GSPMD setup's
    is its DTensor operator around the float64 copy, on the ranks' rows
    of the sharded vectors (the refinement forms reach the operator only
    through here)."""
    cached = getattr(setup, "_f64_ops_cache", None)
    if cached is not None:
        return cached
    from ..device_matrix import DeviceDIA, DeviceELL, from_csr
    from ..parallel.mesh_ops import DIST_TYPES, MESH_TYPES, rewrap, unwrap
    A = unwrap(setup.A)
    if isinstance(A, DeviceStencil):
        A64 = stencil_astype(A, torch.float64)
    elif setup.A_host is not None:
        fmt = ("dia" if isinstance(A, DeviceDIA) else
               "ell" if isinstance(A, DeviceELL) else "lane_ell")
        A64 = from_csr(setup.A_host, torch.float64, fmt, device=A.device)
    else:
        A64 = dataclasses.replace(A, data=A.data.to(torch.float64))
    if isinstance(setup.A, DIST_TYPES + MESH_TYPES):
        A64 = rewrap(setup.A, A64)
    setup._f64_ops_cache = (A64, setup.b.to(torch.float64))
    return setup._f64_ops_cache


def _resid64_runner(setup: SolverSetup) -> Callable:
    """`run(x) -> b − A·x` in float64 on the operands' device, x cast
    straight to float64 (through the solve dtype it would lose what
    refinement accumulates); built once per setup.  On a card a stencil
    runs its float64 kernel."""
    cached = getattr(setup, "_resid64_cache", None)
    if cached is not None:
        return cached
    from ..ops.spmv import spmv
    A64, b64 = _f64_operands(setup)

    def run(x):
        return b64 - spmv(A64, x.to(torch.float64))

    setup._resid64_cache = run
    return run


def residual_f64(setup: SolverSetup, x: torch.Tensor) -> torch.Tensor:
    """b − A·x in float64 on x's device, in solve coordinates; on a card
    this runs the operator's float64 kernel."""
    return _resid64_runner(setup)(x)


def explicit_residual_norm(setup: SolverSetup, x_star: torch.Tensor) -> float:
    """||b − A·x*||₂ in float64 for the final report (the reference's
    save_x_star, solver.hpp:153-159), whatever the solve dtype."""
    return float(full_value(euclidean_vec_norm(residual_f64(setup, x_star))))


def finalize_x(setup: SolverSetup, x_star: torch.Tensor) -> torch.Tensor:
    """Map the solution back to user coordinates (vector-layout decode,
    then the inverse permutation), where the setup has them; a sharded
    solution (either mode) is mapped whole and keeps its layout
    (precond.run_whole)."""
    if is_sharded(x_star) and (setup.x_decode is not None
                               or setup.inv_perm is not None):
        return run_whole(lambda x: finalize_x(setup, x), x_star)
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
    """Run the solver harness named by `setup.config.harness`, or, with
    refine_outer > 0, mixed-precision refinement around it: the single-
    dispatch form where `_refine_fused_eligible`, else the per-outer
    form."""
    if setup.config.refine_outer > 0:
        if _refine_fused_eligible(setup):
            return _solve_refined_fused(setup)
        return _solve_refined(setup)
    from .factory import make_method
    method = method or make_method(setup)
    if setup.config.harness == "fused" and method.supports_fused:
        return method.solve_fused()
    return _solve_host(setup, method, timers or Timers(), progress)


# ---------------------------------------------------------------------------
# Mixed-precision iterative refinement (config.refine_outer > 0)
#
# Wilkinson refinement around the configured solver: the inner solves run
# at the solve dtype to refine_inner_tol relative, on the unit-scaled
# right-hand side r/‖r‖ (every inner solve in the same numerical regime),
# while the outer loop computes the true float64 residual and accumulates
# x in float64, so that tol·‖b − A·x₀‖ is reachable from float32 inners.
# Two forms, as in the JAX package: the single-dispatch form (CG and GMRES
# in the fused harness on a device oracle) and the per-outer form (the
# rest: BiCGSTAB's retry ladder, the host-CSR oracle).  The JAX package
# compiles the first into one program and re-points a compiled loop at
# each outer's right-hand side in the second; the port runs its loops
# again each outer, with the same results.
# ---------------------------------------------------------------------------

def _refine_device_runner(setup: SolverSetup):
    """(start, step) of the per-outer form on the device oracle:

    start(x0) -> (x64, ‖r‖, r/‖r‖ in the solve dtype)
    step(x64, x_inner, r_scale) -> (x64 + r_scale·x_inner, ‖r'‖, r'/‖r'‖)

    with r the float64 residual; ‖r‖ stays a 0-d device tensor.  Built
    once per setup."""
    cached = getattr(setup, "_refine_dev_cache", None)
    if cached is not None:
        return cached
    resid = _resid64_runner(setup)
    dtype = setup.config.spec_dtype()

    def _norm_rhs(x64):
        r = resid(x64)
        rn = euclidean_vec_norm(r)
        # rn == 0 gives a NaN right-hand side, never solved: the caller
        # reads rn first
        return rn, (r / rn).to(dtype)

    def start(x0):
        x64 = x0.to(torch.float64)
        return (x64,) + _norm_rhs(x64)

    def step(x64, x_inner, r_scale):
        x_next = torch.addcmul(x64, x_inner.to(torch.float64), r_scale)
        return (x_next,) + _norm_rhs(x_next)

    setup._refine_dev_cache = (start, step)
    return start, step


def _refine_fused_eligible(setup: SolverSetup) -> bool:
    """The single-dispatch form: a device oracle (no host CSR), the fused
    harness, a classic-CG or GMRES(m) inner, solve coordinates equal to
    the user's (no permutation, no scaling)."""
    cfg = setup.config
    method_ok = ((cfg.method == SolverType.CONJUGATE_GRADIENT
                  and cfg.cg_flavor == "classic")
                 or cfg.method == SolverType.GMRES)
    return (setup.A_host is None and cfg.harness == "fused" and method_ok
            and setup.inv_perm is None and setup.scale_vec is None)


def _gated_steps(method, state, rn, stop, count: int, finite: bool):
    """Up to `count` steps of `method` while rn > stop (and rn is finite,
    where `finite`): gated steps, the loop condition on the device, read
    on the host every CHECK_EVERY steps.  Returns (state, rn, active steps
    as a 0-d tensor)."""
    from .fused import CHECK_EVERY
    active = rn > stop
    if finite:
        active = active & torch.isfinite(rn)
    n = torch.zeros((), dtype=torch.int64, device=rn.device)
    done = 0
    while done < count:
        chunk = min(CHECK_EVERY, count - done)
        for _ in range(chunk):
            state = method.iterate(state, active)
            n = n + active
            rn = torch.where(active, method.sample_norm(state), rn)
            active = active & (rn > stop)
            if finite:
                active = active & torch.isfinite(rn)
        done += chunk
        if not bool(full_value(active)):
            break
    return state, rn, n


def _inner_fused(method, inner_tol: float, inner_max: int):
    """One inner solve of the single-dispatch form, with its loop's
    semantics (the JAX package's _build_refined_fused._inner_solve): steps
    while it < inner_max and ‖r‖ > inner_tol·‖r₀‖; a restarted method
    (GMRES(m)) runs cycles of at most m steps within it < inner_max −
    restarts, and restarts after a completed cycle still above the stop
    and finite.  Returns (x, iterations)."""
    state = method.init_state()
    rn = method.initial_residual_norm(state)
    stop = inner_tol * rn
    restart_fn = getattr(method, "_restart_state", None)
    if restart_fn is None:
        state, rn, it = _gated_steps(method, state, rn, stop, inner_max,
                                     finite=False)
        return method.final_x(state), int(full_value(it))
    it = restarts = 0
    while True:
        budget = inner_max - restarts - it
        if budget <= 0 or not bool(full_value((rn > stop)
                                              & torch.isfinite(rn))):
            break
        state, rn, j = _gated_steps(method, state, rn, stop,
                                    min(method.m, budget), finite=True)
        j = int(full_value(j))
        it += j
        if not (j == method.m and bool(full_value((rn > stop)
                                                  & torch.isfinite(rn)))):
            break
        state = restart_fn(state)
        rn = state["residual_norm"]
        restarts += 1
    return method.final_x(state), it


def _solve_refined_fused(setup: SolverSetup) -> SolveResult:
    """The single-dispatch form (the JAX package's _build_refined_fused and
    _solve_refined_fused): at most refine_outer outers with no retry
    ladder.  An outer whose true residual regresses (or is NaN) stops the
    loop and keeps the best x; it still counts in refine_outer_count and
    its inner iterations in the total, and its norm goes to history index
    refine_outer (left out of the returned history).  The loop also stops
    at tol·‖r₀‖ and when an outer gains less than 2×.  x_star is the
    float64 solution."""
    from .factory import make_method
    cfg = setup.config
    resid64 = _resid64_runner(setup)
    dtype = cfg.spec_dtype()
    K = cfg.refine_outer
    inner_cfg = dataclasses.replace(cfg, refine_outer=0,
                                    tolerance=cfg.refine_inner_tol)
    x0_inner = torch.zeros_like(setup.x0)

    def resid(x64):
        r = resid64(x64)
        return r, euclidean_vec_norm(r)

    t0 = time.perf_counter()
    x = setup.x0.to(torch.float64)
    r, rn = resid(x)
    stopping = cfg.tolerance * rn
    hist = np.zeros(K + 1)
    hist[0] = float(full_value(rn))
    b_unit, r_scale = (r / rn).to(dtype), rn
    k, n_hist, it_tot = 0, 1, 0
    go = bool(full_value(rn > stopping))
    while go and k < K:
        method = make_method(dataclasses.replace(
            setup, config=inner_cfg, b=b_unit, x0=x0_inner))
        xi, it = _inner_fused(method, cfg.refine_inner_tol, cfg.max_iters)
        x_next = torch.addcmul(x, xi.to(torch.float64), r_scale)
        r2, rn2 = resid(x_next)
        improved = bool(full_value(rn2 <= rn))     # NaN compares False
        k += 1
        hist[n_hist if improved else K] = float(full_value(rn2))
        go = (improved and bool(full_value(rn2 > stopping))
              and bool(full_value(rn2 <= 0.5 * rn)))
        if improved:
            x, rn = x_next, rn2
            n_hist += 1
        b_unit, r_scale = (r2 / rn2).to(dtype), rn2
        it_tot += it
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    dt = time.perf_counter() - t0
    final_norm = float(full_value(rn))
    stopping = float(full_value(stopping))
    return SolveResult(
        x_star=x, iter_count=it_tot,
        converged=final_norm <= stopping,
        stopping_criteria=stopping,
        residual_norms=hist[:n_hist],
        time_per_iteration=np.full(n_hist, dt / max(1, n_hist)),
        final_residual_norm=final_norm,
        gmres_restart_count=0, method=cfg.method,
        preconditioner=cfg.preconditioner,
        restart_length=cfg.restart_length, res_check_len=cfg.res_check_len,
        solve_seconds=dt, uniform_iteration_times=True,
        refine_outer_count=k)


def _host_refine_runner(setup: SolverSetup):
    """(start, step) of the per-outer form on the host-CSR oracle: the
    float64 residual b − A·x by the host matrix's NumPy SpMV, x and ‖r‖ on
    the host, the next right-hand side r/‖r‖ on the setup's device (None
    when ‖r‖ = 0), laid out like b (`laid_out_like_b`)."""
    dtype, device = setup.config.spec_dtype(), setup.b.device
    b64 = _host_vector(setup.b, setup.n, 0.0)

    def _norm_rhs(x64):
        r = b64 - setup.A_host.spmv(x64)
        rn = float(np.linalg.norm(r))
        if rn == 0.0:
            return rn, None
        rhs = torch.from_numpy(r / rn).to(dtype=dtype, device=device)
        return rn, laid_out_like_b(setup, rhs)

    def start(x0):
        if setup.x_decode is not None:
            x0 = setup.x_decode(x0)
        x64 = _host_vector(x0, setup.n, 0.0)
        return (x64,) + _norm_rhs(x64)

    def step(x64, x_inner, r_scale):
        x_next = x64 + float(r_scale) * _host_vector(x_inner, setup.n, 0.0)
        return (x_next,) + _norm_rhs(x_next)

    return start, step


def _solve_refined(setup: SolverSetup) -> SolveResult:
    """The per-outer form (the JAX package's _solve_refined): each outer a
    whole inner `solve` at refine_inner_tol from x = 0 on r/‖r‖.  A
    non-finite outer residual (an inner broken down past its attainable
    floor, as f32 BiCGSTAB does) retries that outer with the inner
    tolerance loosened 100× up to 1e-2, then gives up; an outer that makes
    the true residual worse stops the loop and keeps the previous x; the
    loop stops at tol·‖r₀‖ and when an outer gains less than 2×."""
    import math
    cfg = setup.config
    if setup.inv_perm is not None or setup.scale_vec is not None:
        raise ValueError(
            "iterative refinement requires perm_mode='none' and "
            "num_scale=False (corrections accumulate in solve coordinates)")
    t0 = time.perf_counter()
    start, step = (_refine_device_runner(setup) if setup.A_host is None
                   else _host_refine_runner(setup))
    x, rn0, b_next = start(setup.x0)
    r0_norm = float(full_value(rn0))
    stopping = _stopping(cfg, r0_norm)
    inner_cfg = dataclasses.replace(cfg, refine_outer=0,
                                    tolerance=cfg.refine_inner_tol)
    x0_inner = torch.zeros_like(setup.x0)
    total_iters, restarts, outers = 0, 0, 0
    outer_norms = [r0_norm]
    converged = r0_norm <= stopping
    prev_rn, r_scale = r0_norm, rn0

    def inner(config):
        nonlocal total_iters, restarts
        res = solve(dataclasses.replace(setup, config=config, b=b_next,
                                        x0=x0_inner))
        total_iters += res.iter_count
        restarts += res.gmres_restart_count
        return res.x_star

    for _ in range(cfg.refine_outer):
        if converged or b_next is None:
            break
        x_inner = inner(inner_cfg)
        outers += 1
        x_try, rn_dev, b_try = step(x, x_inner, r_scale)
        rn = float(full_value(rn_dev))
        while not math.isfinite(rn):
            tol_now = float(inner_cfg.tolerance)
            if tol_now >= 1e-2:
                rn = None                  # give up: keep the last good x
                break
            inner_cfg = dataclasses.replace(
                inner_cfg, tolerance=min(1e-2, tol_now * 100.0))
            x_try, rn_dev, b_try = step(x, inner(inner_cfg), r_scale)
            rn = float(full_value(rn_dev))
        if rn is None or rn > prev_rn:
            break
        x, b_next, r_scale = x_try, b_try, rn_dev
        outer_norms.append(rn)
        converged = rn <= stopping
        if not converged and rn > 0.5 * prev_rn:
            break
        prev_rn = rn
    if isinstance(x, np.ndarray):
        x = laid_out_like_b(setup, torch.from_numpy(x).to(setup.b.device))
    elif x.is_cuda:
        torch.cuda.synchronize(x.device)
    dt = time.perf_counter() - t0
    n_hist = len(outer_norms)
    return SolveResult(
        x_star=x, iter_count=total_iters, converged=converged,
        stopping_criteria=stopping,
        residual_norms=np.asarray(outer_norms),
        time_per_iteration=np.full(n_hist, dt / max(1, n_hist)),
        final_residual_norm=outer_norms[-1],
        gmres_restart_count=restarts, method=cfg.method,
        preconditioner=cfg.preconditioner,
        restart_length=cfg.restart_length, res_check_len=cfg.res_check_len,
        solve_seconds=dt, uniform_iteration_times=True,
        refine_outer_count=outers)


def _solve_host(setup: SolverSetup, method, timers: Timers,
                progress=None) -> SolveResult:
    """Host-driven loop with the semantics of solver_harness.hpp:15-51: one
    host read of the sampled norm per sample, per-iteration wall times.
    With config.kernel_timers the loop's instrumented call sites charge
    their synchronized wall times to `timers` (utils/ktimers.py)."""
    config = setup.config
    state = method.init_state()
    r0_norm = float(full_value(method.initial_residual_norm(state)))
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
    if config.kernel_timers:
        from ..utils import ktimers
        ktimers.activate(timers)
    t_solve0 = time.perf_counter()
    try:
        while True:
            t0 = time.perf_counter()
            state = method.iterate(state)
            iter_count += 1
            if debug_check is not None:
                debug_check(state, iter_count)
            if iter_count % config.res_check_len == 0:
                residual_norm = float(full_value(method.sample_norm(state)))
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
    finally:
        # an exception mid-solve (a debug check) must not leave the
        # registry active for later solves
        if config.kernel_timers:
            ktimers.activate(None)
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
