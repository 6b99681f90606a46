"""Preconditioner engine: z ← M⁻¹ y (the reference's apply_preconditioner,
kernels.hpp:336-414), with the JAX package's two set-up paths:
`setup_preconditioner` on host CSR (precond.py:102-399) and
`setup_preconditioner_dia` on a device operator, stencil or DIA
(precond.py:455-598).

Type → action:
  none   : z = y
  jacobi : z = y / D
  gs     : z = (L + D)⁻¹ y                 [exact]
  bgs    : z = (U + D)⁻¹ y
  sgs    : z = (U + D)⁻¹ D (L + D)⁻¹ y
  2st    : Richardson approximation of (L + D)⁻¹ (kernels.hpp:312-333)
  s2st   : Richardson (L), multiply by D, Richardson (U)
  ilu0   : z = U⁻¹ L⁻¹ y (unit-diagonal L)

The exact solves (gs, bgs, sgs, ilu0) run in one of three forms:
* natural order (`gs_mode` "levels", the host path's default): the
  level-scheduled scans of ops/trisolve.py, the reference's ordering;
* coloured, blocked: the superblock solves (on stencils, or built from
  host CSR under a grid colouring) or the rank-space solves of host CSR
  under a mod colouring, or a grid one the superblock form refuses
  (ops/block_trisolve.py);
* coloured, masked sweeps (coloring.py): any operator and colouring.
Chebyshev and multigrid raise NotImplementedError naming ROADMAP Queue 1
slice 6.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from .config import SolverConfig
from .matrix import MatrixCSR
from .stencil_op import DeviceStencil, stencil_diag_vec, stencil_split
from .types import PrecondType

#: ROADMAP Queue 1 slice that ports each preconditioner still missing
_SLICE = {
    PrecondType.CHEBYSHEV: "slice 6 (precision and the extra preconditioners)",
    PrecondType.MULTIGRID: "slice 6 (precision and the extra preconditioners)",
}

#: preconditioner types a multicolour ordering serves (exact sweeps in the
#: colour-sorted ordering; coloring.py)
COLORED_PRECONDS = (PrecondType.GAUSS_SEIDEL,
                    PrecondType.BACKWARDS_GAUSS_SEIDEL,
                    PrecondType.SYMMETRIC_GAUSS_SEIDEL)

#: types whose set-up needs no triangular solve at all
DEVICE_NATIVE_PRECONDS = (PrecondType.NONE, PrecondType.JACOBI,
                          PrecondType.TWO_STAGE_GS,
                          PrecondType.SYMMETRIC_TWO_STAGE_GS,
                          PrecondType.CHEBYSHEV, PrecondType.MULTIGRID)


def resolve_gs_mode(config: SolverConfig, device_native: bool) -> str:
    """"auto" → "levels" on the host-CSR path (reference-order parity),
    "colored" on the device-native path."""
    if config.gs_mode != "auto":
        return config.gs_mode
    return "colored" if device_native else "levels"


@dataclasses.dataclass
class Preconditioner:
    ptype: PrecondType
    #: the whole action is composed this many times (at least once)
    outer_iters: int = 1
    #: Richardson sweeps of the two-stage types
    inner_iters: int = 0
    A_D: Optional[torch.Tensor] = None         # diagonal, vector dtype
    A_D_inv: Optional[torch.Tensor] = None
    #: natural-order level-scheduled solves (ops/trisolve.TriSolveLevels)
    L_solve: Any = None
    U_solve: Any = None
    L_strict_dev: Any = None                   # strict parts (2st, s2st,
    U_strict_dev: Any = None                   # masked coloured ILU(0))
    #: masked colour sweeps: the full operator and its colouring
    A_full_dev: Any = None
    color_spec: Any = None
    color_arr: Optional[torch.Tensor] = None   # greedy colour ids
    n_colors: int = 0
    #: blocked coloured solves (ops/block_trisolve): SuperBlockTriSolve
    #: (const, factor-table or plane mode) or BlockedTriSolve (rank space)
    L_block: Any = None
    U_block: Any = None


def _check_unported(pt: PrecondType):
    if pt in _SLICE:
        raise NotImplementedError(
            f"preconditioner {pt.value!r} is not ported yet: it arrives "
            f"with ROADMAP Queue 1 {_SLICE[pt]}")


def _diagonal(A, dtype) -> torch.Tensor:
    # the diagonal takes part in vector arithmetic: keep it at the vector
    # dtype whatever the operator's storage dtype
    from .dia import dia_diag
    D = (stencil_diag_vec(A) if isinstance(A, DeviceStencil)
         else dia_diag(A)).to(dtype)
    if bool((D == 0).any()):
        raise ValueError("zero on the matrix diagonal")
    return D


# ---------------------------------------------------------------------------
# Device-native set-up (stencil or DIA)
# ---------------------------------------------------------------------------

def setup_preconditioner_dia(A, config: SolverConfig) -> Preconditioner:
    """Build M for `config.preconditioner` on a device operator (DeviceStencil
    or DeviceDIA): diagonals and strict parts are structural, exact GS
    solves run coloured (the superblock solves where the stencil allows,
    else masked sweeps), exact ILU(0) needs a constant-coefficient stencil
    under a grid colouring."""
    from .device_matrix import DeviceDIA
    pt = config.preconditioner
    kw = dict(ptype=pt, outer_iters=config.precond_outer_iters,
              inner_iters=config.precond_inner_iters)
    if pt == PrecondType.NONE:
        return Preconditioner(**kw)
    _check_unported(pt)
    if not isinstance(A, (DeviceStencil, DeviceDIA)):
        raise TypeError(f"unsupported operator type {type(A).__name__}")
    dtype = config.spec_dtype()
    if pt == PrecondType.ILU0:
        return Preconditioner(**kw, **_ilu0_blocks(A, config, dtype))
    if pt not in DEVICE_NATIVE_PRECONDS and not (
            pt in COLORED_PRECONDS
            and resolve_gs_mode(config, device_native=True) == "colored"):
        raise ValueError(
            f"preconditioner {pt} needs exact triangular solves in the "
            "natural ordering (gs_mode='levels'); build through the host "
            "CSR path (preprocessing) instead")
    if pt in COLORED_PRECONDS:
        from .coloring import spec_for_device
        from .ops.block_trisolve import (BlockIneligibleError,
                                         build_superblock_gs_pair_stencil)
        spec = spec_for_device(A)
        D = _diagonal(A, dtype)
        M = Preconditioner(A_D=D, A_D_inv=(1.0 / D).to(dtype),
                           color_spec=spec, n_colors=spec.n_colors, **kw)
        if isinstance(A, DeviceStencil) and spec.kind == "grid":
            try:
                L_blk, U_blk = build_superblock_gs_pair_stencil(
                    A, spec, dtype=dtype,
                    need_d=pt == PrecondType.SYMMETRIC_GAUSS_SEIDEL)
                M.L_block = None if pt == PrecondType.BACKWARDS_GAUSS_SEIDEL \
                    else L_blk
                M.U_block = None if pt == PrecondType.GAUSS_SEIDEL else U_blk
                return M
            except BlockIneligibleError:
                pass        # masked sweeps below
        M.A_full_dev = A
        return M
    if pt == PrecondType.JACOBI:
        D = _diagonal(A, dtype)
        return Preconditioner(A_D=D, A_D_inv=(1.0 / D).to(dtype), **kw)
    if isinstance(A, DeviceStencil):
        L_strict, U_strict, A_D, A_D_inv = stencil_split(A)
    else:
        from .dia import dia_split
        L_strict, U_strict, A_D, A_D_inv = dia_split(A)
    if A_D.dtype != dtype:
        A_D = A_D.to(dtype)
        A_D_inv = (1.0 / A_D).to(dtype)
    if pt == PrecondType.TWO_STAGE_GS:
        return Preconditioner(A_D=A_D, A_D_inv=A_D_inv,
                              L_strict_dev=L_strict, **kw)
    return Preconditioner(A_D=A_D, A_D_inv=A_D_inv,  # SYMMETRIC_TWO_STAGE_GS
                          L_strict_dev=L_strict, U_strict_dev=U_strict, **kw)


def ilu0_device_eligible(A, config: SolverConfig) -> bool:
    """Does exact ILU(0) run on the device path for A: a constant-
    coefficient stencil under a grid colouring, gs_mode "auto" or
    "colored"?"""
    from .coloring import spec_for_device
    from .ops.block_trisolve import stencil_ilu0_eligible
    return (isinstance(A, DeviceStencil)
            and resolve_gs_mode(config, device_native=True) == "colored"
            and stencil_ilu0_eligible(A, spec_for_device(A)))


def _ilu0_blocks(A, config: SolverConfig, dtype) -> dict:
    """The factor-table (L, U) pair of exact coloured ILU(0) (the JAX
    package's setup_preconditioner_dia, precond.py:475-507)."""
    from .coloring import spec_for_device
    from .ops.block_trisolve import build_superblock_ilu0_pair_stencil
    if not ilu0_device_eligible(A, config):
        raise ValueError(
            f"preconditioner {PrecondType.ILU0} on the device-native path "
            "needs a constant-coefficient stencil under a grid colouring; "
            "use the host CSR path (preprocessing) otherwise")
    spec = spec_for_device(A)
    L, U = build_superblock_ilu0_pair_stencil(
        A, spec, dtype=dtype, pivot_tolerance=config.ilu0_pivot_tolerance,
        pivot_replacement=config.ilu0_pivot_replacement)
    return dict(L_block=L, U_block=U, color_spec=spec,
                n_colors=spec.n_colors)


# ---------------------------------------------------------------------------
# Host-CSR set-up
# ---------------------------------------------------------------------------

def _colors_for_setup(A: MatrixCSR, config: SolverConfig):
    """(colours, spec): the spec's structural colouring when the config
    carries a grid or mod spec and no reordering was applied (the blocked
    solves), else greedy colours and None (masked sweeps)."""
    from .coloring import greedy_coloring, spec_colors_np
    spec = config.color_spec
    if (spec is not None and config.perm_mode == "none"
            and spec.kind in ("grid", "mod")):
        try:
            return spec_colors_np(spec, A.n_rows), spec
        except ValueError:
            pass
    return greedy_coloring(A), None


def _masked_ilu0(A: MatrixCSR, colors, rows_o, cols_o, lu_vals, U_D, kw,
                 config, dtype, device) -> Preconditioner:
    """Coloured ILU(0) as masked sweeps: the colour-strict factors as
    device matrices, U's diagonal as A_D."""
    from .device_matrix import from_csr
    from .matrix import MatrixCOO, convert_coo_to_csr
    ci, cj = colors[rows_o], colors[cols_o]

    def dev(mask):
        return from_csr(convert_coo_to_csr(MatrixCOO.from_arrays(
            rows_o[mask], cols_o[mask], lu_vals[mask], n_rows=A.n_rows,
            n_cols=A.n_cols)), config.mat_dtype(), config.matrix_format,
            config.dia_max_diags, config.dia_min_fill, device=device)

    return Preconditioner(
        A_D=torch.from_numpy(U_D).to(dtype=dtype, device=device),
        A_D_inv=torch.from_numpy(1.0 / U_D).to(dtype=dtype, device=device),
        L_strict_dev=dev(cj < ci), U_strict_dev=dev(cj > ci),
        color_arr=torch.from_numpy(colors).to(device),
        n_colors=int(colors.max()) + 1, **kw)


def _colored_ilu0(A: MatrixCSR, config: SolverConfig, kw, dtype, device,
                  A_dev) -> Preconditioner:
    """Exact coloured ILU(0) on host CSR (precond.py:145-267, its NumPy
    branch), factored in the colour-sorted ordering.  Under a grid
    colouring the translation-table pair where A_dev is a stencil; then the
    triplet pipeline (superblock, or rank-space as a pair, under a grid or
    mod colouring); an improper colouring recolours greedily, and greedy
    colours take masked sweeps."""
    from .factor import factor_ilu0_colored_triplets
    from .ops.block_trisolve import (BlockIneligibleError,
                                     ImproperColoringError,
                                     build_best_trisolve_pair,
                                     build_superblock_ilu0_pair_stencil)
    tol, repl = config.ilu0_pivot_tolerance, config.ilu0_pivot_replacement
    colors, spec = _colors_for_setup(A, config)
    done = lambda L, U: Preconditioner(  # noqa: E731
        L_block=L, U_block=U, color_spec=spec, n_colors=spec.n_colors, **kw)
    if spec is not None and spec.kind == "grid" and isinstance(
            A_dev, DeviceStencil):
        try:
            return done(*build_superblock_ilu0_pair_stencil(
                A_dev, spec, dtype=dtype, pivot_tolerance=tol,
                pivot_replacement=repl))
        except BlockIneligibleError:
            pass
    factor = lambda c: factor_ilu0_colored_triplets(  # noqa: E731
        A, c, pivot_tolerance=tol, pivot_replacement=repl)
    rows_o, cols_o, lu_vals, U_D = factor(colors)
    if spec is not None:
        try:
            return done(*build_best_trisolve_pair(
                (rows_o, cols_o, lu_vals, A.n_rows), None, U_D, colors, spec,
                dtype=dtype, device=device))
        except ImproperColoringError:
            from .coloring import greedy_coloring
            colors = greedy_coloring(A)
            rows_o, cols_o, lu_vals, U_D = factor(colors)
        except BlockIneligibleError:
            pass
    return _masked_ilu0(A, colors, rows_o, cols_o, lu_vals, U_D, kw, config,
                        dtype, device)


def _colored_gs(A: MatrixCSR, config: SolverConfig, factors, kw, dtype,
                device, A_dev) -> Preconditioner:
    """The coloured GS family on host CSR (precond.py:268-337, its NumPy
    branch): the best layout (superblock, or rank-space, under a grid or
    mod colouring) of the triangles it needs, one layout for SGS's pair;
    masked sweeps with the full device operator under greedy colours."""
    from .factor import peel_diag
    from .ops.block_trisolve import (BlockIneligibleError,
                                     ImproperColoringError,
                                     build_best_trisolve,
                                     build_best_trisolve_pair)
    pt = config.preconditioner
    A_D_np, A_D_inv_np = ((factors.A_D, factors.A_D_inv)
                          if factors is not None else peel_diag(A))
    to_dev = lambda a: torch.from_numpy(a).to(  # noqa: E731
        dtype=dtype, device=device)
    A_D, A_D_inv = to_dev(A_D_np), to_dev(A_D_inv_np)
    colors, spec = _colors_for_setup(A, config)
    if spec is not None:
        try:
            L = U = None
            if pt == PrecondType.SYMMETRIC_GAUSS_SEIDEL:
                L, U = build_best_trisolve_pair(
                    A, A_D_np, A_D_np, colors, spec, dtype=dtype,
                    need_d=True, device=device)
            else:
                B = build_best_trisolve(
                    A, A_D_np, colors, spec,
                    upper=pt == PrecondType.BACKWARDS_GAUSS_SEIDEL,
                    dtype=dtype, device=device)
                if pt == PrecondType.GAUSS_SEIDEL:
                    L = B
                else:
                    U = B
            return Preconditioner(A_D=A_D, A_D_inv=A_D_inv, L_block=L,
                                  U_block=U, color_spec=spec,
                                  n_colors=spec.n_colors, **kw)
        except ImproperColoringError:
            from .coloring import greedy_coloring
            colors = greedy_coloring(A)
        except BlockIneligibleError:
            pass
    if A_dev is None:
        from .device_matrix import from_csr
        A_dev = from_csr(A, config.mat_dtype(), config.matrix_format,
                         config.dia_max_diags, config.dia_min_fill,
                         device=device)
    return Preconditioner(A_D=A_D, A_D_inv=A_D_inv, A_full_dev=A_dev,
                          color_arr=torch.from_numpy(colors).to(device),
                          n_colors=int(colors.max()) + 1, **kw)


def setup_preconditioner(A, config: SolverConfig, factors=None, A_dev=None,
                         *, device="cuda") -> Preconditioner:
    """Build M for `config.preconditioner`.  A host `MatrixCSR` takes the
    host path (the JAX package's setup_preconditioner): `factors` may be
    shared with the solver set-up, `A_dev` is the device operator of the
    same matrix (reused by the masked sweeps), and everything lands on
    `device`.  A device operator takes setup_preconditioner_dia."""
    if not isinstance(A, MatrixCSR):
        return setup_preconditioner_dia(A, config)
    from .device_matrix import from_csr
    from .factor import factor_LU
    from .ops.trisolve import build_trisolve
    from .stencil_op import resolve_device
    device = resolve_device(device)
    pt = config.preconditioner
    dtype = config.spec_dtype()
    kw = dict(ptype=pt, outer_iters=config.precond_outer_iters,
              inner_iters=config.precond_inner_iters)
    if pt == PrecondType.NONE:
        return Preconditioner(**kw)
    _check_unported(pt)
    colored = resolve_gs_mode(config, device_native=False) == "colored"
    if pt == PrecondType.ILU0 and colored:
        return _colored_ilu0(A, config, kw, dtype, device, A_dev)
    if pt in COLORED_PRECONDS and colored:
        return _colored_gs(A, config, factors, kw, dtype, device, A_dev)
    if factors is None:
        factors = factor_LU(A, ilu0=(pt == PrecondType.ILU0),
                            pivot_tolerance=config.ilu0_pivot_tolerance,
                            pivot_replacement=config.ilu0_pivot_replacement)
    to_dev = lambda a: torch.from_numpy(a).to(  # noqa: E731
        dtype=dtype, device=device)
    M = Preconditioner(A_D=to_dev(factors.A_D),
                       A_D_inv=to_dev(factors.A_D_inv), **kw)
    levels = lambda T, D, upper: build_trisolve(  # noqa: E731
        T, D, upper=upper, dtype=dtype, device=device)
    strict = lambda T: from_csr(  # noqa: E731
        T, config.mat_dtype(), config.matrix_format, config.dia_max_diags,
        config.dia_min_fill, device=device)
    if pt in (PrecondType.GAUSS_SEIDEL, PrecondType.SYMMETRIC_GAUSS_SEIDEL):
        M.L_solve = levels(factors.L_strict, factors.A_D, False)
    if pt in (PrecondType.BACKWARDS_GAUSS_SEIDEL,
              PrecondType.SYMMETRIC_GAUSS_SEIDEL):
        M.U_solve = levels(factors.U_strict, factors.A_D, True)
    if pt in (PrecondType.TWO_STAGE_GS, PrecondType.SYMMETRIC_TWO_STAGE_GS):
        M.L_strict_dev = strict(factors.L_strict)
    if pt == PrecondType.SYMMETRIC_TWO_STAGE_GS:
        M.U_strict_dev = strict(factors.U_strict)
    if pt == PrecondType.ILU0:
        M.L_solve = levels(factors.L_strict, factors.L_D, False)
        M.U_solve = levels(factors.U_strict, factors.U_D, True)
    return M


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------

def _colored_solve(M: Preconditioner, y: torch.Tensor,
                   reverse: bool) -> torch.Tensor:
    """(L_c+D)⁻¹y or (U_c+D)⁻¹y as a multicolour sweep from zero."""
    from .coloring import colored_sweep
    return colored_sweep(M.A_full_dev, M.A_D_inv, y, None, M.color_spec,
                         M.n_colors, reverse=reverse, color_arr=M.color_arr)


def _apply_once(M: Preconditioner, y: torch.Tensor) -> torch.Tensor:
    from .ops.trisolve import trisolve, two_stage_solve
    pt = M.ptype
    if pt == PrecondType.NONE:
        return y
    if pt == PrecondType.JACOBI:
        # reference: elemwise_div_vectors(output, input, A_D), kernels.hpp:357
        return y / M.A_D
    if M.L_block is not None or M.U_block is not None:
        from .ops.block_trisolve import (blocked_ilu0, blocked_sgs,
                                         blocked_trisolve)
        if pt == PrecondType.ILU0:
            return blocked_ilu0(M.L_block, M.U_block, y)
        if pt == PrecondType.GAUSS_SEIDEL:
            return blocked_trisolve(M.L_block, y)
        if pt == PrecondType.BACKWARDS_GAUSS_SEIDEL:
            return blocked_trisolve(M.U_block, y)
        return blocked_sgs(M.L_block, M.U_block, y)
    colored = M.n_colors > 0
    if pt == PrecondType.GAUSS_SEIDEL:
        return (_colored_solve(M, y, reverse=False) if colored
                else trisolve(M.L_solve, y))
    if pt == PrecondType.BACKWARDS_GAUSS_SEIDEL:
        return (_colored_solve(M, y, reverse=True) if colored
                else trisolve(M.U_solve, y))
    if pt == PrecondType.SYMMETRIC_GAUSS_SEIDEL:
        if colored:
            tmp = _colored_solve(M, y, reverse=False)   # (L_c+D)⁻¹ y
            return _colored_solve(M, tmp * M.A_D, reverse=True)
        tmp = trisolve(M.L_solve, y)                    # (L+D)⁻¹ y
        return trisolve(M.U_solve, tmp * M.A_D)         # (U+D)⁻¹ D …
    if pt == PrecondType.TWO_STAGE_GS:
        return two_stage_solve(M.L_strict_dev, M.A_D_inv, y, M.inner_iters)
    if pt == PrecondType.SYMMETRIC_TWO_STAGE_GS:
        out = two_stage_solve(M.L_strict_dev, M.A_D_inv, y, M.inner_iters)
        out = out * M.A_D
        return two_stage_solve(M.U_strict_dev, M.A_D_inv, out,
                               M.inner_iters)
    if pt == PrecondType.ILU0:
        if colored:
            # forward: unit-diagonal L over ascending colours; backward: U
            # over descending colours with U's diagonal
            from .coloring import colored_sweep
            tmp = colored_sweep(M.L_strict_dev, 1.0, y, None, None,
                                M.n_colors, color_arr=M.color_arr)
            return colored_sweep(M.U_strict_dev, M.A_D_inv, tmp, None, None,
                                 M.n_colors, reverse=True,
                                 color_arr=M.color_arr)
        return trisolve(M.U_solve, trisolve(M.L_solve, y))
    raise ValueError(f"unsupported preconditioner: {pt}")


def apply_preconditioner(M: Preconditioner, y: torch.Tensor) -> torch.Tensor:
    """z ← M⁻¹ y, applied `outer_iters` times (kernels.hpp:355-404)."""
    out = y
    for _ in range(max(1, M.outer_iters)):
        out = _apply_once(M, out)
    return out
