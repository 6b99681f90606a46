"""Preconditioner engine: z ← M⁻¹ y (the reference's apply_preconditioner,
kernels.hpp:336-414), the JAX package's setup_preconditioner_dia and
_apply_once on the matrix-free stencils.

Type → action:
  none   : z = y
  jacobi : z = y / D
  gs     : z = (L_c + D)⁻¹ y          [exact, colour-sorted ordering]
  bgs    : z = (U_c + D)⁻¹ y
  sgs    : z = (U_c + D)⁻¹ D (L_c + D)⁻¹ y
  2st    : Richardson approximation of (L + D)⁻¹ (kernels.hpp:312-333)
  s2st   : Richardson (L), multiply by D, Richardson (U)
  ilu0   : z = U⁻¹ L⁻¹ y, the coloured ILU(0) factors (unit-diagonal L)

gs/bgs/sgs take the const-mode superblock solves (ops/block_trisolve.py)
where the operator and its grid colouring allow, else the masked colour
sweeps (coloring.py); both are the exact solves of the same colour-sorted
ordering.  ilu0 takes the factor-table superblock solves, which need a
constant-coefficient stencil under a grid colouring; elsewhere it needs
the host-CSR path of ROADMAP Queue 1 slice 5.  Chebyshev and multigrid
name the ROADMAP slice (Queue 1) that ports them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from .config import SolverConfig
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

#: types whose setup needs no triangular solve at all
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
    L_strict_dev: Any = None                   # strict splits (2st, s2st)
    U_strict_dev: Any = None
    #: masked colour sweeps: the full operator and its colouring
    A_full_dev: Any = None
    color_spec: Any = None
    n_colors: int = 0
    #: superblock solves (ops/block_trisolve.SuperBlockTriSolve): const mode
    #: for the GS family, factor-table mode for ILU(0)
    L_block: Any = None
    U_block: Any = None


def _diagonal(A: DeviceStencil, dtype) -> torch.Tensor:
    # the diagonal takes part in vector arithmetic: keep it at the vector
    # dtype whatever the operator's storage dtype
    D = stencil_diag_vec(A).to(dtype)
    if bool((D == 0).any()):
        raise ValueError("zero on the matrix diagonal")
    return D


def setup_preconditioner(A, config: SolverConfig) -> Preconditioner:
    """Build M for `config.preconditioner` on the device operator A (the
    JAX package's setup_preconditioner_dia, precond.py:455-598)."""
    pt = config.preconditioner
    kw = dict(ptype=pt, outer_iters=config.precond_outer_iters,
              inner_iters=config.precond_inner_iters)
    if pt == PrecondType.NONE:
        return Preconditioner(**kw)
    if pt in _SLICE:
        raise NotImplementedError(
            f"preconditioner {pt.value!r} is not ported yet: it arrives "
            f"with ROADMAP Queue 1 {_SLICE[pt]}")
    if not isinstance(A, DeviceStencil):
        raise TypeError(f"unsupported operator type {type(A).__name__}")
    dtype = config.spec_dtype()
    if pt == PrecondType.ILU0:
        return Preconditioner(**kw, **_ilu0_blocks(A, config, dtype))
    if pt not in DEVICE_NATIVE_PRECONDS and not (
            pt in COLORED_PRECONDS
            and resolve_gs_mode(config, device_native=True) == "colored"):
        raise ValueError(
            f"preconditioner {pt} needs exact triangular solves in the "
            "natural ordering (gs_mode='levels'): the host CSR path, which "
            "arrives with ROADMAP Queue 1 slice 5")
    if pt in COLORED_PRECONDS:
        from .coloring import spec_for_device
        from .ops.block_trisolve import (BlockIneligibleError,
                                         build_superblock_gs_pair_stencil)
        spec = spec_for_device(A)
        D = _diagonal(A, dtype)
        M = Preconditioner(A_D=D, A_D_inv=(1.0 / D).to(dtype),
                           color_spec=spec, n_colors=spec.n_colors, **kw)
        if spec.kind == "grid":
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
    L_strict, U_strict, A_D, A_D_inv = stencil_split(A)
    if A_D.dtype != dtype:
        A_D = A_D.to(dtype)
        A_D_inv = (1.0 / A_D).to(dtype)
    if pt == PrecondType.TWO_STAGE_GS:
        return Preconditioner(A_D=A_D, A_D_inv=A_D_inv,
                              L_strict_dev=L_strict, **kw)
    if pt == PrecondType.SYMMETRIC_TWO_STAGE_GS:
        return Preconditioner(A_D=A_D, A_D_inv=A_D_inv,
                              L_strict_dev=L_strict, U_strict_dev=U_strict,
                              **kw)
    raise ValueError(f"unsupported preconditioner: {pt}")


def ilu0_device_eligible(A, config: SolverConfig) -> bool:
    """Does exact ILU(0) run on the device path for A: a constant-
    coefficient stencil under a grid colouring, gs_mode "auto" or
    "colored"?"""
    from .coloring import spec_for_device
    from .ops.block_trisolve import stencil_ilu0_eligible
    return (isinstance(A, DeviceStencil)
            and resolve_gs_mode(config, device_native=True) == "colored"
            and stencil_ilu0_eligible(A, spec_for_device(A)))


def _ilu0_blocks(A: DeviceStencil, config: SolverConfig, dtype) -> dict:
    """The factor-table (L, U) pair of exact coloured ILU(0) (the JAX
    package's setup_preconditioner_dia, precond.py:475-507)."""
    from .coloring import spec_for_device
    from .ops.block_trisolve import build_superblock_ilu0_pair_stencil
    if not ilu0_device_eligible(A, config):
        raise ValueError(
            f"preconditioner {PrecondType.ILU0} requires the host CSR path "
            "(exact triangular solves), which arrives with ROADMAP Queue 1 "
            "slice 5: the device path's ILU(0) needs a constant-coefficient "
            "stencil under a grid colouring")
    spec = spec_for_device(A)
    L, U = build_superblock_ilu0_pair_stencil(
        A, spec, dtype=dtype, pivot_tolerance=config.ilu0_pivot_tolerance,
        pivot_replacement=config.ilu0_pivot_replacement)
    return dict(L_block=L, U_block=U, color_spec=spec,
                n_colors=spec.n_colors)


def _colored_solve(M: Preconditioner, y: torch.Tensor,
                   reverse: bool) -> torch.Tensor:
    """(L_c+D)⁻¹y or (U_c+D)⁻¹y as a multicolour sweep from zero."""
    from .coloring import colored_sweep
    return colored_sweep(M.A_full_dev, M.A_D_inv, y, None, M.color_spec,
                         M.n_colors, reverse=reverse)


def _apply_once(M: Preconditioner, y: torch.Tensor) -> torch.Tensor:
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
    if pt == PrecondType.GAUSS_SEIDEL:
        return _colored_solve(M, y, reverse=False)
    if pt == PrecondType.BACKWARDS_GAUSS_SEIDEL:
        return _colored_solve(M, y, reverse=True)
    if pt == PrecondType.SYMMETRIC_GAUSS_SEIDEL:
        tmp = _colored_solve(M, y, reverse=False)     # (L_c+D)⁻¹ y
        tmp = tmp * M.A_D                             # D (L_c+D)⁻¹ y
        return _colored_solve(M, tmp, reverse=True)   # (U_c+D)⁻¹ …
    from .ops.trisolve import two_stage_solve
    if pt == PrecondType.TWO_STAGE_GS:
        return two_stage_solve(M.L_strict_dev, M.A_D_inv, y, M.inner_iters)
    if pt == PrecondType.SYMMETRIC_TWO_STAGE_GS:
        out = two_stage_solve(M.L_strict_dev, M.A_D_inv, y, M.inner_iters)
        out = out * M.A_D
        return two_stage_solve(M.U_strict_dev, M.A_D_inv, out,
                               M.inner_iters)
    raise ValueError(f"unsupported preconditioner: {pt}")


def apply_preconditioner(M: Preconditioner, y: torch.Tensor) -> torch.Tensor:
    """z ← M⁻¹ y, applied `outer_iters` times (kernels.hpp:355-404)."""
    out = y
    for _ in range(max(1, M.outer_iters)):
        out = _apply_once(M, out)
    return out
