"""Preconditioner engine: z ← M⁻¹ y (the reference's apply_preconditioner,
kernels.hpp:336-414).  This slice sets up the identity (`PrecondType.NONE`)
and Jacobi (`PrecondType.JACOBI`, z = y / D); every other type names the
ROADMAP slice (Queue 1) that ports it."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .config import SolverConfig
from .stencil_op import DeviceStencil, stencil_diag_vec
from .types import PrecondType

#: ROADMAP Queue 1 slice that ports each preconditioner
_SLICE = {
    PrecondType.GAUSS_SEIDEL: "slice 3 (the GS family on stencils)",
    PrecondType.BACKWARDS_GAUSS_SEIDEL: "slice 3 (the GS family on stencils)",
    PrecondType.SYMMETRIC_GAUSS_SEIDEL: "slice 3 (the GS family on stencils)",
    PrecondType.TWO_STAGE_GS: "slice 3 (the GS family on stencils)",
    PrecondType.SYMMETRIC_TWO_STAGE_GS: "slice 3 (the GS family on stencils)",
    PrecondType.ILU0: "slice 4 (exact ILU(0))",
    PrecondType.CHEBYSHEV: "slice 6 (precision and the extra preconditioners)",
    PrecondType.MULTIGRID: "slice 6 (precision and the extra preconditioners)",
}


@dataclasses.dataclass
class Preconditioner:
    ptype: PrecondType
    #: the whole action is composed this many times (at least once)
    outer_iters: int = 1
    A_D: Optional[torch.Tensor] = None         # diagonal, vector dtype
    A_D_inv: Optional[torch.Tensor] = None


def setup_preconditioner(A, config: SolverConfig) -> Preconditioner:
    """Build M for `config.preconditioner` on the device operator A (the
    JAX package's setup_preconditioner_dia, precond.py:585-593)."""
    ptype = config.preconditioner
    kw = dict(ptype=ptype, outer_iters=config.precond_outer_iters)
    if ptype == PrecondType.NONE:
        return Preconditioner(**kw)
    if ptype != PrecondType.JACOBI:
        raise NotImplementedError(
            f"preconditioner {ptype.value!r} is not ported yet: it arrives "
            f"with ROADMAP Queue 1 {_SLICE[ptype]}")
    if not isinstance(A, DeviceStencil):
        raise TypeError(f"unsupported operator type {type(A).__name__}")
    # the diagonal takes part in vector arithmetic: keep it at the vector
    # dtype whatever the operator's storage dtype
    dtype = config.spec_dtype()
    A_D = stencil_diag_vec(A).to(dtype)
    if bool((A_D == 0).any()):
        raise ValueError("zero on the matrix diagonal")
    return Preconditioner(A_D=A_D, A_D_inv=(1.0 / A_D).to(dtype), **kw)


def _apply_once(M: Preconditioner, y: torch.Tensor) -> torch.Tensor:
    if M.ptype == PrecondType.NONE:
        return y
    if M.ptype == PrecondType.JACOBI:
        # reference: elemwise_div_vectors(output, input, A_D), kernels.hpp:357
        return y / M.A_D
    raise NotImplementedError(f"preconditioner {M.ptype.value!r}")


def apply_preconditioner(M: Preconditioner, y: torch.Tensor) -> torch.Tensor:
    """z ← M⁻¹ y, applied `outer_iters` times (kernels.hpp:355-404)."""
    out = y
    for _ in range(max(1, M.outer_iters)):
        out = _apply_once(M, out)
    return out
