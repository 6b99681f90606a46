"""Preconditioner engine: z ← M⁻¹ y (the reference's apply_preconditioner,
kernels.hpp:336-414).  This slice runs unpreconditioned CG, so only
`PrecondType.NONE` is set up; every other type names the ROADMAP slice
(Queue 1) that ports it."""
from __future__ import annotations

import dataclasses

import torch

from .config import SolverConfig
from .types import PrecondType

#: ROADMAP Queue 1 slice that ports each preconditioner
_SLICE = {
    PrecondType.JACOBI: "slice 2 (the other unpreconditioned rows)",
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


def setup_preconditioner(A, config: SolverConfig) -> Preconditioner:
    """Build M for `config.preconditioner` on the device operator A."""
    ptype = config.preconditioner
    if ptype != PrecondType.NONE:
        raise NotImplementedError(
            f"preconditioner {ptype.value!r} is not ported yet: it arrives "
            f"with ROADMAP Queue 1 {_SLICE[ptype]}")
    return Preconditioner(ptype=ptype)


def apply_preconditioner(M: Preconditioner, y: torch.Tensor) -> torch.Tensor:
    if M.ptype != PrecondType.NONE:
        raise NotImplementedError(f"preconditioner {M.ptype.value!r}")
    return y
