"""Enums and public type vocabulary, with the JAX package's values
(basic_iterative_solvers_tpu/types.py) so both packages name methods and
preconditioners alike."""
from __future__ import annotations

import enum


class SolverType(enum.Enum):
    JACOBI = "jacobi"
    GAUSS_SEIDEL = "gauss-seidel"
    SYMMETRIC_GAUSS_SEIDEL = "symmetric-gauss-seidel"
    GMRES = "gmres"
    CONJUGATE_GRADIENT = "conjugate-gradient"
    BICGSTAB = "bicgstab"


class PrecondType(enum.Enum):
    NONE = "none"
    JACOBI = "jacobi"
    GAUSS_SEIDEL = "gauss-seidel"
    BACKWARDS_GAUSS_SEIDEL = "backwards-gauss-seidel"
    SYMMETRIC_GAUSS_SEIDEL = "symmetric-gauss-seidel"
    TWO_STAGE_GS = "two-stage gauss-seidel"
    SYMMETRIC_TWO_STAGE_GS = "symmetric two-stage gauss-seidel"
    ILU0 = "incomplete LU(0)"
    CHEBYSHEV = "chebyshev polynomial"
    MULTIGRID = "geometric multigrid"


#: CLI flag → solver type (the reference's parse_cli,
#: utilities/utilities.hpp:30-51).
SOLVER_CLI_FLAGS = {
    "-j": SolverType.JACOBI,
    "-gs": SolverType.GAUSS_SEIDEL,
    "-sgs": SolverType.SYMMETRIC_GAUSS_SEIDEL,
    "-cg": SolverType.CONJUGATE_GRADIENT,
    "-gm": SolverType.GMRES,
    "-bi": SolverType.BICGSTAB,
}

#: '-p' argument → preconditioner type (the reference's parse_cli,
#: utilities/utilities.hpp:66-95).
PRECOND_CLI_NAMES = {
    "j": PrecondType.JACOBI,
    "gs": PrecondType.GAUSS_SEIDEL,
    "bgs": PrecondType.BACKWARDS_GAUSS_SEIDEL,
    "sgs": PrecondType.SYMMETRIC_GAUSS_SEIDEL,
    "2st": PrecondType.TWO_STAGE_GS,
    "s2st": PrecondType.SYMMETRIC_TWO_STAGE_GS,
    "ilu0": PrecondType.ILU0,
    "cheby": PrecondType.CHEBYSHEV,
    "mg": PrecondType.MULTIGRID,
    "none": PrecondType.NONE,
}
