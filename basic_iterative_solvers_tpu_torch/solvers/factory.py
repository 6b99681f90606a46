"""Method factory (the reference's solver factory, main.cpp:22-44)."""
from __future__ import annotations

from ..types import SolverType
from .base import SolverSetup
from .cg import ConjugateGradientMethod

#: ROADMAP Queue 1 slice that ports each method
_SLICE = {
    SolverType.JACOBI: "slice 2 (the other unpreconditioned rows)",
    SolverType.BICGSTAB: "slice 2 (the other unpreconditioned rows)",
    SolverType.GMRES: "slice 2 (the other unpreconditioned rows)",
    SolverType.GAUSS_SEIDEL: "slice 3 (the GS family on stencils)",
    SolverType.SYMMETRIC_GAUSS_SEIDEL: "slice 3 (the GS family on stencils)",
}


def make_method(setup: SolverSetup):
    cfg = setup.config
    if cfg.method != SolverType.CONJUGATE_GRADIENT:
        raise NotImplementedError(
            f"solver {cfg.method.value!r} is not ported yet: it arrives with "
            f"ROADMAP Queue 1 {_SLICE[cfg.method]}")
    if cfg.cg_flavor == "pipelined":
        raise NotImplementedError(
            "pipelined CG arrives with ROADMAP Queue 1 slice 6")
    if cfg.cg_flavor != "classic":
        raise ValueError(f"unknown cg_flavor: {cfg.cg_flavor!r} "
                         "(expected 'classic' or 'pipelined')")
    return ConjugateGradientMethod(setup)
