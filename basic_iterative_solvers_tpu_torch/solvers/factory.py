"""Method factory (the reference's solver factory, main.cpp:22-44)."""
from __future__ import annotations

from ..types import SolverType
from .base import SolverSetup
from .bicgstab import BiCGSTABMethod
from .cg import ConjugateGradientMethod
from .gmres import GMRESMethod
from .jacobi import JacobiMethod

_METHODS = {
    SolverType.JACOBI: JacobiMethod,
    SolverType.BICGSTAB: BiCGSTABMethod,
    SolverType.GMRES: GMRESMethod,
}


def make_method(setup: SolverSetup):
    cfg = setup.config
    if cfg.method in _METHODS:
        return _METHODS[cfg.method](setup)
    if cfg.method != SolverType.CONJUGATE_GRADIENT:
        raise NotImplementedError(
            f"solver {cfg.method.value!r} is not ported yet: it arrives with "
            "ROADMAP Queue 1 slice 3 (the GS family on stencils)")
    if cfg.cg_flavor == "pipelined":
        raise NotImplementedError(
            "pipelined CG arrives with ROADMAP Queue 1 slice 6")
    if cfg.cg_flavor != "classic":
        raise ValueError(f"unknown cg_flavor: {cfg.cg_flavor!r} "
                         "(expected 'classic' or 'pipelined')")
    return ConjugateGradientMethod(setup)
