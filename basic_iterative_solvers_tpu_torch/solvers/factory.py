"""Method factory (the reference's solver factory, main.cpp:22-44)."""
from __future__ import annotations

from ..types import SolverType
from .base import SolverSetup
from .bicgstab import BiCGSTABMethod
from .cg import ConjugateGradientMethod
from .gauss_seidel import GaussSeidelMethod, SymmetricGaussSeidelMethod
from .gmres import GMRESMethod
from .jacobi import JacobiMethod

_METHODS = {
    SolverType.JACOBI: JacobiMethod,
    SolverType.BICGSTAB: BiCGSTABMethod,
    SolverType.GMRES: GMRESMethod,
    SolverType.GAUSS_SEIDEL: GaussSeidelMethod,
    SolverType.SYMMETRIC_GAUSS_SEIDEL: SymmetricGaussSeidelMethod,
}


def make_method(setup: SolverSetup):
    cfg = setup.config
    if cfg.method in _METHODS:
        return _METHODS[cfg.method](setup)
    if cfg.cg_flavor == "pipelined":
        raise NotImplementedError(
            "pipelined CG arrives with ROADMAP Queue 1 slice 6")
    if cfg.cg_flavor != "classic":
        raise ValueError(f"unknown cg_flavor: {cfg.cg_flavor!r} "
                         "(expected 'classic' or 'pipelined')")
    return ConjugateGradientMethod(setup)
