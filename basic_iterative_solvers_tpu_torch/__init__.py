"""basic_iterative_solvers_tpu_torch — the PyTorch/CUDA port of
basic_iterative_solvers_tpu, for NVIDIA Hopper.

It runs CG, Jacobi, Gauss-Seidel, symmetric Gauss-Seidel, BiCGSTAB and
GMRES(m), unpreconditioned or with the Jacobi, GS, backward GS, symmetric
GS, (symmetric) two-stage GS and exact ILU(0) preconditioners, on the
matrix-free stencil operators (HPCG 27-point, FDM, Anderson): operator
build, setup, the host and fused harnesses (with GMRES's restart cycles),
and hand-written CUDA kernels: the stencil SpMV and the multicolour GS step
(csrc/stencil_spmv.cu), the two basis passes of fused-mode GMRES
(csrc/gmres_basis.cu) and the superblock levels of the coloured triangular
solves, const mode for GS and factor-table mode for ILU(0), fused or split
(csrc/block_trisolve.cu).  Operators and vectors live on the card unless
the caller asks for the CPU (`device="cpu"`), where the kernels' plain
PyTorch versions run.  The package imports torch and numpy only.

    import torch
    import basic_iterative_solvers_tpu_torch as bis
    A = bis.stencil_op.from_source_operator("hpcg:128x128x128",
                                            torch.float32)
    cfg = bis.SolverConfig(dtype=torch.float32, harness="fused",
                           tolerance=1e-6)
    res = bis.solve(bis.preprocessing_device(A, cfg))
    res = bis.solve_system("hpcg:128x128x128", "cg", "ilu0", tolerance=1e-6)
    res = bis.solve_system(A, "gm", restart_length=50, orthog_mode="fused",
                           gmres_basis_dtype="bfloat16", tolerance=1e-5)
"""
import torch

from . import coloring, convert, stencil_op  # noqa: F401
from .config import SolverConfig
from .precond import ilu0_device_eligible
from .solvers import SolverSetup, SolveResult, preprocessing_device, solve
from .stencil_op import DeviceStencil
from .types import PRECOND_CLI_NAMES, SOLVER_CLI_FLAGS, PrecondType, SolverType

__version__ = "0.1.0"

__all__ = ["SolverConfig", "SolverType", "PrecondType", "SolverSetup",
           "SolveResult", "DeviceStencil", "stencil_op", "convert",
           "preprocessing_device", "solve", "solve_system"]


def solve_system(matrix_source, method="cg", preconditioner=None, b=None,
                 x0=None, *, device="cuda", **config_kwargs) -> SolveResult:
    """One-call API: build the operator for a stencil generator spec
    ("hpcg:64x64x64", "fdm:16", "anderson:Lx=8,...",
    "scamac:Anderson,...") on `device` or take a DeviceStencil that lies
    there, set up, and solve.  The card is the default; with no card, ask
    for device="cpu".

    `method` and `preconditioner` take the CLI short names ("cg", "j",
    "gs", "sgs", "bi", "gm"; "none", "j", "gs", "bgs", "sgs", "2st",
    "s2st", "ilu0") or the enums.  Other keyword arguments go to
    SolverConfig; the dtype defaults to float32 on a card and float64 on
    the CPU, the harness to "fused" on a card and "host" on the CPU."""
    if isinstance(method, str):
        method = (SOLVER_CLI_FLAGS.get("-" + method.lstrip("-"))
                  or SolverType(method))
    if preconditioner is None:
        preconditioner = PrecondType.NONE
    elif isinstance(preconditioner, str):
        preconditioner = (PRECOND_CLI_NAMES.get(preconditioner)
                          or PrecondType(preconditioner))
    device = stencil_op.resolve_device(device)
    on_card = device.type == "cuda"
    config_kwargs.setdefault("dtype",
                             torch.float32 if on_card else torch.float64)
    config_kwargs.setdefault("harness", "fused" if on_card else "host")
    config = SolverConfig(method=method, preconditioner=preconditioner,
                          **config_kwargs)
    A = matrix_source
    if isinstance(A, str):
        A = stencil_op.from_source_operator(A, dtype=config.mat_dtype(),
                                            device=device)
    if not isinstance(A, DeviceStencil):
        raise TypeError(
            f"unsupported matrix source {type(matrix_source).__name__}: this "
            "slice solves stencil generator specs and DeviceStencil "
            "operators; .mtx files and CSR matrices arrive with ROADMAP "
            "Queue 1 slice 5")
    if A.device.type != device.type:
        raise ValueError(f"the operator lies on {A.device}, the call asks "
                         f"for {device}")
    if (preconditioner == PrecondType.ILU0
            and not ilu0_device_eligible(A, config)):
        raise NotImplementedError(
            "ILU(0) on this operator needs the host-CSR route (exact "
            "triangular solves in a general colouring), which arrives with "
            "ROADMAP Queue 1 slice 5")
    return solve(preprocessing_device(A, config, b=b, x0=x0))
