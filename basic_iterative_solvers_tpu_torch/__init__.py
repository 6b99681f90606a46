"""basic_iterative_solvers_tpu_torch — the PyTorch/CUDA port of
basic_iterative_solvers_tpu, for NVIDIA Hopper.

It runs CG, Jacobi, Gauss-Seidel, symmetric Gauss-Seidel, BiCGSTAB and
GMRES(m), unpreconditioned or with the Jacobi, GS, backward GS, symmetric
GS, (symmetric) two-stage GS and exact ILU(0) preconditioners, on three
routes, as the JAX package does:
* matrix-free stencils (HPCG 27-point, FDM, Anderson; stencil_op);
* DIA matrices built on the card from a generator spec (dia), the
  default device-native route of a spec;
* host CSR (generators.from_source, .mtx files, scipy or dense input)
  through `preprocessing`: DIA, lane-ELL or ELL on the card, natural-order
  level-scheduled or coloured exact triangular solves, RCM and colour
  reorderings, symmetric scaling.
Its hand-written CUDA kernels: the stencil SpMV and the multicolour GS step
(csrc/stencil_spmv.cu), the two basis passes of fused-mode GMRES
(csrc/gmres_basis.cu), the superblock levels of the coloured triangular
solves on stencils and the rank-space level of host-CSR factors
(csrc/block_trisolve.cu), and the DIA and lane-ELL SpMVs
(csrc/sparse_spmv.cu).  Operators and vectors live on the card unless the
caller asks for the CPU (`device="cpu"`), where the kernels' plain PyTorch
versions run.  The package imports torch and numpy only.

    import torch
    import basic_iterative_solvers_tpu_torch as bis
    A = bis.dia.from_source_device("hpcg:128x128x128", torch.float32)
    cfg = bis.SolverConfig(dtype=torch.float32, harness="fused",
                           tolerance=1e-6)
    res = bis.solve(bis.preprocessing_device(A, cfg))
    res = bis.solve_system("hpcg:128x128x128", "cg", "ilu0", tolerance=1e-6)
    res = bis.solve(bis.preprocessing(bis.generators.from_source(
        "sband:500000,8,400"), cfg))
"""
import torch

from . import coloring, convert, dia, generators, stencil_op  # noqa: F401
from .config import SolverConfig
from .device_matrix import DeviceDIA, DeviceELL, from_csr
from .matrix import MatrixCOO, MatrixCSR
from .precond import (COLORED_PRECONDS, DEVICE_NATIVE_PRECONDS,
                      ilu0_device_eligible, resolve_gs_mode)
from .solvers import (SolverSetup, SolveResult, preprocessing,
                      preprocessing_device, solve)
from .stencil_op import DeviceStencil
from .types import PRECOND_CLI_NAMES, SOLVER_CLI_FLAGS, PrecondType, SolverType

__version__ = "0.1.0"

__all__ = ["SolverConfig", "SolverType", "PrecondType", "SolverSetup",
           "SolveResult", "DeviceStencil", "DeviceDIA", "DeviceELL",
           "MatrixCOO", "MatrixCSR", "stencil_op", "dia", "generators",
           "convert", "from_csr", "preprocessing", "preprocessing_device",
           "solve", "solve_system"]


def _device_route(source: str, config: SolverConfig, method, precond,
                  device):
    """The device operator solve_system builds for a generator spec, or
    None for the host-CSR route (the JAX package's rules,
    basic_iterative_solvers_tpu/__init__.py:96-146).  May set
    config.matrix_format to "stencil"."""
    from .ops.block_trisolve import stencil_ilu0_eligible
    if config.color_spec is None:
        config.color_spec = generators.color_spec_for_source(source)
    if (precond == PrecondType.MULTIGRID and config.matrix_format == "auto"
            and stencil_op.stencil_buildable(source)):
        config.matrix_format = "stencil"
    colored = resolve_gs_mode(config, device_native=True) == "colored"
    ilu0_stencil = False
    if (precond == PrecondType.ILU0 and colored
            and config.perm_mode == "none"
            and config.matrix_format in ("auto", "stencil")
            and generators.device_buildable(source)
            and stencil_op.stencil_buildable(source)):
        try:
            op = stencil_op.from_source_operator(
                source, dtype=config.mat_dtype(), device=device)
            ilu0_stencil = stencil_ilu0_eligible(
                op, coloring.spec_for_device(op))
        except ValueError:
            pass
    if ilu0_stencil and config.matrix_format == "auto":
        config.matrix_format = "stencil"
    device_ok = (generators.device_buildable(source)
                 and (precond in DEVICE_NATIVE_PRECONDS
                      or (precond in COLORED_PRECONDS and colored)
                      or ilu0_stencil)
                 and (method not in (SolverType.GAUSS_SEIDEL,
                                     SolverType.SYMMETRIC_GAUSS_SEIDEL)
                      or colored)
                 and config.perm_mode == "none"
                 and not (config.num_scale
                          and config.matrix_format == "stencil")
                 and config.matrix_format in ("auto", "dia", "stencil"))
    if not device_ok:
        if config.matrix_format == "stencil":
            raise ValueError(
                "matrix_format='stencil' needs a generator source and a "
                "device-native method/preconditioner; use "
                "matrix_format='auto' here")
        return None
    if config.matrix_format == "stencil":
        return stencil_op.from_source_operator(
            source, dtype=config.mat_dtype(), device=device)
    return dia.from_source_device(source, dtype=config.mat_dtype(),
                                  device=device)


def solve_system(matrix_source, method="cg", preconditioner=None, b=None,
                 x0=None, *, device="cuda", **config_kwargs) -> SolveResult:
    """One-call API, routed as the JAX package's solve_system.

    `matrix_source` is a generator spec ("hpcg:64x64x64", "fdm:16",
    "band:100,2", "sband:...", "scamac:Anderson,..."), a .mtx path, a
    MatrixCSR, a scipy.sparse matrix, a dense 2-D ndarray, or a device
    operator (DeviceStencil, DeviceDIA) that lies on `device`.  A spec with
    an on-device builder and a method and preconditioner the device-native
    path serves builds a DeviceDIA (matrix_format "auto" or "dia") or a
    stencil ("stencil"; also -p mg and exact ILU(0) on an eligible
    stencil); everything else goes through host CSR and `preprocessing`.
    The card is the default; with no card, ask for device="cpu".

    `method` and `preconditioner` take the CLI short names ("cg", "j",
    "gs", "sgs", "bi", "gm"; "none", "j", "gs", "bgs", "sgs", "2st",
    "s2st", "ilu0") or the enums.  Other keyword arguments go to
    SolverConfig; the dtype defaults to float32 on a card and float64 on
    the CPU, the harness to "fused" on a card and "host" on the CPU."""
    import numpy as np
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
    if isinstance(A, (DeviceStencil, DeviceDIA)):
        if A.device.type != device.type:
            raise ValueError(f"the operator lies on {A.device}, the call "
                             f"asks for {device}")
        return solve(preprocessing_device(A, config, b=b, x0=x0))
    if isinstance(A, str):
        A_dev = _device_route(A, config, method, preconditioner, device)
        if A_dev is not None:
            return solve(preprocessing_device(A_dev, config, b=b, x0=x0))
        A = generators.from_source(A)
    if not isinstance(A, MatrixCSR):
        if hasattr(A, "tocsr"):
            A = MatrixCSR.from_scipy(A)
        elif isinstance(A, np.ndarray) and A.ndim == 2:
            A = MatrixCSR.from_dense(A)
        else:
            raise TypeError(
                f"unsupported matrix source: {type(matrix_source).__name__}")
    return solve(preprocessing(A, config, b=b, x0=x0, device=device))
