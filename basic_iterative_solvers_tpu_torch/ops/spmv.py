"""SpMV entry points of the solvers (the reference's native_spmv,
kernels.hpp:22-42).  This slice has one operator format, the matrix-free
stencil; the kernel or its plain version is chosen by the vector's device
(stencil_op.stencil_spmv)."""
from __future__ import annotations

import torch

from ..stencil_op import DeviceStencil, stencil_spmv


def _require_stencil(A):
    if not isinstance(A, DeviceStencil):
        raise TypeError(
            f"unsupported operator type {type(A).__name__}: the DIA, ELL and "
            "lane-ELL formats arrive with ROADMAP Queue 1 slice 5 (the "
            "host-CSR path and general sparsity)")


def spmv(A, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x."""
    _require_stencil(A)
    return stencil_spmv(A, x)


def spmv_dot(A, x: torch.Tensor):
    """(A @ x, dot(A @ x, x)), the dot fused into the SpMV kernel (CG's α
    denominator costs no extra pass over the vectors)."""
    _require_stencil(A)
    return stencil_spmv(A, x, dots=("x",))


def spmv_dots(A, x: torch.Tensor, aux: torch.Tensor = None,
              with_self: bool = False):
    """y = A @ x plus fused reductions: (y[, dot(y, aux)][, dot(y, y)])."""
    _require_stencil(A)
    dots = ("aux",) * (aux is not None) + ("self",) * with_self
    out = stencil_spmv(A, x, dots=dots, aux=aux)
    return out if dots else (out,)


def compute_residual(A, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """residual = b - A@x (the reference's compute_residual,
    kernels.hpp:155-162)."""
    return b - spmv(A, x)
