"""SpMV entry points of the solvers (the reference's native_spmv,
kernels.hpp:22-42): a router over the device formats, as the JAX package's
ops/spmv.py.

* stencil  — stencil_op.stencil_spmv (kernel #1), with the dots fused into
             the kernel;
* DIA      — ops/dia_spmv.dia_spmv (kernel #4);
* lane-ELL — ops/lane_ell.lane_ell_spmv (kernel #5);
* ELL      — a plain torch gather and row sum (the JAX package's XLA
             gather: no TPU kernel stands behind it).

Each kernel or its plain version is chosen by the vector's device.  Fused
dots stay stencil-only, as in the JAX package; elsewhere the dots follow
the SpMV as `torch.dot`s.
"""
from __future__ import annotations

import torch

from ..stencil_op import DeviceStencil, stencil_spmv


def spmv_ell(A, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for a DeviceELL: gather x at the column pattern, multiply,
    sum each row."""
    return torch.sum(A.data * x[A.cols], dim=1)


def spmv(A, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x (dispatch on the device format)."""
    from ..device_matrix import DeviceDIA, DeviceELL
    from .dia_spmv import dia_spmv
    from .lane_ell import DeviceLaneELL, lane_ell_spmv
    if isinstance(A, DeviceStencil):
        return stencil_spmv(A, x)
    if isinstance(A, DeviceDIA):
        return dia_spmv(A, x)
    if isinstance(A, DeviceLaneELL):
        return lane_ell_spmv(A, x)
    if isinstance(A, DeviceELL):
        return spmv_ell(A, x)
    raise TypeError(f"unsupported device matrix type: {type(A).__name__}")


def spmv_dot(A, x: torch.Tensor):
    """(A @ x, dot(A @ x, x)); on a stencil the dot is fused into the SpMV
    kernel (CG's α denominator costs no extra pass over the vectors)."""
    if isinstance(A, DeviceStencil):
        return stencil_spmv(A, x, dots=("x",))
    y = spmv(A, x)
    return y, torch.dot(y, x)


def spmv_dots(A, x: torch.Tensor, aux: torch.Tensor = None,
              with_self: bool = False):
    """y = A @ x plus reductions: (y[, dot(y, aux)][, dot(y, y)])."""
    dots = ("aux",) * (aux is not None) + ("self",) * with_self
    if isinstance(A, DeviceStencil):
        out = stencil_spmv(A, x, dots=dots, aux=aux)
        return out if dots else (out,)
    y = spmv(A, x)
    partner = {"aux": aux, "self": y}
    return (y,) + tuple(torch.dot(y, partner[k]) for k in dots)


def compute_residual(A, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """residual = b - A@x (the reference's compute_residual,
    kernels.hpp:155-162)."""
    return b - spmv(A, x)
