"""SpMV entry points of the solvers (the reference's native_spmv,
kernels.hpp:22-42): a router over the device formats, as the JAX package's
ops/spmv.py.

* stencil  — stencil_op.stencil_spmv (kernel #1), with the dots fused into
             the kernel;
* DIA      — ops/dia_spmv.dia_spmv (kernel #4);
* lane-ELL — ops/lane_ell.lane_ell_spmv (kernel #5);
* ELL      — a plain torch gather and row sum (the JAX package's XLA
             gather: no TPU kernel stands behind it);
* mesh operators (parallel/mesh_ops.py) — the shard-local forms of the
             stencil, DIA and lane-ELL kernels, one launch a shard after a
             halo exchange; a mesh stencil's dots fused per shard and
             summed by psum;
* DTensor operators (the GSPMD mode, parallel/mesh_ops.py `Dist*`) — the
             same shard-local kernels, one launch a rank on its rows of a
             Shard(0) DTensor after a point-to-point halo exchange; a
             stencil's dots fused per rank and summed by one all-reduce.

Each kernel or its plain version is chosen by the vector's device.  Fused
dots stay stencil-only, as in the JAX package; elsewhere the dots follow
the SpMV as the solvers' own dots (ops/blas1.whole_dot: float32 products
summed in float64, reduced to every rank's whole value on DTensors).
`spmv`, `spmv_dot` and `spmv_dots` are TIME'd as "spmv" in the host
harness's kernel-timing mode (utils/ktimers.py).
"""
from __future__ import annotations

import torch

from ..stencil_op import DeviceStencil, stencil_spmv
from ..utils.ktimers import ktime
from .blas1 import whole_dot


def spmv_ell(A, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for a DeviceELL: gather x at the column pattern, multiply,
    sum each row."""
    return torch.sum(A.data.to(x.dtype) * x[A.cols], dim=1)


def spmv(A, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x (dispatch on the device format)."""
    return ktime("spmv", _spmv, A, x)


def _spmv(A, x: torch.Tensor) -> torch.Tensor:
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
    from ..parallel import mesh_ops as mo
    if isinstance(A, mo.MeshStencil):
        return mo.mesh_stencil_spmv(A, x)
    if isinstance(A, mo.MeshDIA):
        return mo.mesh_dia_spmv(A, x)
    if isinstance(A, mo.MeshLaneELL):
        return mo.mesh_lane_ell_spmv(A, x)
    if isinstance(A, mo.DistStencil):
        return mo.dist_stencil_spmv(A, x)
    if isinstance(A, mo.DistDIA):
        return mo.dist_dia_spmv(A, x)
    if isinstance(A, mo.DistLaneELL):
        return mo.dist_lane_ell_spmv(A, x)
    raise TypeError(f"unsupported device matrix type: {type(A).__name__}")


def _fused_dots(A, x, dots, aux):
    """y and its dots from the kernel itself (a stencil, one-device, mesh
    or DTensor), else None."""
    from ..parallel import mesh_ops as mo
    if isinstance(A, DeviceStencil):
        return stencil_spmv(A, x, dots=dots, aux=aux)
    if isinstance(A, mo.MeshStencil):
        return mo.mesh_stencil_spmv(A, x, dots=dots, aux=aux)
    if isinstance(A, mo.DistStencil):
        return mo.dist_stencil_spmv(A, x, dots=dots, aux=aux)
    return None


def spmv_dot(A, x: torch.Tensor):
    """(A @ x, dot(A @ x, x)); on a stencil the dot is fused into the SpMV
    kernel (CG's α denominator costs no extra pass over the vectors)."""
    return ktime("spmv", _spmv_dot, A, x)


def _spmv_dot(A, x: torch.Tensor):
    fused = _fused_dots(A, x, ("x",), None)
    if fused is not None:
        return fused
    y = _spmv(A, x)
    return y, whole_dot(y, x)


def spmv_dots(A, x: torch.Tensor, aux: torch.Tensor = None,
              with_self: bool = False):
    """y = A @ x plus reductions: (y[, dot(y, aux)][, dot(y, y)])."""
    return ktime("spmv", _spmv_dots, A, x, aux, with_self)


def _spmv_dots(A, x: torch.Tensor, aux, with_self: bool):
    dots = ("aux",) * (aux is not None) + ("self",) * with_self
    if not dots:
        return (_spmv(A, x),)
    fused = _fused_dots(A, x, dots, aux)
    if fused is not None:
        return fused
    y = _spmv(A, x)
    partner = {"aux": aux, "self": y}
    return (y,) + tuple(whole_dot(y, partner[k]) for k in dots)


def compute_residual(A, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """residual = b - A@x (the reference's compute_residual,
    kernels.hpp:155-162)."""
    return b - spmv(A, x)
