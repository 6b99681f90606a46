"""DIA SpMV: y[i] = Σ_d data[d, i]·x[i + off_d], x read as 0 outside.

`dia_spmv` is the entry point: on a CUDA tensor it launches the
hand-written kernel (csrc/sparse_spmv.cu, the port of the JAX package's
Pallas `dia_pallas_core`) or raises, counting launches in
`dia_spmv.launches`; on a CPU tensor it runs `dia_spmv_plain`, the JAX
package's XLA form (ops/spmv.spmv_dia): one shifted product added per
diagonal, in offset order, which the kernel follows bit for bit.  The data
may be stored in bfloat16 beside float32 or float64 vectors (matrix_dtype):
each value is widened to the vector dtype before its product, and that
form's launches are counted in `dia_spmv.bf16_launches`.  The JAX
package's Pallas kernel sums by lane-residue groups instead, so it agrees
with both to rounding only.

`dia_spmv_halo` is one mesh shard's SpMV (the JAX package's dia_pallas_core
fed a halo-padded window, parallel/mesh_ops.mesh_dia_spmv): the shard's own
data rows and its x window, with its plain version
`dia_spmv_halo_plain`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..config import kernel_suffix, serves_vectors


def _check(A, x: torch.Tensor):
    if not isinstance(x, torch.Tensor):
        raise TypeError("x must be a torch.Tensor")
    if x.shape != (A.n_cols,):
        raise ValueError(f"x has shape {tuple(x.shape)}, expected "
                         f"({A.n_cols},)")
    if not serves_vectors(A.dtype, x.dtype):
        raise TypeError(f"x is {x.dtype}, the operator {A.dtype}")
    if x.device != A.device:
        raise ValueError(f"x is on {x.device}, the operator on {A.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if A.n_rows != A.n_cols:
        raise ValueError("the DIA SpMV takes square matrices")


def dia_spmv_plain(A, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel."""
    _check(A, x)
    n = A.n_rows
    if not A.offsets:
        return torch.zeros_like(x)
    hneg = max(0, -min(A.offsets))
    hpos = max(0, max(A.offsets))
    xp = torch.nn.functional.pad(x, (hneg, hpos))
    y = torch.zeros_like(x)
    for d, off in enumerate(A.offsets):
        y = y + A.data[d].to(x.dtype) * xp[hneg + off:hneg + off + n]
    return y


@functools.lru_cache(maxsize=64)
def _dia_args(offsets, n: int):
    """The kernel's argument block (offsets by value)."""
    from .._build import DiaArgs
    args = DiaArgs()
    for d, off in enumerate(offsets):
        args.off[d] = off
    args.n, args.n_diags = n, len(offsets)
    return args


def _dia_spmv_cuda(A, x: torch.Tensor) -> torch.Tensor:
    from .._build import MAX_DIAGS, launch, load_library
    suffix = kernel_suffix(x.dtype, A.dtype)
    if len(A.offsets) > MAX_DIAGS:
        raise ValueError(f"the DIA kernel takes at most {MAX_DIAGS} "
                         f"diagonals, the matrix has {len(A.offsets)}")
    if not A.data.is_contiguous():
        raise ValueError("the DIA data must be contiguous")
    args = _dia_args(A.offsets, A.n_rows)
    y = torch.empty_like(x)
    lib = load_library()
    err = launch(getattr(lib, f"bis_dia_spmv_{suffix}"), x.device,
                 ctypes.byref(args), A.data.data_ptr(), x.data_ptr(),
                 y.data_ptr())
    if err != 0:
        raise RuntimeError(f"dia_spmv kernel launch failed with CUDA error "
                           f"{err}")
    if A.dtype == torch.bfloat16:
        dia_spmv.bf16_launches += 1
    else:
        dia_spmv.launches += 1
    return y


def dia_spmv(A, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for a DeviceDIA A.  A CUDA tensor goes through the
    hand-written kernel (`dia_spmv.launches` counts its launches, and
    `dia_spmv.bf16_launches` those of its bfloat16-data form); a CPU
    tensor takes the plain version.  A matrix with no stored diagonal
    gives zeros and launches nothing."""
    _check(A, x)
    if not A.offsets:
        return torch.zeros_like(x)
    if x.device.type == "cuda":
        return _dia_spmv_cuda(A, x)
    if x.device.type == "cpu":
        return dia_spmv_plain(A, x)
    raise ValueError(f"no DIA SpMV for device {x.device}")


dia_spmv.launches = 0
dia_spmv.bf16_launches = 0


# ---------------------------------------------------------------------------
# Shard-local form (a row-sharded mesh, parallel/mesh_ops.py)
# ---------------------------------------------------------------------------

def _check_halo(data, offsets, xw, hneg: int, out) -> int:
    """Check a shard's operands; returns its row count."""
    if not isinstance(xw, torch.Tensor) or xw.dim() != 1:
        raise TypeError("the window must be a 1-D torch.Tensor")
    if data.dim() != 2 or data.shape[0] != len(offsets):
        raise ValueError(f"data has shape {tuple(data.shape)}, expected "
                         f"({len(offsets)}, rows)")
    rows = data.shape[1]
    lo = max(0, -min(offsets)) if offsets else 0
    hi = max(0, max(offsets)) if offsets else 0
    if hneg < lo or xw.numel() < hneg + rows + hi:
        raise ValueError(f"a window of {xw.numel()} with {hneg} rows below "
                         f"does not cover {rows} rows and offsets "
                         f"[{-lo}, {hi}]")
    if not serves_vectors(data.dtype, xw.dtype):
        raise TypeError(f"xw is {xw.dtype}, the data {data.dtype}")
    if (xw.device != data.device or not xw.is_contiguous()
            or not data.is_contiguous()):
        raise ValueError("the window and the data must be contiguous, on "
                         "one device")
    if out is not None and (out.shape != (rows,) or out.dtype != xw.dtype
                            or out.device != xw.device
                            or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous ({rows},) {xw.dtype} "
                         f"tensor on {xw.device}")
    return rows


def dia_spmv_halo_plain(data: torch.Tensor, offsets, xw: torch.Tensor,
                        hneg: int) -> torch.Tensor:
    """Plain PyTorch version of the shard-local kernel: y[t] = Σ_d
    data[d, t]·xw[hneg + t + off_d], one shifted product added per
    diagonal in offset order (the single-device plain version's sums)."""
    rows = _check_halo(data, offsets, xw, hneg, None)
    y = torch.zeros(rows, dtype=xw.dtype, device=xw.device)
    for d, off in enumerate(offsets):
        y = y + data[d].to(xw.dtype) * xw[hneg + off:hneg + off + rows]
    return y


def dia_spmv_halo(data: torch.Tensor, offsets, xw: torch.Tensor, hneg: int,
                  out: torch.Tensor = None) -> torch.Tensor:
    """One mesh shard's DIA SpMV: its (k, rows) data, its window xw (hneg
    rows of its left neighbour, its rows, its right neighbour's rows; zeros
    at the global edges), y written to `out` when given.  A CUDA tensor
    launches the shard-local kernel (csrc/sparse_spmv.cu), counted in
    `dia_spmv_halo.launches` (`.bf16_launches` for bfloat16 data): y
    bit-equal to the single-device kernel's rows; a CPU tensor takes the
    plain version (a meta tensor its shapes)."""
    rows = _check_halo(data, offsets, xw, hneg, out)
    if xw.device.type in ("cpu", "meta"):
        y = dia_spmv_halo_plain(data, offsets, xw, hneg)
        return y if out is None else out.copy_(y)
    if xw.device.type != "cuda":
        raise ValueError(f"no DIA SpMV for device {xw.device}")
    from .._build import MAX_DIAGS, launch, load_library
    if len(offsets) > MAX_DIAGS:
        raise ValueError(f"the DIA kernel takes at most {MAX_DIAGS} "
                         f"diagonals, the matrix has {len(offsets)}")
    y = torch.empty(rows, dtype=xw.dtype, device=xw.device) \
        if out is None else out
    err = launch(getattr(load_library(), "bis_dia_spmv_halo_"
                         + kernel_suffix(xw.dtype, data.dtype)), xw.device,
                 ctypes.byref(_dia_args(tuple(offsets), rows)),
                 data.data_ptr(), xw.data_ptr(), y.data_ptr(), hneg,
                 xw.numel())
    if err != 0:
        raise RuntimeError(f"dia_spmv_halo kernel launch failed with CUDA "
                           f"error {err}")
    if data.dtype == torch.bfloat16:
        dia_spmv_halo.bf16_launches += 1
    else:
        dia_spmv_halo.launches += 1
    return y


dia_spmv_halo.launches = 0
dia_spmv_halo.bf16_launches = 0
