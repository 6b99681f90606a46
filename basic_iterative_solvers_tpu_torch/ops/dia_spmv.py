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
    from .._build import MAX_DIAGS, load_library
    suffix = kernel_suffix(x.dtype, A.dtype)
    if len(A.offsets) > MAX_DIAGS:
        raise ValueError(f"the DIA kernel takes at most {MAX_DIAGS} "
                         f"diagonals, the matrix has {len(A.offsets)}")
    if not A.data.is_contiguous():
        raise ValueError("the DIA data must be contiguous")
    args = _dia_args(A.offsets, A.n_rows)
    y = torch.empty_like(x)
    lib = load_library()
    err = getattr(lib, f"bis_dia_spmv_{suffix}")(x.device.index, ctypes.byref(args), A.data.data_ptr(),
             x.data_ptr(), y.data_ptr(),
             torch.cuda.current_stream(x.device).cuda_stream)
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
