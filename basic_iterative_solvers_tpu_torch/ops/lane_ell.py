"""Lane-ELL: the general-sparsity SpMV format.

The JAX package's layout (ops/lane_ell.py), kept so both packages build
the same planes: matrix row i maps to slot (r, l) = (i // 128, i % 128) of
an (R, 128) plane; each nonzero A[i, j] sits in one of K slot planes as
`vals[k, r, l]` and a packed index `idx[k, r, l] = (rowoff + S)·128 +
lane`, rowoff = j//128 − i//128 and lane = j % 128; S = max |rowoff|.  Pad
slots hold val 0 and an in-range index.  R is padded to a multiple of the
JAX package's row tile (a TPU tile, kept so the planes match; the kernel
never reads the pad rows).  The slot planes are column-major ELL:
neighbouring rows are neighbouring addresses in every plane.

`lane_ell_spmv` is the entry point: on a CUDA tensor it launches the
hand-written kernel (csrc/sparse_spmv.cu, the port of the JAX package's
Pallas `_lane_ell_kernel_call`) or raises, counting launches in
`lane_ell_spmv.launches`; on a CPU tensor it runs `lane_ell_spmv_plain`,
the JAX package's XLA form (slot by slot, ascending), which the kernel
follows bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import torch_dtype
from ..matrix import MatrixCSR
from ..stencil_op import resolve_device

#: lanes per plane row
LANES = 128
#: the JAX package's default row tile, which sets the plane padding
_TB = 256


@dataclasses.dataclass
class DeviceLaneELL:
    """Lane-ELL storage (see the module docstring)."""

    vals: torch.Tensor            # (K, R, 128)
    idx: torch.Tensor             # (K, R, 128) int32, packed (rowoff, lane)
    n_rows: int
    n_cols: int
    K: int
    S: int
    R: int

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def nnz_stored(self) -> int:
        return self.vals.numel()


def lane_ell_span(A: MatrixCSR) -> int:
    """Max |j//128 − i//128| over the nonzeros: the shift radius S."""
    if A.nnz == 0:
        return 0
    return int(np.abs(A.col.astype(np.int64) // LANES
                      - A.rows() // LANES).max())


def csr_to_lane_ell(A: MatrixCSR, dtype=torch.float32, *,
                    device="cuda") -> DeviceLaneELL:
    """The lane-ELL planes of A on `device` (the JAX package's NumPy
    branch: each row's entries sorted by (rowoff, lane), pad slots pointing
    at their slot's lowest rowoff)."""
    if A.n_rows != A.n_cols:
        raise ValueError("lane-ELL requires a square matrix")
    device = resolve_device(device)
    n = A.n_rows
    R = max(1, -(-n // LANES))
    S = lane_ell_span(A)
    TB = max(8 * -(-S // 8), min(_TB, 8 * -(-R // 8)), 8)
    R_pad = -(-R // TB) * TB
    row_nnz = A.row_nnz()
    K = max(1, int(row_nnz.max()) if n else 1)
    rows = A.rows()
    cols = A.col.astype(np.int64)
    rowoff = cols // LANES - rows // LANES
    lane = cols % LANES
    order = np.lexsort((lane, rowoff, rows))
    rows, rowoff, lane = rows[order], rowoff[order], lane[order]
    val_sorted = A.val[order]
    slot = np.arange(A.nnz, dtype=np.int64) - A.row_ptr[:-1][rows]
    vals = np.zeros((K, R_pad, LANES), dtype=np.float64)
    idx = np.zeros((K, R_pad, LANES), dtype=np.int32)
    r2, l2 = rows // LANES, rows % LANES
    vals[slot, r2, l2] = val_sorted
    idx[slot, r2, l2] = ((rowoff + S) * LANES + lane).astype(np.int32)
    vals = vals.astype(np.dtype(str(torch_dtype(dtype)).split(".")[1]))
    # pad slots point at their slot's lowest rowoff (0 for an empty slot)
    none = np.iinfo(np.int64).max
    lo = np.full(K, none, dtype=np.int64)
    np.minimum.at(lo, slot, rowoff)
    lo[lo == none] = 0
    idx = np.where((vals == 0) & (idx == 0),
                   ((lo + S) * LANES).astype(np.int32)[:, None, None], idx)
    return DeviceLaneELL(vals=torch.from_numpy(vals).to(device),
                         idx=torch.from_numpy(idx).to(device), n_rows=n,
                         n_cols=n, K=K, S=S, R=R_pad)


# ---------------------------------------------------------------------------
# SpMV
# ---------------------------------------------------------------------------

def _check(M: DeviceLaneELL, x: torch.Tensor):
    if not isinstance(x, torch.Tensor):
        raise TypeError("x must be a torch.Tensor")
    if x.shape != (M.n_rows,):
        raise ValueError(f"x has shape {tuple(x.shape)}, expected "
                         f"({M.n_rows},)")
    if x.dtype != M.dtype:
        raise TypeError(f"x is {x.dtype}, the operator {M.dtype}")
    if x.device != M.device:
        raise ValueError(f"x is on {x.device}, the operator on {M.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")


def lane_ell_spmv_plain(M: DeviceLaneELL, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel (the JAX package's
    lane_ell_spmv_xla): per slot plane, in ascending order, the gathered x
    times the values, added to y."""
    _check(M, x)
    plane = M.R * LANES
    xf = torch.nn.functional.pad(x, (0, plane - M.n_rows))
    r = torch.arange(M.R, device=x.device).view(M.R, 1)
    y = torch.zeros((M.R, LANES), dtype=x.dtype, device=x.device)
    for k in range(M.K):
        p = M.idx[k].long()
        flat = ((r + p // LANES - M.S) * LANES + p % LANES).clamp(0,
                                                                  plane - 1)
        y = y + M.vals[k] * xf[flat]
    return y.reshape(-1)[:M.n_rows]


def _lane_ell_spmv_cuda(M: DeviceLaneELL, x: torch.Tensor) -> torch.Tensor:
    from .._build import load_library
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the lane-ELL kernel takes float32 or float64, not "
                        f"{x.dtype}")
    if not (M.vals.is_contiguous() and M.idx.is_contiguous()
            and M.idx.dtype == torch.int32):
        raise ValueError("the lane-ELL planes must be contiguous, the "
                         "indices int32")
    y = torch.empty_like(x)
    lib = load_library()
    fn = lib.bis_lane_ell_spmv_f32 if x.dtype == torch.float32 \
        else lib.bis_lane_ell_spmv_f64
    err = fn(x.device.index, M.vals.data_ptr(), M.idx.data_ptr(),
             x.data_ptr(), y.data_ptr(), M.n_rows, M.R * LANES, M.K, M.S,
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lane_ell_spmv kernel launch failed with CUDA "
                           f"error {err}")
    lane_ell_spmv.launches += 1
    return y


def lane_ell_spmv(M: DeviceLaneELL, x: torch.Tensor) -> torch.Tensor:
    """y = M @ x.  A CUDA tensor goes through the hand-written kernel
    (`lane_ell_spmv.launches` counts its launches); a CPU tensor takes the
    plain version."""
    _check(M, x)
    if x.device.type == "cuda":
        return _lane_ell_spmv_cuda(M, x)
    if x.device.type == "cpu":
        return lane_ell_spmv_plain(M, x)
    raise ValueError(f"no lane-ELL SpMV for device {x.device}")


lane_ell_spmv.launches = 0
