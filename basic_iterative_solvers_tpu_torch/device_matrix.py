"""Device sparse-matrix formats, built once from host CSR.

* **DIA** — `data[d, i] = A[i, i + offsets[d]]` (0 where out of range or
  not stored), `(k, n)` on the device: the SpMV is a sum of products with
  shifted x (ops/dia_spmv.py).  The JAX package pads the row dimension to
  its Pallas row tile; the port stores exactly n columns.
* **lane-ELL** — slot planes over 128-row lanes, for general sparsity with
  a bounded column span (ops/lane_ell.py).
* **ELL** — padded rows `(n, K)` of values and int32 column indices, the
  last resort; its SpMV is a plain torch gather and row sum, as the JAX
  package's is an XLA gather.

`from_csr` picks the format (`auto_format_choice`) or takes the one asked
for.  Operators live on `device`, the card unless the caller asks for the
CPU.  The pattern statistics and the DIA and ELL packs are one sweep of the
native host library each (_native.py) unless BIS_TPU_NO_NATIVE is set;
the NumPy branches are their plain versions, bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .config import torch_dtype
from .matrix import MatrixCSR
from .stencil_op import resolve_device

#: pad row lengths to a multiple of this in ELL
_ELL_PAD = 4

#: lane-ELL eligibility: max |j//128 − i//128| the JAX package's windowed
#: kernel accepts before falling back to the gather ELL; the port keeps the
#: same rule so both packages pick the same format
LANE_ELL_MAX_SPAN = 2048


@dataclasses.dataclass
class DeviceDIA:
    """Diagonal storage: data[d, i] = A[i, i + offsets[d]]; offsets sorted
    ascending."""

    data: torch.Tensor            # (n_diags, n_rows)
    offsets: Tuple[int, ...]
    n_rows: int
    n_cols: int

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def nnz_stored(self) -> int:
        return self.data.numel()


@dataclasses.dataclass
class DeviceELL:
    """Padded-row storage: row i's entries in cols[i, :] / data[i, :],
    padded with (col 0, value 0)."""

    data: torch.Tensor            # (n_rows, K)
    cols: torch.Tensor            # (n_rows, K) int32
    n_rows: int
    n_cols: int

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def nnz_stored(self) -> int:
        return self.data.numel()


def analyze_diagonals(A: MatrixCSR, cap: int = 1 << 20):
    """(distinct diagonal offsets, ascending int64; DIA fill ratio).  The
    native sweep counts at most `cap` distinct diagonals; past it the NumPy
    branch finds them all."""
    if A.nnz == 0:
        return np.zeros(0, dtype=np.int64), 1.0
    from . import _native
    stats = _native.csr_pattern_stats(A, cap=min(cap, A.n_rows + A.n_cols))
    if stats is not None and stats[0] is not None:
        uniq = stats[0]
        return uniq, A.nnz / float(max(1, uniq.size * A.n_rows))
    uniq = np.unique(A.col.astype(np.int64) - A.rows())
    return uniq, A.nnz / float(max(1, uniq.size * A.n_rows))


def pack_dtype(dtype):
    """The host dtype a native pack writes for a `dtype` operator: float32
    for float32 (the cast the NumPy branch leaves to torch, round to nearest
    even either way), else float64, which torch then rounds as it does the
    NumPy branch's."""
    return np.float32 if torch_dtype(dtype) == torch.float32 else np.float64


def csr_to_dia(A: MatrixCSR, dtype=torch.float32, *,
               device="cuda") -> DeviceDIA:
    device = resolve_device(device)
    dtype = torch_dtype(dtype)
    offsets, _ = analyze_diagonals(A)
    from . import _native
    data = _native.csr_to_dia_pack(A, offsets, A.n_rows, pack_dtype(dtype))
    if data is not None:
        data = data[:offsets.size]
    else:
        rows = A.rows()
        d_idx = np.searchsorted(offsets, A.col.astype(np.int64) - rows)
        data = np.zeros((offsets.size, A.n_rows), dtype=np.float64)
        data[d_idx, rows] = A.val
    return DeviceDIA(data=torch.from_numpy(data).to(dtype=dtype,
                                                    device=device),
                     offsets=tuple(int(o) for o in offsets),
                     n_rows=A.n_rows, n_cols=A.n_cols)


def csr_to_ell(A: MatrixCSR, dtype=torch.float32, *,
               device="cuda") -> DeviceELL:
    device = resolve_device(device)
    row_nnz = A.row_nnz()
    K = int(row_nnz.max()) if A.n_rows else 0
    K = max(_ELL_PAD, -(-K // _ELL_PAD) * _ELL_PAD)
    from . import _native
    packed = _native.csr_to_ell_pack(A, K, pack_dtype(dtype))
    if packed is not None:
        data, cols = packed
    else:
        rows = A.rows()
        lane = np.arange(A.nnz, dtype=np.int64) - A.row_ptr[:-1][rows]
        cols = np.zeros((A.n_rows, K), dtype=np.int32)
        data = np.zeros((A.n_rows, K), dtype=np.float64)
        cols[rows, lane] = A.col
        data[rows, lane] = A.val
    return DeviceELL(data=torch.from_numpy(data).to(dtype=torch_dtype(dtype),
                                                    device=device),
                     cols=torch.from_numpy(cols).to(device),
                     n_rows=A.n_rows, n_cols=A.n_cols)


class GatherFallbackWarning(UserWarning):
    """The solve is about to run on the gather ELL format, the slow last
    resort (the JAX package measured it ~200× slower than its lane-ELL
    kernel on its TPU); emitted so the choice is never silent."""


def auto_format_choice(A: MatrixCSR, dia_max_diags: int = 96,
                       dia_min_fill: float = 0.25,
                       max_span: int = None) -> str:
    """The format from_csr(matrix_format="auto") picks: "dia" for a few
    well-filled diagonals, "lane_ell" for a bounded column span, else
    "ell"."""
    from .ops.lane_ell import lane_ell_span
    if max_span is None:
        max_span = LANE_ELL_MAX_SPAN
    offsets, fill = analyze_diagonals(A)
    if (A.n_rows == A.n_cols and 0 < offsets.size <= dia_max_diags
            and fill >= dia_min_fill):
        return "dia"
    if A.n_rows == A.n_cols and A.nnz and lane_ell_span(A) <= max_span:
        return "lane_ell"
    return "ell"


def from_csr(A: MatrixCSR, dtype=torch.float32, matrix_format: str = "auto",
             dia_max_diags: int = 96, dia_min_fill: float = 0.25, *,
             device="cuda"):
    """The device operator of A in `matrix_format` ("dia", "lane_ell",
    "ell", or "auto": auto_format_choice) on `device`."""
    from .ops.lane_ell import csr_to_lane_ell
    if matrix_format == "auto":
        matrix_format = auto_format_choice(A, dia_max_diags, dia_min_fill)
    build = {"dia": csr_to_dia, "ell": csr_to_ell,
             "lane_ell": csr_to_lane_ell}.get(matrix_format)
    if build is None:
        raise ValueError(f"unknown matrix_format: {matrix_format}")
    return build(A, dtype, device=device)


def device_matrix_nnz_bytes(M) -> int:
    """Bytes of matrix data one SpMV streams: values, plus 4-byte indices
    for the ELL formats (a stencil streams only its dense diagonal)."""
    from .ops.lane_ell import DeviceLaneELL
    from .parallel.mesh_ops import unwrap
    from .stencil_op import DeviceStencil
    M = unwrap(M)
    if isinstance(M, DeviceStencil):
        return 0 if M.diag is None else M.diag.numel() * M.diag.element_size()
    itemsize = torch.empty((), dtype=M.dtype).element_size()
    if isinstance(M, (DeviceELL, DeviceLaneELL)):
        return M.nnz_stored * (itemsize + 4)
    return M.nnz_stored * itemsize
