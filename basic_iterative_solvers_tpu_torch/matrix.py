"""Host-side sparse matrices: the subset of the JAX package's matrix.py that
the ILU(0) prototype factorization needs (COO triplets, column-sorted CSR
and the conversion between them).  NumPy only: it is set-up work on at most
a few thousand rows.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class MatrixCOO:
    """COO triplets (0-based)."""

    n_rows: int
    n_cols: int
    nnz: int
    I: np.ndarray          # (nnz,) int32 row indices
    J: np.ndarray          # (nnz,) int32 col indices
    values: np.ndarray     # (nnz,) float64
    is_sorted: bool = False

    @staticmethod
    def from_arrays(I, J, values, n_rows=None, n_cols=None) -> "MatrixCOO":
        I = np.asarray(I, dtype=np.int32)
        J = np.asarray(J, dtype=np.int32)
        values = np.asarray(values, dtype=np.float64)
        if n_rows is None:
            n_rows = int(I.max()) + 1 if I.size else 0
        if n_cols is None:
            n_cols = int(J.max()) + 1 if J.size else 0
        return MatrixCOO(int(n_rows), int(n_cols), int(values.size), I, J,
                         values)

    def sort(self) -> "MatrixCOO":
        """Stable row-major (row, col) sort."""
        if self.is_sorted:
            return self
        perm = np.lexsort((self.J, self.I))
        return MatrixCOO(self.n_rows, self.n_cols, self.nnz, self.I[perm],
                         self.J[perm], self.values[perm], is_sorted=True)


@dataclasses.dataclass
class MatrixCSR:
    """CSR with column-sorted rows."""

    n_rows: int
    n_cols: int
    nnz: int
    row_ptr: np.ndarray    # (n_rows+1,) int64
    col: np.ndarray        # (nnz,) int32
    val: np.ndarray        # (nnz,) float64

    def row_nnz(self) -> np.ndarray:
        return np.diff(self.row_ptr)


def convert_coo_to_csr(coo: MatrixCOO,
                       n_cols: Optional[int] = None) -> MatrixCSR:
    """COO → CSR with column-sorted rows; duplicate entries raise."""
    coo = coo.sort()
    if coo.nnz and coo.n_rows:
        dup = (np.diff(coo.I) == 0) & (np.diff(coo.J) == 0)
        if np.any(dup):
            raise ValueError("duplicate (row, col) entries in COO matrix")
    counts = np.bincount(coo.I, minlength=coo.n_rows).astype(np.int64)
    row_ptr = np.zeros(coo.n_rows + 1, dtype=np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    if row_ptr[-1] != coo.nnz:
        raise ValueError("ERROR: converting to CRS (row_ptr/nnz mismatch)")
    n_cols = coo.n_cols if n_cols is None else n_cols
    return MatrixCSR(coo.n_rows, n_cols, coo.nnz, row_ptr,
                     coo.J.astype(np.int32).copy(),
                     coo.values.astype(np.float64).copy())
