"""Host-side sparse matrices: the JAX package's matrix.py (COO triplets,
column-sorted CSR and the conversions between them, the dense and scipy
adapters).  Everything here is set-up work; the device formats are built
from `MatrixCSR` in device_matrix.py.  The host SpMV and COO → CSR take
the native host library (_native.py) unless BIS_TPU_NO_NATIVE is set; the
NumPy branches are their plain versions.
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
    is_symmetric: bool = False

    @staticmethod
    def from_arrays(I, J, values, n_rows=None, n_cols=None,
                    is_symmetric=False) -> "MatrixCOO":
        I = np.asarray(I, dtype=np.int32)
        J = np.asarray(J, dtype=np.int32)
        values = np.asarray(values, dtype=np.float64)
        if n_rows is None:
            n_rows = int(I.max()) + 1 if I.size else 0
        if n_cols is None:
            n_cols = int(J.max()) + 1 if J.size else 0
        return MatrixCOO(int(n_rows), int(n_cols), int(values.size), I, J,
                         values, is_symmetric=is_symmetric)

    def sort(self) -> "MatrixCOO":
        """Stable row-major (row, col) sort."""
        if self.is_sorted:
            return self
        perm = np.lexsort((self.J, self.I))
        return MatrixCOO(self.n_rows, self.n_cols, self.nnz, self.I[perm],
                         self.J[perm], self.values[perm], is_sorted=True,
                         is_symmetric=self.is_symmetric)


@dataclasses.dataclass
class MatrixCSR:
    """CSR with column-sorted rows."""

    n_rows: int
    n_cols: int
    nnz: int
    row_ptr: np.ndarray    # (n_rows+1,) int64
    col: np.ndarray        # (nnz,) int32
    val: np.ndarray        # (nnz,) float64

    def copy(self) -> "MatrixCSR":
        return MatrixCSR(self.n_rows, self.n_cols, self.nnz,
                         self.row_ptr.copy(), self.col.copy(), self.val.copy())

    def row_nnz(self) -> np.ndarray:
        return np.diff(self.row_ptr)

    def rows(self) -> np.ndarray:
        """int64 row index of every stored entry."""
        return np.repeat(np.arange(self.n_rows, dtype=np.int64),
                         self.row_nnz())

    def to_dense(self) -> np.ndarray:
        out = np.zeros((self.n_rows, self.n_cols), dtype=self.val.dtype)
        out[self.rows(), self.col] = self.val
        return out

    def diagonal(self) -> np.ndarray:
        """Dense main diagonal (missing entries are 0)."""
        d = np.zeros(self.n_rows, dtype=self.val.dtype)
        rows = self.rows()
        mask = rows == self.col
        d[rows[mask]] = self.val[mask]
        return d

    def spmv(self, x: np.ndarray) -> np.ndarray:
        """Host SpMV in float64 (the test oracle): the native row loop, or
        add.reduceat over the non-empty row segments (the NumPy branch)."""
        if self.nnz == 0:
            return np.zeros(self.n_rows, dtype=np.result_type(self.val, x))
        from . import _native
        if _native.available():
            return _native.spmv_csr(self, x)
        prod = self.val * x[self.col]
        starts = self.row_ptr[:-1]
        nonempty = self.row_ptr[1:] > starts
        y = np.zeros(self.n_rows, dtype=prod.dtype)
        y[nonempty] = np.add.reduceat(prod, starts[nonempty])
        return y

    @staticmethod
    def from_dense(dense: np.ndarray) -> "MatrixCSR":
        dense = np.asarray(dense, dtype=np.float64)
        I, J = np.nonzero(dense)
        return convert_coo_to_csr(MatrixCOO.from_arrays(
            I, J, dense[I, J], n_rows=dense.shape[0], n_cols=dense.shape[1]))

    @staticmethod
    def from_scipy(sp) -> "MatrixCSR":
        """From any scipy.sparse matrix or array: duplicates summed, rows
        column-sorted."""
        m = sp.tocsr()
        m.sum_duplicates()
        m.sort_indices()
        n_rows, n_cols = m.shape
        return MatrixCSR(int(n_rows), int(n_cols), int(m.nnz),
                         np.asarray(m.indptr, dtype=np.int64),
                         np.asarray(m.indices, dtype=np.int32),
                         np.asarray(m.data, dtype=np.float64))


def convert_coo_to_csr(coo: MatrixCOO,
                       n_cols: Optional[int] = None) -> MatrixCSR:
    """COO → CSR with column-sorted rows; duplicate entries raise."""
    from . import _native
    if _native.available():
        n_cols = coo.n_cols if n_cols is None else n_cols
        row_ptr, col, val = _native.coo_to_csr(
            coo.nnz, coo.n_rows, n_cols, coo.I, coo.J, coo.values)
        return MatrixCSR(coo.n_rows, n_cols, coo.nnz, row_ptr, col, val)
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


def csr_to_coo(csr: MatrixCSR) -> MatrixCOO:
    rows = csr.rows().astype(np.int32)
    return MatrixCOO(csr.n_rows, csr.n_cols, csr.nnz, rows, csr.col.copy(),
                     csr.val.copy(), is_sorted=True)
