"""Symmetric permutation of a host CSR matrix (the JAX package's
permute.permute_csr, NumPy only)."""
from __future__ import annotations

import numpy as np

from .matrix import MatrixCSR


def permute_csr(A: MatrixCSR, perm: np.ndarray,
                inv_perm: np.ndarray) -> MatrixCSR:
    """A' = P A Pᵀ with column-sorted rows (perm[new] = old)."""
    counts = A.row_nnz()[perm]
    row_ptr = np.zeros(A.n_rows + 1, dtype=np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    total = int(counts.sum())
    lane = (np.arange(total, dtype=np.int64)
            - np.repeat(row_ptr[:-1], counts))
    src = np.repeat(A.row_ptr[perm], counts) + lane
    col = inv_perm[A.col[src]].astype(np.int32)
    val = A.val[src].copy()
    rows = np.repeat(np.arange(A.n_rows, dtype=np.int64), counts)
    order = np.lexsort((col, rows))
    return MatrixCSR(A.n_rows, A.n_cols, A.nnz, row_ptr, col[order],
                     val[order])
