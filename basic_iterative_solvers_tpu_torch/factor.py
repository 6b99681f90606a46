"""Coloured ILU(0) factor values on the host: the NumPy branch of the JAX
package's factor.py (`_ilu0_values`, `factor_ilu0_colored_triplets`).

The port factors only the small prototype grid of the translation-table
ILU(0) (ops/block_trisolve._ilu0_translation_tables): at most ~18³ rows for
HPCG at any grid size, so the row loop below is set-up work of about a
second, with no native library.
"""
from __future__ import annotations

import numpy as np

from .matrix import MatrixCSR


class MissingDiagonalError(ValueError):
    """A row of the matrix has no stored diagonal entry."""


def factor_ilu0_colored_triplets(A: MatrixCSR, colors: np.ndarray,
                                 pivot_tolerance: float = 1e-8,
                                 pivot_replacement: float = 1e-4):
    """Coloured ILU(0) factor values as raw triplets in the original
    ordering: (rows, cols, vals, U_D).  A is factored in the colour-sorted
    ordering; the triplets carry every factor entry (L, U and the
    diagonal), and U_D is the U diagonal per original row."""
    from .coloring import colors_to_perm
    from .permute import permute_csr
    perm, inv = colors_to_perm(colors)
    Ap = permute_csr(A, perm, inv)
    lu_val_p = _ilu0_values(Ap, pivot_tolerance, pivot_replacement)
    n = A.n_rows
    rows_p = np.repeat(np.arange(n, dtype=np.int64), Ap.row_nnz())
    rows_o = perm[rows_p].astype(np.int64)
    cols_o = perm[Ap.col].astype(np.int64)
    diag_mask = rows_o == cols_o
    U_D = np.zeros(n, dtype=np.float64)
    U_D[rows_o[diag_mask]] = lu_val_p[diag_mask]
    return rows_o, cols_o, lu_val_p, U_D


def _ilu0_values(A: MatrixCSR, pivot_tolerance: float,
                 pivot_replacement: float) -> np.ndarray:
    """In-pattern ILU(0) values of A: row-wise IKJ elimination with the
    reference's pivot guards (a pivot below 1e-16 skips its column; a final
    diagonal below `pivot_tolerance` becomes ±`pivot_replacement`)."""
    n = A.n_rows
    row_ptr, col = A.row_ptr, A.col
    lu_val = A.val.astype(np.float64).copy()
    diag_pos = np.full(n, -1, dtype=np.int64)
    rows = np.repeat(np.arange(n, dtype=np.int64), A.row_nnz())
    is_diag = col == rows
    diag_pos[rows[is_diag]] = np.nonzero(is_diag)[0]
    if np.any(diag_pos < 0):
        missing = int(np.nonzero(diag_pos < 0)[0][0])
        raise MissingDiagonalError("ERROR: ILU(0) requires a full diagonal; "
                                   f"missing in row {missing}")
    w_pos = np.full(A.n_cols, -1, dtype=np.int64)
    for i in range(n):
        s, e = row_ptr[i], row_ptr[i + 1]
        cols_i = col[s:e]
        w_pos[cols_i] = np.arange(s, e)
        for p_ in range(s, e):
            k = col[p_]
            if k >= i:
                break
            pivot = lu_val[diag_pos[k]]
            if abs(pivot) < 1e-16:
                continue
            factor = lu_val[p_] / pivot
            lu_val[p_] = factor
            for q in range(diag_pos[k] + 1, row_ptr[k + 1]):
                tgt = w_pos[col[q]]
                if tgt >= 0:
                    lu_val[tgt] -= factor * lu_val[q]
        d = lu_val[diag_pos[i]]
        if abs(d) < pivot_tolerance:
            lu_val[diag_pos[i]] = (1.0 if d >= 0 else -1.0) * pivot_replacement
        w_pos[cols_i] = -1
    return lu_val
