"""Preconditioner set-up on the host: L/U splitting, the diagonal, scaling,
ILU(0) (natural and colour-sorted ordering) and level sets.  The JAX
package's factor.py, step for step: each pass takes the native host
library (_native.py) unless BIS_TPU_NO_NATIVE is set, and its NumPy branch
is the plain version.  Both packages produce the same factors bit for bit
on either branch.  The native ILU(0) loops contract to fused multiply-adds,
so native and NumPy ILU(0) values may differ in the last bit.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from .matrix import MatrixCSR

ZERO_DIAG_TOL = 1e-16


class ZeroDiagonalError(ValueError):
    """A stored diagonal entry is (numerically) zero."""


class MissingDiagonalError(ValueError):
    """A row of the matrix has no stored diagonal entry."""


def _csr_of(A: MatrixCSR, rows, mask) -> MatrixCSR:
    counts = np.bincount(rows[mask], minlength=A.n_rows)
    row_ptr = np.zeros(A.n_rows + 1, dtype=np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    return MatrixCSR(A.n_rows, A.n_cols, int(mask.sum()), row_ptr,
                     A.col[mask].copy(), A.val[mask].copy())


def split_LU(A: MatrixCSR) -> Tuple[MatrixCSR, MatrixCSR, MatrixCSR,
                                    MatrixCSR]:
    """(L, L_strict, U, U_strict): L = strictly lower + diagonal, U =
    strictly upper + diagonal."""
    from . import _native
    native = _native.split_lu(A)
    if native is not None:
        return native
    rows = A.rows()
    cols = A.col.astype(np.int64)
    return (_csr_of(A, rows, cols <= rows), _csr_of(A, rows, cols < rows),
            _csr_of(A, rows, cols >= rows), _csr_of(A, rows, cols > rows))


def peel_diag(A: MatrixCSR, need_inv: bool = True,
              check: bool = True) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """(D, 1/D) of the main diagonal; a missing or zero diagonal entry
    raises when `check`."""
    from . import _native
    if _native.available():
        D = _native.peel_diag(A, ZERO_DIAG_TOL, check, check)
        return D, (_inverse(D) if need_inv else None)
    rows = A.rows()
    is_diag = A.col == rows
    diag_rows = rows[is_diag]
    if check and diag_rows.size < A.n_rows:
        missing = np.setdiff1d(np.arange(A.n_rows), diag_rows)[0]
        raise MissingDiagonalError(
            f"ERROR: No diagonal element found in row {missing}")
    D = np.zeros(A.n_rows, dtype=A.val.dtype)
    D[diag_rows] = A.val[is_diag]
    if check and np.any(np.abs(D[diag_rows]) < ZERO_DIAG_TOL):
        bad = diag_rows[np.abs(D[diag_rows]) < ZERO_DIAG_TOL][0]
        raise ZeroDiagonalError(f"ERROR: Zero diagonal element in row {bad}")
    return D, (_inverse(D) if need_inv else None)


def _inverse(D: np.ndarray) -> np.ndarray:
    """1/D, 0 where D is 0."""
    with np.errstate(divide="ignore"):
        return np.where(D != 0.0, 1.0 / np.where(D == 0.0, 1.0, D), 0.0)


def extract_scale(A: MatrixCSR) -> np.ndarray:
    """scale[i] = 1/sqrt(|a_ii|), for symmetric equilibration."""
    D, _ = peel_diag(A, need_inv=False, check=True)
    return 1.0 / np.sqrt(np.abs(D))


def scale_mat(A: MatrixCSR, scale: np.ndarray) -> MatrixCSR:
    """A' = diag(s) A diag(s), in place; returns A."""
    A.val *= scale[A.rows()] * scale[A.col]
    return A


def factor_ilu0(A: MatrixCSR, pivot_tolerance: float = 1e-8,
                pivot_replacement: float = 1e-4):
    """Natural-order ILU(0): (L, L_strict, L_D, U, U_strict, U_D), L with
    its unit diagonal stored last in each row, U_D the U diagonal."""
    return _assemble_ilu0(A, _ilu0_values(A, pivot_tolerance,
                                          pivot_replacement))


def _assemble_ilu0(A: MatrixCSR, lu_val: np.ndarray):
    """Split in-pattern LU values into L (unit diagonal), L_strict, U and
    U_strict."""
    n = A.n_rows
    rows = A.rows()
    cols = A.col.astype(np.int64)
    lower_strict = cols < rows
    counts = np.bincount(rows[lower_strict], minlength=n) + 1
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    nnz = int(row_ptr[-1])
    out_col = np.empty(nnz, dtype=np.int32)
    out_val = np.empty(nnz, dtype=np.float64)
    sel = np.nonzero(lower_strict)[0]
    r = rows[sel]
    strict_start = np.zeros(n, dtype=np.int64)
    np.cumsum(counts[:-1] - 1, out=strict_start[1:])
    write = row_ptr[r] + (np.arange(sel.size) - strict_start[r])
    out_col[write] = cols[sel]
    out_val[write] = lu_val[sel]
    out_col[row_ptr[1:] - 1] = np.arange(n)
    out_val[row_ptr[1:] - 1] = 1.0
    L = MatrixCSR(n, A.n_cols, nnz, row_ptr, out_col, out_val)
    LU = MatrixCSR(A.n_rows, A.n_cols, A.nnz, A.row_ptr, A.col, lu_val)
    L_strict = _csr_of(LU, rows, lower_strict)
    U = _csr_of(LU, rows, cols >= rows)
    U_strict = _csr_of(LU, rows, cols > rows)
    U_D, _ = peel_diag(U, need_inv=False, check=False)
    return L, L_strict, np.ones(n, dtype=np.float64), U, U_strict, U_D


@dataclasses.dataclass
class LUFactors:
    """What factor_LU produces."""

    L: MatrixCSR
    L_strict: MatrixCSR
    U: MatrixCSR
    U_strict: MatrixCSR
    A_D: np.ndarray
    A_D_inv: np.ndarray
    L_D: np.ndarray
    U_D: np.ndarray


def factor_LU(A: MatrixCSR, ilu0: bool = False,
              pivot_tolerance: float = 1e-8,
              pivot_replacement: float = 1e-4) -> LUFactors:
    """split → peel A_D; with `ilu0` the L/U parts become the incomplete
    factors and U_D their U diagonal."""
    L, L_strict, U, U_strict = split_LU(A)
    A_D, A_D_inv = peel_diag(L)
    L_D = np.ones(A.n_rows, dtype=np.float64)
    U_D = A_D.copy()
    if ilu0:
        L, L_strict, L_D, U, U_strict, U_D = factor_ilu0(
            A, pivot_tolerance, pivot_replacement)
    return LUFactors(L, L_strict, U, U_strict, A_D, A_D_inv, L_D, U_D)


def factor_ilu0_colored(A: MatrixCSR, colors: np.ndarray,
                        pivot_tolerance: float = 1e-8,
                        pivot_replacement: float = 1e-4):
    """Exact ILU(0) in the colour-sorted ordering, returned in the original
    ordering as (L_strict, U_strict, U_D): L_strict the entries with
    colour(j) < colour(i) (unit diagonal implicit), U_strict those with
    colour(j) > colour(i), U_D U's diagonal.  Both keep A's positions, so a
    stencil's factors stay DIA-able and apply as masked colour sweeps."""
    from .matrix import MatrixCOO, convert_coo_to_csr
    rows_o, cols_o, lu_val_p, U_D = factor_ilu0_colored_triplets(
        A, colors, pivot_tolerance=pivot_tolerance,
        pivot_replacement=pivot_replacement)
    n = A.n_rows
    ci, cj = colors[rows_o], colors[cols_o]

    def build(mask):
        return convert_coo_to_csr(MatrixCOO.from_arrays(
            rows_o[mask], cols_o[mask], lu_val_p[mask], n_rows=n, n_cols=n))

    return build(cj < ci), build(cj > ci), U_D


def factor_ilu0_colored_triplets(A: MatrixCSR, colors: np.ndarray,
                                 pivot_tolerance: float = 1e-8,
                                 pivot_replacement: float = 1e-4):
    """Coloured ILU(0) factor values as raw triplets in the original
    ordering: (rows, cols, vals, U_D).  A is factored in the colour-sorted
    ordering; the triplets carry every factor entry (L, U and the
    diagonal), and U_D is the U diagonal per original row.  The native
    branch permutes and factors in one sweep and returns int32 rows and
    columns; the NumPy branch int64."""
    from . import _native
    from .coloring import colors_to_perm
    from .permute import permute_csr
    perm, inv = colors_to_perm(colors)
    fused = _native.permute_factor_csr(A, perm, inv, pivot_tolerance,
                                       pivot_replacement)
    if fused is not None:
        Ap, lu_val_p = fused
    else:
        Ap = permute_csr(A, perm, inv)
        lu_val_p = _ilu0_values(Ap, pivot_tolerance, pivot_replacement)
    n = A.n_rows
    if _native.available() and n < 2**31:
        rows_o, cols_o, U_D = _native.expand_perm_triplets(Ap, lu_val_p,
                                                           perm)
        return rows_o, cols_o, lu_val_p, U_D
    rows_o = perm[Ap.rows()].astype(np.int64)
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
    from . import _native
    lu_val = _native.ilu0(A, pivot_tolerance, pivot_replacement)
    if lu_val is not None:
        return lu_val
    n = A.n_rows
    row_ptr, col = A.row_ptr, A.col
    lu_val = A.val.astype(np.float64).copy()
    diag_pos = np.full(n, -1, dtype=np.int64)
    rows = A.rows()
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


# ---------------------------------------------------------------------------
# Level sets for the level-scheduled triangular solves (ops/trisolve.py)
# ---------------------------------------------------------------------------

def level_sets_lower(L_strict: MatrixCSR) -> np.ndarray:
    """level[i] = 1 + max(level[j]: j in the strictly lower pattern of row
    i); rows of one level are independent in the forward substitution."""
    from . import _native
    levels = _native.level_sets(L_strict)
    if levels is not None:
        return levels
    n = L_strict.n_rows
    level = np.zeros(n, dtype=np.int32)
    row_ptr, col = L_strict.row_ptr, L_strict.col
    for i in range(n):
        s, e = row_ptr[i], row_ptr[i + 1]
        if e > s:
            level[i] = level[col[s:e]].max() + 1
    return level


def level_sets_upper(U_strict: MatrixCSR) -> np.ndarray:
    """Level sets of the backward substitution (rows n-1 → 0)."""
    from . import _native
    levels = _native.level_sets_upper(U_strict)
    if levels is not None:
        return levels
    n = U_strict.n_rows
    level = np.zeros(n, dtype=np.int32)
    row_ptr, col = U_strict.row_ptr, U_strict.col
    for i in range(n - 1, -1, -1):
        s, e = row_ptr[i], row_ptr[i + 1]
        if e > s:
            level[i] = level[col[s:e]].max() + 1
    return level
