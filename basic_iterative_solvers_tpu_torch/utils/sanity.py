"""SanityChecker counterparts: debug-mode validation and dump helpers.

The reference's SanityChecker (common.hpp:356-543) bundles vector and
matrix dumps, an L/U-split element-count check, zero/missing-diagonal
aborts and GMRES's orthonormality/factorization checks.  As in the JAX
package (basic_iterative_solvers_tpu/utils/sanity.py), the diagonal aborts
live in factor.py (typed exceptions) and the GMRES checks in
solvers/gmres.debug_check; this module carries the rest: the structural
check of the L/U split and small-system dumps.
"""
from __future__ import annotations

import sys

import numpy as np


class LUSplitError(AssertionError):
    """The split's element counts do not re-assemble the matrix (the
    reference aborts in SanityChecker::check_copied_L_U_elems,
    common.hpp:532-542)."""


def check_lu_split_counts(A, L, L_strict, U, U_strict) -> None:
    """nnz(L) + nnz(U_strict) == nnz(A) == nnz(L_strict) + nnz(U), and the
    parts have A's row count (the reference's element-count audit)."""
    if L.nnz + U_strict.nnz != A.nnz:
        raise LUSplitError(
            f"L/U split element count mismatch: nnz(L)={L.nnz} + "
            f"nnz(U_strict)={U_strict.nnz} != nnz(A)={A.nnz}")
    if L_strict.nnz + U.nnz != A.nnz:
        raise LUSplitError(
            f"L/U split element count mismatch: nnz(L_strict)={L_strict.nnz}"
            f" + nnz(U)={U.nnz} != nnz(A)={A.nnz}")
    for name, part in (("L", L), ("L_strict", L_strict), ("U", U),
                       ("U_strict", U_strict)):
        if part.n_rows != A.n_rows:
            raise LUSplitError(f"{name} has {part.n_rows} rows, "
                               f"A has {A.n_rows}")


def print_vector(v, name: str = "vector", out=None, limit: int = 64) -> None:
    """SanityChecker::print_vector (common.hpp:362-375): the first `limit`
    entries of v (a tensor on any device, or an array)."""
    out = sys.stderr if out is None else out
    if hasattr(v, "detach"):
        v = v.detach().cpu().double().numpy()
    v = np.asarray(v)
    head = v if v.size <= limit else v[:limit]
    tail = "" if v.size <= limit else f" ... ({v.size} entries)"
    print(f"{name} = [" + " ".join(f"{x:.6g}" for x in head) + f"]{tail}",
          file=out)


def print_matrix(A, name: str = "matrix", out=None, limit: int = 16) -> None:
    """SanityChecker's matrix dump (common.hpp:377-386): dense for a small
    host MatrixCSR, a one-line CSR summary otherwise."""
    out = sys.stderr if out is None else out
    if A.n_rows <= limit and A.n_cols <= limit:
        print(f"{name} ({A.n_rows}x{A.n_cols}, nnz={A.nnz}):", file=out)
        for row in A.to_dense():
            print("  [" + " ".join(f"{x:9.4g}" for x in row) + "]", file=out)
    else:
        print(f"{name}: {A.n_rows}x{A.n_cols} CSR, nnz={A.nnz}, "
              f"row_nnz min/max={int(A.row_nnz().min())}/"
              f"{int(A.row_nnz().max())}", file=out)
