"""Matrix reordering on the host: the NumPy branch of the JAX package's
permute.py.  perm[new] = old; the solve runs in the permuted ordering and
x* is mapped back (solvers/base.finalize_x).

* ``none``               — identity;
* ``bfs`` / ``rcm``      — breadth-first order / reverse Cuthill-McKee
                           (degree-sorted frontiers, reversed);
* ``color`` / ``color_bal`` — greedy / balanced greedy colouring, rows
                           sorted by colour.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .matrix import MatrixCSR

PERM_MODES = ("none", "bfs", "rcm", "color", "color_bal")


def _bfs_order(A: MatrixCSR, sort_by_degree: bool) -> np.ndarray:
    """BFS over all components, seeds in natural order."""
    n = A.n_rows
    row_ptr, col = A.row_ptr, A.col
    seen = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int32)
    pos = 0
    deg = A.row_nnz()
    for start in range(n):
        if seen[start]:
            continue
        seen[start] = True
        order[pos] = start
        pos += 1
        head = pos - 1
        while head < pos:
            u = order[head]
            head += 1
            nbrs = col[row_ptr[u]:row_ptr[u + 1]]
            nbrs = np.unique(nbrs[~seen[nbrs]])
            if sort_by_degree and nbrs.size > 1:
                nbrs = nbrs[np.argsort(deg[nbrs], kind="stable")]
            seen[nbrs] = True
            order[pos:pos + nbrs.size] = nbrs
            pos += nbrs.size
    return order


def compute_permutation(A: MatrixCSR,
                        mode: str) -> Tuple[np.ndarray, np.ndarray]:
    """(perm, inv_perm) for the given mode; perm[new] = old."""
    if mode not in PERM_MODES:
        raise ValueError(f"unknown perm_mode: {mode!r} (choose from "
                         f"{PERM_MODES})")
    n = A.n_rows
    if mode == "none":
        perm = np.arange(n, dtype=np.int32)
        return perm, perm.copy()
    if mode in ("color", "color_bal"):
        from .coloring import colors_to_perm, greedy_coloring
        return colors_to_perm(greedy_coloring(A,
                                              balanced=(mode == "color_bal")))
    perm = _bfs_order(A, sort_by_degree=(mode == "rcm"))
    if mode == "rcm":
        perm = perm[::-1].copy()
    inv = np.empty(n, dtype=np.int32)
    inv[perm] = np.arange(n, dtype=np.int32)
    return perm, inv


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
