"""Sparse triangular solves in the natural ordering.

* **Level-scheduled exact solve** (`trisolve`) — the host computes
  dependency levels (factor.level_sets_*), packs each level's rows into
  fixed-width padded ELL blocks, and the device solves level by level: a
  gather of x at the level's column pattern, a row sum, a scatter.  The
  reference's recurrence x[r] = (b[r] − Σ T[r,:]·x)·D⁻¹[r], evaluated in
  parallel within a level.  The JAX package runs it as a `lax.scan` in XLA
  (no Pallas kernel), so its port is a plain torch loop over the levels.
* **Two-stage Richardson** (`two_stage_solve`) — out = Σ_k (−D⁻¹T)ᵏ D⁻¹y,
  pure SpMV chains over any operator (the reference's
  two_stage_gauss_seidel, kernels.hpp:312-333).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import torch_dtype
from ..matrix import MatrixCSR
from .spmv import spmv


@dataclasses.dataclass
class TriSolveLevels:
    """Level-packed strictly triangular system and its diagonal inverse.

    rows: (n_levels, W) int64, the row of each slot (n_rows for a pad);
    cols: (n_levels, W, K) int64, the column pattern (pad col 0, val 0);
    vals: (n_levels, W, K); dinv: (n_levels, W), 1/D per slot (0 at pads).
    """

    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    dinv: torch.Tensor
    n_rows: int
    n_levels: int
    max_width: int

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype


def build_trisolve(T_strict: MatrixCSR, D: np.ndarray, *, upper: bool,
                   dtype=torch.float32, levels: Optional[np.ndarray] = None,
                   device="cuda") -> TriSolveLevels:
    """Pack a strictly triangular CSR and its diagonal into level-scheduled
    form on `device`."""
    from ..factor import level_sets_lower, level_sets_upper
    from ..stencil_op import resolve_device
    device = resolve_device(device)
    n = T_strict.n_rows
    if levels is None:
        levels = (level_sets_upper(T_strict) if upper
                  else level_sets_lower(T_strict))
    n_levels = int(levels.max()) + 1 if n else 0
    order = np.argsort(levels, kind="stable").astype(np.int64)
    counts = np.bincount(levels, minlength=n_levels)
    W = max(1, int(counts.max()) if n_levels else 0)
    row_nnz = T_strict.row_nnz()
    K = max(1, int(row_nnz.max()) if n else 0)
    rows = np.full((n_levels, W), n, dtype=np.int64)
    cols = np.zeros((n_levels, W, K), dtype=np.int64)
    vals = np.zeros((n_levels, W, K), dtype=np.float64)
    dinv = np.zeros((n_levels, W), dtype=np.float64)
    lvl_of = levels[order]
    slot = np.arange(n) - np.concatenate([[0], np.cumsum(counts)])[lvl_of]
    rows[lvl_of, slot] = order
    dinv[lvl_of, slot] = 1.0 / D[order]
    lens = row_nnz[order]
    excl = np.concatenate([[0], np.cumsum(lens)])[:-1]
    lane = np.arange(int(lens.sum()), dtype=np.int64) - np.repeat(excl, lens)
    src = np.repeat(T_strict.row_ptr[order], lens) + lane
    lv, sl = np.repeat(lvl_of, lens), np.repeat(slot, lens)
    cols[lv, sl, lane] = T_strict.col[src]
    vals[lv, sl, lane] = T_strict.val[src]
    dtype = torch_dtype(dtype)
    # values and 1/D rounded from float64 once, as the JAX package casts
    # them; the index arrays are int64 for torch's gathers
    as_t = lambda a, dt: torch.from_numpy(a).to(dtype=dt,  # noqa: E731
                                                device=device)
    return TriSolveLevels(rows=as_t(rows, torch.int64),
                          cols=as_t(cols, torch.int64),
                          vals=as_t(vals, dtype), dinv=as_t(dinv, dtype),
                          n_rows=n, n_levels=n_levels, max_width=W)


def trisolve(ts: TriSolveLevels, b: torch.Tensor) -> torch.Tensor:
    """x with (T_strict + D) x = b, level by level: per level the gather
    x[cols], the row sum of vals·x, then x[rows] = (b[rows] − s)·dinv,
    pad slots written to a discarded sentinel entry (the reference's
    native_sptrsv / native_bsptrsv arithmetic, kernels.hpp:54-117).
    TIME'd as "sptrsv" in kernel-timing mode (kernels.hpp:56)."""
    from ..utils.ktimers import ktime
    return ktime("sptrsv", _trisolve, ts, b)


def _trisolve(ts: TriSolveLevels, b: torch.Tensor) -> torch.Tensor:
    n = ts.n_rows
    bp = torch.nn.functional.pad(b, (0, 1))
    x = torch.zeros(n + 1, dtype=b.dtype, device=b.device)
    W, K = ts.cols.shape[1:]
    cols = ts.cols.view(ts.n_levels, W * K)
    for lv in range(ts.n_levels):
        rows = ts.rows[lv]
        s = torch.sum(ts.vals[lv] * x.index_select(0, cols[lv]).view(W, K),
                      dim=1)
        x.index_copy_(0, rows, (bp.index_select(0, rows) - s) * ts.dinv[lv])
    return x[:n]


def two_stage_solve(T_strict, D_inv, y: torch.Tensor,
                    inner_iters: int) -> torch.Tensor:
    """work_0 = D⁻¹y;  work_k = −D⁻¹(T·work_{k−1});  out = Σ_k work_k,
    for k = 1..inner_iters."""
    work = D_inv * y
    out = work
    for _ in range(inner_iters):
        work = -D_inv * spmv(T_strict, work)
        out = out + work
    return out
