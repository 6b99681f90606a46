"""Approximate triangular solves by Jacobi-Richardson ("two-stage" GS).

The reference's two_stage_gauss_seidel (kernels.hpp:312-333), as the JAX
package's ops/trisolve.two_stage_solve: pure SpMV chains over a strict
triangle.  The exact level-scheduled `trisolve` of the host-CSR path
arrives with ROADMAP Queue 1 slice 5.
"""
from __future__ import annotations

import torch

from .spmv import spmv


def two_stage_solve(T_strict, D_inv: torch.Tensor, y: torch.Tensor,
                    inner_iters: int) -> torch.Tensor:
    """work_0 = D⁻¹y;  work_k = −D⁻¹(T·work_{k−1});  out = Σ_k work_k,
    for k = 1..inner_iters."""
    work = D_inv * y
    out = work
    for _ in range(inner_iters):
        work = -D_inv * spmv(T_strict, work)
        out = out + work
    return out
