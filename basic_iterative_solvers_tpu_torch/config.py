"""Runtime configuration.

`SolverConfig` has the field names and defaults of the JAX package's
(basic_iterative_solvers_tpu/config.py), so one set of keyword arguments
configures either package.  Defaults replicate the reference's CMake cache
defaults (CMakeLists.txt:20-29).  Fields of features not ported yet are
carried for the slices that port them (ROADMAP.md, Queue 1) and are
rejected where a path would silently ignore them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from .types import PrecondType, SolverType


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype/type or a name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if str(dtype) in ("bfloat16", "bf16"):
        return torch.bfloat16
    return getattr(torch, np.dtype(dtype).name)


@dataclasses.dataclass
class SolverConfig:
    """All solver knobs (the reference's CMakeLists.txt:20-29 and
    common.hpp:105-111)."""

    method: SolverType = SolverType.CONJUGATE_GRADIENT
    preconditioner: PrecondType = PrecondType.NONE

    max_iters: int = 1000
    tolerance: float = 1e-14
    restart_length: int = 10
    res_check_len: int = 1            # sample the residual every k iterations
    precond_outer_iters: int = 1
    precond_inner_iters: int = 0
    init_x_val: float = 0.1           # INIT_X_VAL
    b_val: float = 1.0                # B_VAL
    ilu0_pivot_tolerance: float = 1e-8
    ilu0_pivot_replacement: float = 1e-4

    num_scale: bool = False
    perm_mode: str = "none"
    gs_mode: str = "auto"
    color_spec: Optional[object] = None

    #: vector dtype; float64 is reference parity, float32 the perf mode
    dtype: Any = torch.float64
    #: operator storage dtype (None = `dtype`)
    matrix_dtype: Optional[str] = None
    matrix_format: str = "auto"
    dia_max_diags: int = 96
    dia_min_fill: float = 0.25
    use_pallas: bool = True
    auto_rcm: bool = True
    planar_vectors: str = "auto"
    #: "host": one host read of the residual per iteration (the reference's
    #: harness); "fused": the device-resident loop (solvers/fused.py)
    harness: str = "host"
    cg_flavor: str = "classic"
    cg_rr_period: int = 25
    cg_rr_theta: float = 0.03
    refine_outer: int = 0
    refine_inner_tol: float = 1e-6
    #: fixed-iteration runs (tolerance=0): non-finite CG scalars of the
    #: preconditioned branch stall to 0 instead of poisoning the state
    breakdown_stall: bool = False
    cheby_degree: int = 4
    cheby_eig_ratio: float = 30.0
    cheby_power_iters: int = 20
    mg_levels: int = 0
    mg_transfer: str = "linear"
    mg_coarse_op: str = "auto"
    mg_smooth_degree: int = 2
    mg_coarse_degree: int = 16
    mg_smooth_ratio: float = 4.0
    mg_coarse_ratio: float = 200.0
    orthog_mode: str = "mgs"
    gmres_basis_dtype: Optional[str] = None
    gmres_basis_layout: str = "auto"
    kernel_timers: bool = False
    debug_checks: bool = False

    def spec_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    def mat_dtype(self) -> torch.dtype:
        """Storage dtype for operator data (defaults to spec_dtype)."""
        if self.matrix_dtype is None:
            return self.spec_dtype()
        return torch_dtype(self.matrix_dtype)
