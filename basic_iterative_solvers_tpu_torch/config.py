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


def serves_vectors(mat_dtype: torch.dtype, vec_dtype: torch.dtype) -> bool:
    """Can operator data stored in `mat_dtype` multiply vectors of
    `vec_dtype`?  The same dtype, or bfloat16 data beside float32 or
    float64 vectors (the JAX package's matrix_dtype: each product promotes
    to the vector dtype)."""
    return vec_dtype == mat_dtype or (
        mat_dtype == torch.bfloat16
        and vec_dtype in (torch.float32, torch.float64))


def kernel_suffix(vec_dtype: torch.dtype, mat_dtype: torch.dtype) -> str:
    """The suffix of a kernel entry point in csrc/: "f32" or "f64" for the
    vector dtype, then "_bf16" where the matrix data is bfloat16.  Raises
    for a pair no kernel takes."""
    names = {torch.float32: "f32", torch.float64: "f64"}
    if vec_dtype not in names or mat_dtype not in (vec_dtype,
                                                   torch.bfloat16):
        raise TypeError(f"no kernel takes {vec_dtype} vectors with "
                        f"{mat_dtype} matrix data")
    return names[vec_dtype] + ("_bf16" if mat_dtype == torch.bfloat16
                               else "")


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
    #: "on" sends the coloured GS family on a stencil to the masked
    #: sweeps, as the JAX package's planar vectors do (the port's vectors
    #: are always flat)
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


@dataclasses.dataclass
class Args:
    """The parsed command line (the reference's Args, common.hpp:105-111),
    with the JAX package's fields (basic_iterative_solvers_tpu/config.py:
    246-300).  `cli.parse_cli` is the operational parser; this dataclass is
    the programmatic equivalent for embedding callers.  "auto" dtype and
    harness resolve as the CLI resolves them: float32 and the fused
    harness on a card, float64 and the host harness on the CPU."""

    matrix_source: str = ""
    method: SolverType = SolverType.CONJUGATE_GRADIENT
    preconditioner: PrecondType = PrecondType.NONE
    restart_length: int = 10
    num_scale: bool = False
    perm_mode: str = "none"
    gs_mode: str = "auto"
    dtype: str = "auto"               # auto: float32 on a card, else float64
    matrix_dtype: Optional[str] = None
    harness: str = "auto"             # auto: fused on a card, else host
    matrix_format: str = "auto"
    orthog_mode: str = "mgs"
    gmres_basis_dtype: Optional[str] = None
    cg_flavor: str = "classic"
    cg_rr_period: int = 25
    cg_rr_theta: float = 0.03

    def to_config(self, dtype=None, device="cuda") -> SolverConfig:
        """The SolverConfig of these arguments for a solve on `device`
        (the card unless the caller asks for the CPU; "auto" reads it)."""
        on_card = torch.device(device).type == "cuda"
        if dtype is None:
            dtype = ((torch.float32 if on_card else torch.float64)
                     if self.dtype == "auto" else torch_dtype(self.dtype))
        harness = self.harness
        if harness == "auto":
            harness = "fused" if on_card else "host"
        return SolverConfig(
            method=self.method, preconditioner=self.preconditioner,
            restart_length=self.restart_length, num_scale=self.num_scale,
            perm_mode=self.perm_mode, gs_mode=self.gs_mode, dtype=dtype,
            matrix_dtype=self.matrix_dtype, harness=harness,
            matrix_format=self.matrix_format, orthog_mode=self.orthog_mode,
            gmres_basis_dtype=self.gmres_basis_dtype,
            cg_flavor=self.cg_flavor, cg_rr_period=self.cg_rr_period,
            cg_rr_theta=self.cg_rr_theta)
