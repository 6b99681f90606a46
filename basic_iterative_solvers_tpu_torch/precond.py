"""Preconditioner engine: z ← M⁻¹ y (the reference's apply_preconditioner,
kernels.hpp:336-414), with the JAX package's two set-up paths:
`setup_preconditioner` on host CSR (precond.py:102-399) and
`setup_preconditioner_dia` on a device operator, stencil or DIA
(precond.py:455-598).

Type → action:
  none   : z = y
  jacobi : z = y / D
  gs     : z = (L + D)⁻¹ y                 [exact]
  bgs    : z = (U + D)⁻¹ y
  sgs    : z = (U + D)⁻¹ D (L + D)⁻¹ y
  2st    : Richardson approximation of (L + D)⁻¹ (kernels.hpp:312-333)
  s2st   : Richardson (L), multiply by D, Richardson (U)
  ilu0   : z = U⁻¹ L⁻¹ y (unit-diagonal L)
  cheby  : z = p(D⁻¹A) D⁻¹ y, a Chebyshev semi-iteration from zero over
           [λmax/ratio, λmax], λmax from a power iteration (+10%)
  mg     : one geometric-multigrid V-cycle (mg.py; stencils only)

The exact solves (gs, bgs, sgs, ilu0) run in one of three forms:
* natural order (`gs_mode` "levels", the host path's default): the
  level-scheduled scans of ops/trisolve.py, the reference's ordering;
* coloured, blocked: the superblock solves (on stencils, or built from
  host CSR under a grid colouring) or the rank-space solves of host CSR
  under a mod colouring, or a grid one the superblock form refuses
  (ops/block_trisolve.py);
* coloured, masked sweeps (coloring.py): any operator and colouring.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from .config import SolverConfig
from .matrix import MatrixCSR
from .ops.blas1 import is_dtensor, is_mesh_vector
from .stencil_op import DeviceStencil, stencil_diag_vec, stencil_split
from .types import PrecondType

#: preconditioner types a multicolour ordering serves (exact sweeps in the
#: colour-sorted ordering; coloring.py)
COLORED_PRECONDS = (PrecondType.GAUSS_SEIDEL,
                    PrecondType.BACKWARDS_GAUSS_SEIDEL,
                    PrecondType.SYMMETRIC_GAUSS_SEIDEL)

#: types whose set-up needs no triangular solve at all
DEVICE_NATIVE_PRECONDS = (PrecondType.NONE, PrecondType.JACOBI,
                          PrecondType.TWO_STAGE_GS,
                          PrecondType.SYMMETRIC_TWO_STAGE_GS,
                          PrecondType.CHEBYSHEV, PrecondType.MULTIGRID)


def resolve_gs_mode(config: SolverConfig, device_native: bool) -> str:
    """"auto" → "levels" on the host-CSR path (reference-order parity),
    "colored" on the device-native path."""
    if config.gs_mode != "auto":
        return config.gs_mode
    return "colored" if device_native else "levels"


@dataclasses.dataclass
class Preconditioner:
    ptype: PrecondType
    #: the whole action is composed this many times (at least once)
    outer_iters: int = 1
    #: Richardson sweeps of the two-stage types
    inner_iters: int = 0
    A_D: Optional[torch.Tensor] = None         # diagonal, vector dtype
    A_D_inv: Optional[torch.Tensor] = None
    #: natural-order level-scheduled solves (ops/trisolve.TriSolveLevels)
    L_solve: Any = None
    U_solve: Any = None
    L_strict_dev: Any = None                   # strict parts (2st, s2st,
    U_strict_dev: Any = None                   # masked coloured ILU(0))
    #: masked colour sweeps: the full operator and its colouring
    A_full_dev: Any = None
    color_spec: Any = None
    color_arr: Optional[torch.Tensor] = None   # greedy colour ids
    n_colors: int = 0
    #: blocked coloured solves (ops/block_trisolve): SuperBlockTriSolve
    #: (const, factor-table or plane mode) or BlockedTriSolve (rank space)
    L_block: Any = None
    U_block: Any = None
    #: Chebyshev: λmax of D⁻¹A (0-d, power iteration with headroom), the
    #: degree and the interval's eigenvalue ratio
    cheby_lmax: Optional[torch.Tensor] = None
    cheby_degree: int = 0
    cheby_ratio: float = 30.0
    #: multigrid: the level tuple (mg.MGLevel) and the V-cycle's shape
    mg_data: Any = None
    mg_smooth_degree: int = 0
    mg_coarse_degree: int = 0
    mg_ratio: float = 4.0
    mg_coarse_ratio: float = 200.0
    mg_transfer: str = "linear"
    _cheby_schedules: dict = dataclasses.field(default_factory=dict,
                                               repr=False, compare=False)


def _diagonal(A, dtype) -> torch.Tensor:
    # the diagonal takes part in vector arithmetic: keep it at the vector
    # dtype whatever the operator's storage dtype
    from .dia import dia_diag
    D = (stencil_diag_vec(A) if isinstance(A, DeviceStencil)
         else dia_diag(A)).to(dtype)
    if bool((D == 0).any()):
        raise ValueError("zero on the matrix diagonal")
    return D


# ---------------------------------------------------------------------------
# Device-native set-up (stencil or DIA)
# ---------------------------------------------------------------------------

def setup_preconditioner_dia(A, config: SolverConfig) -> Preconditioner:
    """Build M for `config.preconditioner` on a device operator (DeviceStencil
    or DeviceDIA): diagonals and strict parts are structural, exact GS
    solves run coloured (the superblock solves where the stencil allows,
    else masked sweeps), exact ILU(0) needs a constant-coefficient stencil
    under a grid colouring."""
    from .device_matrix import DeviceDIA
    pt = config.preconditioner
    kw = dict(ptype=pt, outer_iters=config.precond_outer_iters,
              inner_iters=config.precond_inner_iters)
    if pt == PrecondType.NONE:
        return Preconditioner(**kw)
    if not isinstance(A, (DeviceStencil, DeviceDIA)):
        raise TypeError(f"unsupported operator type {type(A).__name__}")
    dtype = config.spec_dtype()
    if pt == PrecondType.ILU0:
        return Preconditioner(**kw, **_ilu0_blocks(A, config, dtype))
    if pt not in DEVICE_NATIVE_PRECONDS and not (
            pt in COLORED_PRECONDS
            and resolve_gs_mode(config, device_native=True) == "colored"):
        raise ValueError(
            f"preconditioner {pt} needs exact triangular solves in the "
            "natural ordering (gs_mode='levels'); build through the host "
            "CSR path (preprocessing) instead")
    if pt == PrecondType.MULTIGRID:
        from .mg import build_mg_hierarchy
        levels = build_mg_hierarchy(A, config)
        return Preconditioner(
            A_D=(1.0 / levels[0].D_inv).to(dtype), A_D_inv=levels[0].D_inv,
            mg_data=levels, mg_smooth_degree=config.mg_smooth_degree,
            mg_coarse_degree=config.mg_coarse_degree,
            mg_ratio=config.mg_smooth_ratio,
            mg_coarse_ratio=config.mg_coarse_ratio,
            mg_transfer=config.mg_transfer, **kw)
    if pt == PrecondType.CHEBYSHEV:
        D = _diagonal(A, dtype)
        D_inv = (1.0 / D).to(dtype)
        return _cheby(A, D, D_inv, config, kw)
    if pt in COLORED_PRECONDS:
        from .coloring import spec_for_device
        from .ops.block_trisolve import (BlockIneligibleError,
                                         build_superblock_gs_pair_stencil)
        spec = spec_for_device(A)
        D = _diagonal(A, dtype)
        M = Preconditioner(A_D=D, A_D_inv=(1.0 / D).to(dtype),
                           color_spec=spec, n_colors=spec.n_colors, **kw)
        # planar_vectors="on" keeps the masked sweeps, as in the JAX
        # package (its planar operators take no superblock route)
        if (isinstance(A, DeviceStencil) and spec.kind == "grid"
                and config.planar_vectors != "on"):
            try:
                L_blk, U_blk = build_superblock_gs_pair_stencil(
                    A, spec, dtype=dtype,
                    need_d=pt == PrecondType.SYMMETRIC_GAUSS_SEIDEL)
                M.L_block = None if pt == PrecondType.BACKWARDS_GAUSS_SEIDEL \
                    else L_blk
                M.U_block = None if pt == PrecondType.GAUSS_SEIDEL else U_blk
                return M
            except BlockIneligibleError:
                pass        # masked sweeps below
        M.A_full_dev = A
        return M
    if pt == PrecondType.JACOBI:
        D = _diagonal(A, dtype)
        return Preconditioner(A_D=D, A_D_inv=(1.0 / D).to(dtype), **kw)
    if isinstance(A, DeviceStencil):
        L_strict, U_strict, A_D, A_D_inv = stencil_split(A)
    else:
        from .dia import dia_split
        L_strict, U_strict, A_D, A_D_inv = dia_split(A)
    if A_D.dtype != dtype:
        A_D = A_D.to(dtype)
        A_D_inv = (1.0 / A_D).to(dtype)
    if pt == PrecondType.TWO_STAGE_GS:
        return Preconditioner(A_D=A_D, A_D_inv=A_D_inv,
                              L_strict_dev=L_strict, **kw)
    return Preconditioner(A_D=A_D, A_D_inv=A_D_inv,  # SYMMETRIC_TWO_STAGE_GS
                          L_strict_dev=L_strict, U_strict_dev=U_strict, **kw)


def ilu0_device_eligible(A, config: SolverConfig) -> bool:
    """Does exact ILU(0) run on the device path for A: a constant-
    coefficient stencil under a grid colouring, gs_mode "auto" or
    "colored"?"""
    from .coloring import spec_for_device
    from .ops.block_trisolve import stencil_ilu0_eligible
    return (isinstance(A, DeviceStencil)
            and resolve_gs_mode(config, device_native=True) == "colored"
            and stencil_ilu0_eligible(A, spec_for_device(A)))


def _ilu0_blocks(A, config: SolverConfig, dtype) -> dict:
    """The factor-table (L, U) pair of exact coloured ILU(0) (the JAX
    package's setup_preconditioner_dia, precond.py:475-507)."""
    from .coloring import spec_for_device
    from .ops.block_trisolve import build_superblock_ilu0_pair_stencil
    if not ilu0_device_eligible(A, config):
        raise ValueError(
            f"preconditioner {PrecondType.ILU0} on the device-native path "
            "needs a constant-coefficient stencil under a grid colouring; "
            "use the host CSR path (preprocessing) otherwise")
    spec = spec_for_device(A)
    L, U = build_superblock_ilu0_pair_stencil(
        A, spec, dtype=dtype, pivot_tolerance=config.ilu0_pivot_tolerance,
        pivot_replacement=config.ilu0_pivot_replacement)
    return dict(L_block=L, U_block=U, color_spec=spec,
                n_colors=spec.n_colors)


# ---------------------------------------------------------------------------
# Host-CSR set-up
# ---------------------------------------------------------------------------

def _colors_for_setup(A: MatrixCSR, config: SolverConfig):
    """(colours, spec): the spec's structural colouring when the config
    carries a grid or mod spec and no reordering was applied (the blocked
    solves), else greedy colours and None (masked sweeps)."""
    from .coloring import greedy_coloring, spec_colors_np
    spec = config.color_spec
    if (spec is not None and config.perm_mode == "none"
            and spec.kind in ("grid", "mod")):
        try:
            return spec_colors_np(spec, A.n_rows), spec
        except ValueError:
            pass
    return greedy_coloring(A), None


def _masked_ilu0(A: MatrixCSR, colors, rows_o, cols_o, lu_vals, U_D, kw,
                 config, dtype, device) -> Preconditioner:
    """Coloured ILU(0) as masked sweeps: the colour-strict factors as
    device matrices, U's diagonal as A_D."""
    from .device_matrix import from_csr
    from .matrix import MatrixCOO, convert_coo_to_csr
    ci, cj = colors[rows_o], colors[cols_o]

    def dev(mask):
        return from_csr(convert_coo_to_csr(MatrixCOO.from_arrays(
            rows_o[mask], cols_o[mask], lu_vals[mask], n_rows=A.n_rows,
            n_cols=A.n_cols)), config.mat_dtype(), config.matrix_format,
            config.dia_max_diags, config.dia_min_fill, device=device)

    return Preconditioner(
        A_D=torch.from_numpy(U_D).to(dtype=dtype, device=device),
        A_D_inv=torch.from_numpy(1.0 / U_D).to(dtype=dtype, device=device),
        L_strict_dev=dev(cj < ci), U_strict_dev=dev(cj > ci),
        color_arr=torch.from_numpy(colors).to(device),
        n_colors=int(colors.max()) + 1, **kw)


def _colored_ilu0(A: MatrixCSR, config: SolverConfig, kw, dtype, device,
                  A_dev) -> Preconditioner:
    """Exact coloured ILU(0) on host CSR (precond.py:145-267), factored in
    the colour-sorted ordering.  Under a grid colouring the
    translation-table pair where A_dev is a stencil, else, with the native
    host library, the pair packed straight off the permuted CSR
    (`_ilu0_pair_from_csr`); then the triplet pipeline (superblock, or
    rank-space as a pair, under a grid or mod colouring); an improper
    colouring recolours greedily, and greedy colours take masked sweeps."""
    from .factor import factor_ilu0_colored_triplets
    from .ops.block_trisolve import (BlockIneligibleError,
                                     ImproperColoringError,
                                     build_best_trisolve_pair,
                                     build_superblock_ilu0_pair_stencil)
    tol, repl = config.ilu0_pivot_tolerance, config.ilu0_pivot_replacement
    colors, spec = _colors_for_setup(A, config)
    done = lambda L, U: Preconditioner(  # noqa: E731
        L_block=L, U_block=U, color_spec=spec, n_colors=spec.n_colors, **kw)
    from .parallel.mesh_ops import unwrap
    op = unwrap(A_dev)
    if spec is not None and spec.kind == "grid" and isinstance(
            op, DeviceStencil):
        try:
            return done(*build_superblock_ilu0_pair_stencil(
                op, spec, dtype=dtype, pivot_tolerance=tol,
                pivot_replacement=repl))
        except BlockIneligibleError:
            pass
    if spec is not None and spec.kind == "grid":
        try:
            return done(*_ilu0_pair_from_csr(A, colors, spec, tol, repl,
                                             dtype, device))
        except BlockIneligibleError:    # an improper colouring too
            pass
    factor = lambda c: factor_ilu0_colored_triplets(  # noqa: E731
        A, c, pivot_tolerance=tol, pivot_replacement=repl)
    rows_o, cols_o, lu_vals, U_D = factor(colors)
    if spec is not None:
        try:
            return done(*build_best_trisolve_pair(
                (rows_o, cols_o, lu_vals, A.n_rows), None, U_D, colors, spec,
                dtype=dtype, device=device))
        except ImproperColoringError:
            from .coloring import greedy_coloring
            colors = greedy_coloring(A)
            rows_o, cols_o, lu_vals, U_D = factor(colors)
        except BlockIneligibleError:
            pass
    return _masked_ilu0(A, colors, rows_o, cols_o, lu_vals, U_D, kw, config,
                        dtype, device)


def _ilu0_pair_from_csr(A: MatrixCSR, colors, spec, tol, repl, dtype,
                        device):
    """The (L, U) superblock pair of coloured ILU(0) packed straight off
    the colour-permuted CSR (JAX precond.py:176-215): one native sweep
    permutes and factors, two more analyse and scatter both triangles.
    BlockIneligibleError, before any factoring, where the host library is
    off, A is not square or has 2**31 rows, or the colours are not the
    spec's."""
    from . import _native
    from .coloring import colors_to_perm
    from .ops.block_trisolve import (BlockIneligibleError,
                                     build_superblock_ilu0_pair,
                                     spec_colors_valid)
    if (not _native.available() or A.n_rows >= 2**31
            or A.n_rows != A.n_cols):
        raise BlockIneligibleError("native host library switched off, or "
                                   "A not square")
    if not spec_colors_valid(colors, spec, A.n_rows):
        raise BlockIneligibleError("colours other than the spec's")
    perm, inv = colors_to_perm(colors)
    Ap, lu_p = _native.permute_factor_csr(A, perm, inv, tol, repl)
    L, U, _ = build_superblock_ilu0_pair(Ap, lu_p, perm, spec, dtype=dtype,
                                         device=device)
    return L, U


def _gs_pair_from_csr(A: MatrixCSR, D, colors, spec, pt, dtype, device):
    """(L, U) of the GS family packed straight off the CSR (JAX
    precond.py:283-305), the triangle GS or BGS does not run as None; None
    where the path does not apply (no grid spec or not its colours, the
    host library off, a structural refusal or an improper colouring: the
    builders below then decide)."""
    from .ops.block_trisolve import (BlockIneligibleError,
                                     build_superblock_gs_pair_from_csr,
                                     spec_colors_valid)
    if spec.kind != "grid" or not spec_colors_valid(colors, spec, A.n_rows):
        return None
    try:
        L, U = build_superblock_gs_pair_from_csr(
            A, D, spec, dtype=dtype,
            need_d=pt == PrecondType.SYMMETRIC_GAUSS_SEIDEL, device=device)
    except BlockIneligibleError:        # an improper colouring too
        return None
    if pt == PrecondType.GAUSS_SEIDEL:
        return L, None
    if pt == PrecondType.BACKWARDS_GAUSS_SEIDEL:
        return None, U
    return L, U


def _colored_gs(A: MatrixCSR, config: SolverConfig, factors, kw, dtype,
                device, A_dev) -> Preconditioner:
    """The coloured GS family on host CSR (precond.py:268-337): under a
    grid spec's own colouring the superblock pair packed straight off the
    CSR by the native host library (one analysis and one scatter of both
    triangles; GS and BGS keep the one they need), else the best layout
    (superblock, or rank-space, under a grid or mod colouring) of the
    triangles it needs, one layout for SGS's pair; masked sweeps with the
    full device operator under greedy colours."""
    from .factor import peel_diag
    from .ops.block_trisolve import (BlockIneligibleError,
                                     ImproperColoringError,
                                     build_best_trisolve,
                                     build_best_trisolve_pair)
    pt = config.preconditioner
    A_D_np, A_D_inv_np = ((factors.A_D, factors.A_D_inv)
                          if factors is not None else peel_diag(A))
    to_dev = lambda a: torch.from_numpy(a).to(  # noqa: E731
        dtype=dtype, device=device)
    A_D, A_D_inv = to_dev(A_D_np), to_dev(A_D_inv_np)
    colors, spec = _colors_for_setup(A, config)
    if spec is not None:
        try:
            L = U = None
            pair = _gs_pair_from_csr(A, A_D_np, colors, spec, pt, dtype,
                                     device)
            if pair is not None:
                L, U = pair
            elif pt == PrecondType.SYMMETRIC_GAUSS_SEIDEL:
                L, U = build_best_trisolve_pair(
                    A, A_D_np, A_D_np, colors, spec, dtype=dtype,
                    need_d=True, device=device)
            else:
                B = build_best_trisolve(
                    A, A_D_np, colors, spec,
                    upper=pt == PrecondType.BACKWARDS_GAUSS_SEIDEL,
                    dtype=dtype, device=device)
                if pt == PrecondType.GAUSS_SEIDEL:
                    L = B
                else:
                    U = B
            return Preconditioner(A_D=A_D, A_D_inv=A_D_inv, L_block=L,
                                  U_block=U, color_spec=spec,
                                  n_colors=spec.n_colors, **kw)
        except ImproperColoringError:
            from .coloring import greedy_coloring
            colors = greedy_coloring(A)
        except BlockIneligibleError:
            pass
    if A_dev is None:
        from .device_matrix import from_csr
        A_dev = from_csr(A, config.mat_dtype(), config.matrix_format,
                         config.dia_max_diags, config.dia_min_fill,
                         device=device)
    return Preconditioner(A_D=A_D, A_D_inv=A_D_inv, A_full_dev=A_dev,
                          color_arr=torch.from_numpy(colors).to(device),
                          n_colors=int(colors.max()) + 1, **kw)


def setup_preconditioner(A, config: SolverConfig, factors=None, A_dev=None,
                         *, device="cuda") -> Preconditioner:
    """Build M for `config.preconditioner`.  A host `MatrixCSR` takes the
    host path (the JAX package's setup_preconditioner): `factors` may be
    shared with the solver set-up, `A_dev` is the device operator of the
    same matrix (reused by the masked sweeps), and everything lands on
    `device`.  A device operator takes setup_preconditioner_dia."""
    if not isinstance(A, MatrixCSR):
        return setup_preconditioner_dia(A, config)
    from .device_matrix import from_csr
    from .factor import factor_LU
    from .ops.trisolve import build_trisolve
    from .stencil_op import resolve_device
    device = resolve_device(device)
    pt = config.preconditioner
    dtype = config.spec_dtype()
    kw = dict(ptype=pt, outer_iters=config.precond_outer_iters,
              inner_iters=config.precond_inner_iters)
    if pt == PrecondType.NONE:
        return Preconditioner(**kw)
    if pt == PrecondType.MULTIGRID:
        raise ValueError(
            "multigrid requires the matrix-free stencil operator (a "
            "generator source with matrix_format='stencil'); explicit CSR "
            "matrices take the host path — use '-p cheby' or '-p ilu0' "
            "there")
    colored = resolve_gs_mode(config, device_native=False) == "colored"
    if pt == PrecondType.ILU0 and colored:
        return _colored_ilu0(A, config, kw, dtype, device, A_dev)
    if pt in COLORED_PRECONDS and colored:
        return _colored_gs(A, config, factors, kw, dtype, device, A_dev)
    if pt == PrecondType.CHEBYSHEV:
        from .factor import peel_diag
        A_D_np, A_D_inv_np = peel_diag(A)
        if A_dev is None:
            A_dev = from_csr(A, config.mat_dtype(), config.matrix_format,
                             config.dia_max_diags, config.dia_min_fill,
                             device=device)
        to_dev = lambda a: torch.from_numpy(a).to(  # noqa: E731
            dtype=dtype, device=device)
        return _cheby(A_dev, to_dev(A_D_np), to_dev(A_D_inv_np), config, kw)
    if factors is None:
        factors = factor_LU(A, ilu0=(pt == PrecondType.ILU0),
                            pivot_tolerance=config.ilu0_pivot_tolerance,
                            pivot_replacement=config.ilu0_pivot_replacement)
    to_dev = lambda a: torch.from_numpy(a).to(  # noqa: E731
        dtype=dtype, device=device)
    M = Preconditioner(A_D=to_dev(factors.A_D),
                       A_D_inv=to_dev(factors.A_D_inv), **kw)
    levels = lambda T, D, upper: build_trisolve(  # noqa: E731
        T, D, upper=upper, dtype=dtype, device=device)
    strict = lambda T: from_csr(  # noqa: E731
        T, config.mat_dtype(), config.matrix_format, config.dia_max_diags,
        config.dia_min_fill, device=device)
    if pt in (PrecondType.GAUSS_SEIDEL, PrecondType.SYMMETRIC_GAUSS_SEIDEL):
        M.L_solve = levels(factors.L_strict, factors.A_D, False)
    if pt in (PrecondType.BACKWARDS_GAUSS_SEIDEL,
              PrecondType.SYMMETRIC_GAUSS_SEIDEL):
        M.U_solve = levels(factors.U_strict, factors.A_D, True)
    if pt in (PrecondType.TWO_STAGE_GS, PrecondType.SYMMETRIC_TWO_STAGE_GS):
        M.L_strict_dev = strict(factors.L_strict)
    if pt == PrecondType.SYMMETRIC_TWO_STAGE_GS:
        M.U_strict_dev = strict(factors.U_strict)
    if pt == PrecondType.ILU0:
        M.L_solve = levels(factors.L_strict, factors.L_D, False)
        M.U_solve = levels(factors.U_strict, factors.U_D, True)
    return M


def _power_lmax(A_dev, A_D_inv: torch.Tensor, n: int, iters: int
                ) -> torch.Tensor:
    """λmax of D⁻¹A by power iteration from the ones vector, +10%
    headroom: the top of the Chebyshev interval, a 0-d tensor."""
    from .ops.spmv import spmv
    v = torch.ones(n, dtype=A_D_inv.dtype, device=A_D_inv.device)
    v = v / torch.sqrt(torch.sum(v * v))
    for _ in range(max(1, iters)):
        w = A_D_inv * spmv(A_dev, v)
        v = w / torch.sqrt(torch.sum(w * w))
    w = A_D_inv * spmv(A_dev, v)
    return 1.1 * torch.sum(v * w) / torch.sum(v * v)


def _cheby(A_dev, D, D_inv, config: SolverConfig, kw) -> Preconditioner:
    lmax = _power_lmax(A_dev, D_inv, A_dev.n_rows, config.cheby_power_iters)
    return Preconditioner(A_D=D, A_D_inv=D_inv, A_full_dev=A_dev,
                          cheby_lmax=lmax, cheby_degree=config.cheby_degree,
                          cheby_ratio=config.cheby_eig_ratio, **kw)


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------

def _cheby_apply(M: Preconditioner, y: torch.Tensor) -> torch.Tensor:
    """z = p(D⁻¹A) D⁻¹ y: the Chebyshev semi-iteration on A z = y from
    z₀ = 0 with Jacobi scaling, `cheby_degree` SpMVs and no reductions."""
    from .mg import cached_schedule, cheby_steps
    return cheby_steps(M.A_full_dev, M.A_D_inv, y, None, cached_schedule(
        M._cheby_schedules, M.cheby_lmax, M.cheby_ratio, M.cheby_degree, y))


def _colored_solve(M: Preconditioner, y: torch.Tensor,
                   reverse: bool) -> torch.Tensor:
    """(L_c+D)⁻¹y or (U_c+D)⁻¹y as a multicolour sweep from zero."""
    from .coloring import colored_sweep
    return colored_sweep(M.A_full_dev, M.A_D_inv, y, None, M.color_spec,
                         M.n_colors, reverse=reverse, color_arr=M.color_arr)


def run_whole(fn, *args):
    """fn(*args) for an apply that the JAX package's mesh modes run
    replicated (superblock and rank-space solves, level scans, the
    multigrid hierarchy): where an argument is a row-sharded DTensor,
    parallel/gspmd.whole gathers it, runs fn whole and keeps the rank's
    rows; where one is a MeshVector and the apply is not itself cut into
    the mesh's shards (a MeshSuperBlockTriSolve takes the MeshVector as it
    is), the vector is gathered to the mesh's first device (Mesh.gather),
    fn runs whole there and its result goes back in the vector's layout
    (Mesh.scatter), both counted; on plain tensors fn itself."""
    if any(is_dtensor(a) for a in args):
        from .parallel.gspmd import whole
        return whole(fn, *args)
    like = next((a for a in args if is_mesh_vector(a)), None)
    if like is not None:
        from .ops.block_trisolve import MeshSuperBlockTriSolve
        if not any(isinstance(a, MeshSuperBlockTriSolve) for a in args):
            mesh = like.mesh
            out = fn(*(mesh.gather(a) if is_mesh_vector(a) else a
                       for a in args))
            return mesh.scatter(out, like.blocks.rows)
    return fn(*args)


def _apply_once(M: Preconditioner, y: torch.Tensor) -> torch.Tensor:
    from .ops.trisolve import trisolve, two_stage_solve
    pt = M.ptype
    if pt == PrecondType.NONE:
        return y
    if pt == PrecondType.JACOBI:
        # reference: elemwise_div_vectors(output, input, A_D), kernels.hpp:357
        return y / M.A_D
    if pt == PrecondType.CHEBYSHEV:
        return _cheby_apply(M, y)
    if pt == PrecondType.MULTIGRID:
        from .mg import mg_vcycle
        return run_whole(mg_vcycle, M.mg_data, y, M.mg_smooth_degree,
                         M.mg_coarse_degree, M.mg_ratio,
                         M.mg_coarse_ratio, M.mg_transfer)
    if M.L_block is not None or M.U_block is not None:
        from .ops.block_trisolve import (blocked_ilu0, blocked_sgs,
                                         blocked_trisolve)
        if pt == PrecondType.ILU0:
            return run_whole(blocked_ilu0, M.L_block, M.U_block, y)
        if pt == PrecondType.GAUSS_SEIDEL:
            return run_whole(blocked_trisolve, M.L_block, y)
        if pt == PrecondType.BACKWARDS_GAUSS_SEIDEL:
            return run_whole(blocked_trisolve, M.U_block, y)
        return run_whole(blocked_sgs, M.L_block, M.U_block, y)
    colored = M.n_colors > 0
    if pt == PrecondType.GAUSS_SEIDEL:
        return (_colored_solve(M, y, reverse=False) if colored
                else run_whole(trisolve, M.L_solve, y))
    if pt == PrecondType.BACKWARDS_GAUSS_SEIDEL:
        return (_colored_solve(M, y, reverse=True) if colored
                else run_whole(trisolve, M.U_solve, y))
    if pt == PrecondType.SYMMETRIC_GAUSS_SEIDEL:
        if colored:
            tmp = _colored_solve(M, y, reverse=False)   # (L_c+D)⁻¹ y
            return _colored_solve(M, tmp * M.A_D, reverse=True)
        tmp = run_whole(trisolve, M.L_solve, y)         # (L+D)⁻¹ y
        return run_whole(trisolve, M.U_solve, tmp * M.A_D)  # (U+D)⁻¹ D …
    if pt == PrecondType.TWO_STAGE_GS:
        return two_stage_solve(M.L_strict_dev, M.A_D_inv, y, M.inner_iters)
    if pt == PrecondType.SYMMETRIC_TWO_STAGE_GS:
        out = two_stage_solve(M.L_strict_dev, M.A_D_inv, y, M.inner_iters)
        out = out * M.A_D
        return two_stage_solve(M.U_strict_dev, M.A_D_inv, out,
                               M.inner_iters)
    if pt == PrecondType.ILU0:
        if colored:
            # forward: unit-diagonal L over ascending colours; backward: U
            # over descending colours with U's diagonal
            from .coloring import colored_sweep
            tmp = colored_sweep(M.L_strict_dev, 1.0, y, None, None,
                                M.n_colors, color_arr=M.color_arr)
            return colored_sweep(M.U_strict_dev, M.A_D_inv, tmp, None, None,
                                 M.n_colors, reverse=True,
                                 color_arr=M.color_arr)
        return run_whole(trisolve, M.U_solve,
                         run_whole(trisolve, M.L_solve, y))
    raise ValueError(f"unsupported preconditioner: {pt}")


def apply_preconditioner(M: Preconditioner, y: torch.Tensor) -> torch.Tensor:
    """z ← M⁻¹ y, applied `outer_iters` times (kernels.hpp:355-404).
    TIME'd as "precond" in kernel-timing mode (reference cg.hpp:37-41)."""
    from .utils.ktimers import ktime
    return ktime("precond", _apply_outer, M, y)


def _apply_outer(M: Preconditioner, y: torch.Tensor) -> torch.Tensor:
    out = y
    for _ in range(max(1, M.outer_iters)):
        out = _apply_once(M, out)
    return out


def estimated_precond_passes(M: Preconditioner) -> float:
    """Estimated device-memory cost of one apply in units of one full
    vector stream, for the roofline report (the JAX package's static
    estimate from the apply's structure, precond.py:694-761)."""
    k = M.inner_iters
    outer = max(1, M.outer_iters)
    if M.ptype == PrecondType.MULTIGRID:
        from .mg import estimated_vcycle_passes
        return estimated_vcycle_passes(M.mg_data, M.mg_smooth_degree,
                                       M.mg_coarse_degree) * outer
    if M.L_block is not None or M.U_block is not None:
        # blocked solves: each factor plane streams once, ~3 window reads
        # per (level, source) pair, and the permutes and vector passes
        from .ops import block_trisolve as bk
        per = 0.0
        for B in (M.L_block, M.U_block):
            if B is None:
                continue
            if isinstance(B, bk.MeshSuperBlockTriSolve):
                # the JAX package's estimate of the whole solve, though
                # the mesh route takes no one-launch solve
                B = B.inner
            if isinstance(B, bk.SuperBlockTriSolve):
                # const mode regenerates its planes: no factor traffic; the
                # one-launch solve reads no window either
                n_groups = (0 if B.is_const else
                            sum(len(c) + len(s) for _, c, s in B.levels))
                n_pairs = (0 if bk.MEGA and B.is_const and B.fused else
                           sum(len({s for s, _ in c})
                               for _, c, _s in B.levels))
                per += (n_groups + 3.0 * n_pairs) / B.S + 5.0
            else:
                n_pairs = sum(len({s for s, _, _ in g}) for _, g in B.levels)
                per += (B.vals.shape[0] + 3.0 * n_pairs) / B.n_colors + 5.0
        if M.ptype == PrecondType.SYMMETRIC_GAUSS_SEIDEL:
            per += 1.0
        return per * outer
    if M.n_colors > 0:
        # coloured sweeps: ~(SpMV + masked update) ≈ 5 passes a step
        n_steps = M.n_colors
        if (M.color_spec is not None and M.color_spec.kind == "grid"
                and M.color_spec.params[3] > 1):
            n_steps = max(1, M.n_colors // M.color_spec.params[3])
        per_sweep = 5.0 * n_steps
        per = {PrecondType.GAUSS_SEIDEL: per_sweep,
               PrecondType.BACKWARDS_GAUSS_SEIDEL: per_sweep,
               PrecondType.SYMMETRIC_GAUSS_SEIDEL: 2 * per_sweep + 1,
               PrecondType.ILU0: 2 * per_sweep}[M.ptype]
        return per * outer
    per = {
        PrecondType.NONE: 0.0,
        PrecondType.JACOBI: 3.0,                   # read y, read D, write z
        PrecondType.GAUSS_SEIDEL: 8.0,             # level-scan gather+solve
        PrecondType.BACKWARDS_GAUSS_SEIDEL: 8.0,
        PrecondType.SYMMETRIC_GAUSS_SEIDEL: 17.0,
        PrecondType.TWO_STAGE_GS: 3.0 + 6.0 * k,   # k Richardson sweeps
        PrecondType.SYMMETRIC_TWO_STAGE_GS: 7.0 + 12.0 * k,
        PrecondType.ILU0: 16.0,
        # ~6 vector passes per inner SpMV, residual and update
        PrecondType.CHEBYSHEV: 3.0 + 6.0 * max(0, M.cheby_degree - 1),
    }[M.ptype]
    return per * outer
