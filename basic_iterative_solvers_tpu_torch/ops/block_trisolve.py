"""Blocked coloured triangular solves: the superblock solves on stencils
(exact coloured GS in const mode, exact coloured ILU(0) in factor-table
mode) and the rank-space solves of host-CSR factors under a mod colouring.

The const and translation-table subset of the JAX package's
ops/block_trisolve.py.  A grid colouring with strides (sx, sy, sz) of a
constant-coefficient stencil groups the rows into S = sy·sz superblocks:
superblock sb holds the rows with (y mod sy, z mod sz) = (sb mod sy,
sb // sy), and its colours are the sx x-parities.  In the colour-sorted
ordering the strict lower triangle L couples a superblock only to lower
ones (cross legs) and, inside it, a parity only to lower parities along x
(self legs); U mirrors that.  So a triangular solve is S levels, one per
superblock, each a parallel update with the x-parities chained:

    acc = y − Σ_cross f·mask·x(src, Δ)
    for each parity p:  x = (acc − Σ_self f·mask·x(dx))·D⁻¹  on parity p

Const mode (GS, SGS): f is the operator's leg coefficient (`const_cross`,
`const_self`) and D⁻¹ the constant diagonal's inverse: nothing is stored
but metadata.  `blocked_trisolve` and `blocked_sgs` are the same actions as
the masked colour sweeps of coloring.py with the same colouring.

Factor-table mode (ILU(0)): f is the coloured ILU(0) factor value of the
row and leg, and D⁻¹ is 1 for L (unit diagonal) and the row's inverse U
pivot for U.  Under a proper grid colouring a row's factor values depend
only on its in-bounds masks within R = h·n_colours of it, so a prototype
grid of at most 2R + s points per axis holds every distinct row
(`_ilu0_translation_tables`); a row reads its values from that class table
at the class of its (x, y, z).  The table is (2h+1)³ × (Px·Py·Pz) values
(27 × 5,832 for HPCG at any size, ~630 KB in float32), so no factor plane
is ever stored: the JAX package's plane mode (per-row values in (R_b, 128)
planes) and packed mode (x-classes folded into 16 lane slots, bit-checked)
are both this one mode here.

Vectors stay in the natural flat order: the JAX package's rank-space
permute, (R_b, 128) planes, TB tiles and fused/aligned layouts are TPU
geometry with no counterpart here.  Its flat-IO apply (`_ilu0_flat_apply`,
`_flat_io_eligible`) exists to skip the permute and unpermute passes
around an ILU(0) apply; the port has no such passes, so `blocked_ilu0`
needs no switch of its own.  The one layout switch kept is
`BIS_SB_ALIGNED=0`, read as the JAX package reads it: a factor-table solve
whose x-lines do not tile the TPU's 128 lanes (128 % nx != 0) then runs
the split route, each level as `super_acc` (acc for the whole level) and
one `super_parity` per x-parity.

Rank-space solves (`BlockedTriSolve`, the JAX package's rank-space
layout, for a mod colouring of host-CSR factors): in the colour-sorted
ordering row j being a pattern neighbour of row i becomes rank(j) =
rank(i) + Δ with Δ constant per (target colour, source colour, leg), so a
strict triangle splits into groups (source colour, Δ), each a plane of
values aligned to the target's rank slots.  The colour blocks are one
(C, M) state tensor (M = R_b·128 slots, the JAX package's padded block),
and level c solves

    x_c = (y_c − Σ_groups vals_g ⊙ shift(x_src(g), Δ_g)) · D_c⁻¹

in one launch (`rank_level`).  Grid colourings of host CSR take the JAX
package's superblock form built from CSR, which needs a plane mode of the
superblock kernel: ROADMAP Queue 1 slice 5b.

`super_level`, `super_acc`, `super_parity` and `rank_level` are the
kernels' entry points: on a CUDA tensor each launches its hand-written
kernel (csrc/block_trisolve.cu) or raises; on a CPU tensor each runs its
plain version (`super_level_plain`, `super_acc_plain`,
`super_parity_plain`, `rank_level_plain`).
"""
from __future__ import annotations

import ctypes
import dataclasses
import os
import types
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import torch_dtype
from ..stencil_op import _rounded

#: threads per kernel block (csrc/block_trisolve.cu: __launch_bounds__)
_BLOCK_THREADS = 256

#: BIS_SB_ALIGNED=0: factor-table solves with 128 % nx != 0 take the split
#: route (the JAX package's kill-switch of its aligned-fused layout, read
#: the same way, at import)
NO_ALIGNED = os.environ.get("BIS_SB_ALIGNED", "1") == "0"


class BlockIneligibleError(ValueError):
    """The superblock form does not apply to this operator and colouring."""


class ImproperColoringError(BlockIneligibleError):
    """The colouring couples two rows of the same colour."""


@dataclasses.dataclass(eq=False)
class SuperBlockTriSolve:
    """Superblock form of a coloured triangular solve.

    levels[li] = (sb, cross, selfs): the superblock solved at level li, its
    cross groups ((src, Δ), …) sorted by (src, Δ), its self legs (dx, …)
    sorted (the JAX package's fields, as Python tuples).

    Const mode: const_cross[li] = ((c, dx, dy, dz), …) aligned with cross,
    const_self[li] = ((c, dx), …) aligned with selfs; `dinv` and `d` are
    the constant diagonal's inverse and value rounded to `dtype` (`d` only
    where a symmetric apply multiplies by D between the two solves).

    Factor-table mode (`table` set): table_cross[li] = ((kd, dx, dy, dz),
    …) and table_self[li] = ((kd, dx), …), kd the leg's row of `table`
    ((2h+1)³, Np) at `dtype`; `table_dinv` (Np,) is U's inverse pivot per
    class (None: L's unit diagonal); a row's class comes from its (x, y, z)
    through the prototype dims `proto` and the radius `radius`.  `fused`
    False sends the solve down the split route."""

    n_rows: int
    S: int
    m: int
    sx: int
    levels: Tuple
    upper: bool
    spec_params: Tuple[int, ...]
    dtype: torch.dtype
    #: max |d| per axis over the legs (the plain version's zero padding)
    reach: Tuple[int, int, int]
    const_cross: Tuple = ()
    const_self: Tuple = ()
    dinv: Optional[float] = None
    d: Optional[float] = None
    table: Optional[torch.Tensor] = None
    table_dinv: Optional[torch.Tensor] = None
    proto: Tuple[int, int, int] = (0, 0, 0)
    radius: int = 0
    table_cross: Tuple = ()
    table_self: Tuple = ()
    fused: bool = True
    #: the kernels' launch tables per level, built at first launch
    _args: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def is_table(self) -> bool:
        return self.table is not None


def _stencil_pair_plan(op, spec):
    """Eligibility and geometry of the analytic stencil pair: the constant
    diagonal, the self legs [(dx, c)], and per target superblock its cross
    legs [(src, Δ, c, leg)].  Raises BlockIneligibleError (or
    ImproperColoringError) where the superblock form does not apply."""
    if spec.kind != "grid":
        raise BlockIneligibleError("superblock path needs a grid coloring")
    nx, ny, nz, sx, sy, sz = spec.params
    if tuple(op.dims) != (nx, ny, nz):
        raise BlockIneligibleError("grid spec dims do not match operator")
    if op.diag is not None:
        raise BlockIneligibleError(
            "dense-diagonal stencil: diagonal is not a constant")
    if ny % sy or nz % sz:
        raise BlockIneligibleError("grid strides must divide the dims")
    my, mz = ny // sy, nz // sz
    S = sy * sz
    diag_c = None
    self_legs, cross_legs = [], []
    for leg, c in zip(op.legs, op.coeff_values):
        dx, dy, dz = leg
        if leg == (0, 0, 0):
            diag_c = float(c)
            continue
        if float(c) == 0.0:
            continue
        if dx % sx == 0 and dy % sy == 0 and dz % sz == 0:
            raise ImproperColoringError(
                f"leg {leg} couples same-colored rows under this spec")
        if dy == 0 and dz == 0:
            if abs(dx) >= nx:
                raise BlockIneligibleError(
                    "self coupling reach exceeds an x-line")
            self_legs.append((dx, float(c)))
        elif dy % sy == 0 and dz % sz == 0:
            raise BlockIneligibleError(
                "same-superblock coupling beyond x axis")
        else:
            cross_legs.append((leg, float(c)))
    if diag_c is None or diag_c == 0.0:
        raise BlockIneligibleError("stencil has no constant nonzero "
                                   "diagonal leg")
    per_sb = []
    for sb in range(S):
        py_t, pz_t = sb % sy, sb // sy
        rows = []
        for (dx, dy, dz), c in cross_legs:
            py_s, pz_s = (py_t + dy) % sy, (pz_t + dz) % sz
            src = py_s + sy * pz_s
            dRy = (py_t + dy - py_s) // sy
            dRz = (pz_t + dz - pz_s) // sz
            delta = dx + nx * (dRy + my * dRz)
            rows.append((src, delta, c, (dx, dy, dz)))
        per_sb.append(rows)
    reach = tuple(max([0] + [abs(leg[a]) for leg in op.legs])
                  for a in range(3))
    return types.SimpleNamespace(
        diag_c=diag_c, self_legs=sorted(self_legs), per_sb=per_sb, S=S,
        m=nx * my * mz, spec_params=tuple(int(p) for p in spec.params),
        reach=reach)


def _levels_for(plan, upper: bool):
    """[(sb, cross rows sorted by (src, Δ))] in solve order: the cross legs
    from lower superblocks (L) or higher ones (U)."""
    order = range(plan.S - 1, -1, -1) if upper else range(plan.S)
    out = []
    for sb in order:
        rows = [r for r in plan.per_sb[sb]
                if (r[0] > sb if upper else r[0] < sb)]
        rows.sort(key=lambda r: (r[0], r[1]))
        out.append((sb, rows))
    return out


def stencil_blocked_eligible(op, spec) -> bool:
    """Can build_superblock_gs_pair_stencil succeed for this DeviceStencil
    and grid spec?  (Metadata checks only.)"""
    try:
        _stencil_pair_plan(op, spec)
        return True
    except BlockIneligibleError:
        return False


#: exact ILU(0) has the const GS pair's eligibility (the same plan)
stencil_ilu0_eligible = stencil_blocked_eligible


def build_superblock_gs_pair_stencil(op, spec, *, dtype=torch.float32,
                                     need_d: bool = False):
    """(L, U) const-mode superblock pair straight from a constant-
    coefficient DeviceStencil: pure metadata, the operator's legs are the
    factors.  Cross legs fall in L when their source superblock is lower
    (src < sb), in U when it is higher; self legs appear in both, split by
    their x-parity masks.  `need_d` keeps D on L (blocked_sgs's middle
    multiply)."""
    plan = _stencil_pair_plan(op, spec)
    dtype = torch_dtype(dtype)
    nx, ny, nz, sx, sy, sz = plan.spec_params
    dinv, d = _rounded([1.0 / plan.diag_c, plan.diag_c], dtype)
    selfs = tuple(dx for dx, _c in plan.self_legs)
    self_consts = tuple((c, dx) for dx, c in plan.self_legs)

    def one(upper: bool):
        levels = _levels_for(plan, upper)
        return SuperBlockTriSolve(
            n_rows=nx * ny * nz, S=plan.S, m=plan.m, sx=sx,
            levels=tuple((sb, tuple((src, delta) for src, delta, _, _
                                    in rows), selfs)
                         for sb, rows in levels),
            upper=upper, spec_params=plan.spec_params, dtype=dtype,
            reach=plan.reach,
            const_cross=tuple(tuple((c,) + leg for _, _, c, leg in rows)
                              for _, rows in levels),
            const_self=(self_consts,) * len(levels), dinv=dinv,
            d=(d if (need_d and not upper) else None))

    return one(False), one(True)


# ---------------------------------------------------------------------------
# Translation-table exact ILU(0)
# ---------------------------------------------------------------------------

def _ilu0_translation_tables(op, spec_params, n_colors, pivot_tolerance,
                             pivot_replacement):
    """Exact coloured ILU(0) factor values for any grid size from one small
    prototype factorization.

    Under a proper grid colouring, row i's factor values depend only on
    the rows of strictly lower colour in its pattern, recursively: a chain
    of at most n_colours − 1 hops of the stencil's reach h.  With constant
    coefficients, two rows whose in-bounds masks agree on the radius
    R = h·n_colours ball factor to identical values.  Per axis that mask is
    fixed by the distance to each edge (up to R) and the phase i mod s, so
    2R + s points per axis hold every class.

    Returns (T, Tdiag, (Px, Py, Pz), R, h): T[kd, z, y, x] the factor value
    of leg kd at prototype row (x, y, z) (0 where absent), Tdiag the U
    diagonal, both float64."""
    from ..coloring import ColorSpec, _grid_coords, spec_colors_np
    from ..factor import factor_ilu0_colored_triplets
    from ..matrix import MatrixCOO, convert_coo_to_csr
    nx, ny, nz, sx, sy, sz = spec_params
    legs = [((dx, dy, dz), float(c))
            for (dx, dy, dz), c in zip(op.legs, op.coeff_values)
            if float(c) != 0.0]
    h = max(max(abs(dx), abs(dy), abs(dz)) for (dx, dy, dz), _c in legs)
    R = h * n_colors

    def proto(n_a, s_a):
        # identity axis when the grid is too small for distinct zones
        if n_a <= 2 * R + 2 * s_a:
            return n_a
        # P ≡ n (mod s) keeps the right-edge map phase-true
        return 2 * R + s_a + (n_a - (2 * R + s_a)) % s_a

    Px, Py, Pz = proto(nx, sx), proto(ny, sy), proto(nz, sz)
    Np = Px * Py * Pz
    idx = np.arange(Np, dtype=np.int64)
    x, y, z = _grid_coords(idx, Px, Py)
    rr, cc, vv = [], [], []
    for (dx, dy, dz), c in legs:
        mask = ((x + dx >= 0) & (x + dx < Px) & (y + dy >= 0)
                & (y + dy < Py) & (z + dz >= 0) & (z + dz < Pz))
        rr.append(idx[mask])
        cc.append(idx[mask] + (dx + Px * (dy + Py * dz)))
        vv.append(np.full(int(mask.sum()), c))
    csr = convert_coo_to_csr(MatrixCOO.from_arrays(
        np.concatenate(rr), np.concatenate(cc), np.concatenate(vv),
        n_rows=Np, n_cols=Np))
    pspec = ColorSpec(kind="grid", n_colors=n_colors,
                      params=(Px, Py, Pz, sx, sy, sz))
    rows_o, cols_o, lu_vals, U_D = factor_ilu0_colored_triplets(
        csr, spec_colors_np(pspec, Np), pivot_tolerance=pivot_tolerance,
        pivot_replacement=pivot_replacement)
    xr, yr, zr = _grid_coords(np.asarray(rows_o), Px, Py)
    xc, yc, zc = _grid_coords(np.asarray(cols_o), Px, Py)
    w = 2 * h + 1
    kd = (xc - xr + h) + w * ((yc - yr + h) + w * (zc - zr + h))
    T = np.zeros((w * w * w, Pz, Py, Px), dtype=np.float64)
    T[kd, zr, yr, xr] = lu_vals
    Tdiag = np.asarray(U_D, dtype=np.float64).reshape(Pz, Py, Px)
    return T, Tdiag, (Px, Py, Pz), R, h


def build_superblock_ilu0_pair_stencil(op, spec, *, dtype=torch.float32,
                                       pivot_tolerance: float = 1e-8,
                                       pivot_replacement: float = 1e-4):
    """(L, U) coloured ILU(0) superblock pair for a constant-coefficient
    DeviceStencil: the host factors only the prototype grid
    (`_ilu0_translation_tables`), and the solves read each row's factor
    values from the resulting class table on the device.  L solves with a
    unit diagonal, U with its pivots.  Raises BlockIneligibleError (or
    ImproperColoringError) like the const-mode builder."""
    plan = _stencil_pair_plan(op, spec)
    tables = _ilu0_translation_tables(
        op, plan.spec_params, plan.S * plan.spec_params[3],
        pivot_tolerance, pivot_replacement)
    return ilu0_pair_from_tables(op, spec, tables, dtype=dtype)


def ilu0_pair_from_tables(op, spec, tables, *, dtype=torch.float32):
    """The (L, U) factor-table pair from translation tables (T, Tdiag,
    (Px, Py, Pz), R, h) as _ilu0_translation_tables gives them, NumPy
    float64: the table is cast to the solve dtype on op's device, and U's
    inverse pivots are computed in float64, then cast."""
    plan = _stencil_pair_plan(op, spec)
    dtype = torch_dtype(dtype)
    T, Tdiag, proto, R, h = tables
    w = 2 * h + 1
    Np = int(np.prod(proto))
    nx, ny, nz, sx, sy, sz = plan.spec_params
    table = torch.from_numpy(np.ascontiguousarray(
        T, dtype=np.float64).reshape(w ** 3, Np)).to(dtype=dtype,
                                                    device=op.device)
    table_dinv = torch.from_numpy(
        (1.0 / np.asarray(Tdiag, dtype=np.float64)).reshape(Np)).to(
            dtype=dtype, device=op.device)
    kd = lambda dx, dy, dz: (dx + h) + w * ((dy + h) + w * (dz + h))  # noqa
    selfs = tuple(dx for dx, _c in plan.self_legs)
    fused = not (NO_ALIGNED and not (nx <= 128 and 128 % nx == 0))

    def one(upper: bool):
        levels = _levels_for(plan, upper)
        return SuperBlockTriSolve(
            n_rows=nx * ny * nz, S=plan.S, m=plan.m, sx=sx,
            levels=tuple((sb, tuple((src, delta) for src, delta, _, _
                                    in rows), selfs)
                         for sb, rows in levels),
            upper=upper, spec_params=plan.spec_params, dtype=dtype,
            reach=plan.reach, table=table,
            table_dinv=table_dinv if upper else None,
            proto=tuple(int(p) for p in proto), radius=int(R),
            table_cross=tuple(tuple((kd(*leg),) + leg
                                    for _, _, _, leg in rows)
                              for _, rows in levels),
            table_self=(tuple((kd(dx, 0, 0), dx) for dx in selfs),)
            * len(levels),
            fused=fused)

    return one(False), one(True)


def _parity_order(B: SuperBlockTriSolve):
    return range(B.sx - 1, -1, -1) if B.upper else range(B.sx)


# ---------------------------------------------------------------------------
# One level: plain versions
# ---------------------------------------------------------------------------

def _check_vectors(B: SuperBlockTriSolve, li: int, **vecs):
    if not 0 <= li < len(B.levels):
        raise IndexError(f"level {li} of {len(B.levels)}")
    device = None
    for name, (v, size) in vecs.items():
        if not isinstance(v, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if v.shape != (size,):
            raise ValueError(f"{name} has shape {tuple(v.shape)}, expected "
                             f"({size},)")
        if v.dtype != B.dtype:
            raise TypeError(f"{name} is {v.dtype}, the solve {B.dtype}")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if device is not None and v.device != device:
            raise ValueError("the vectors lie on different devices")
        device = v.device
    return device


def _check_level(B: SuperBlockTriSolve, li: int, y, x):
    _check_vectors(B, li, y=(y, B.n_rows), x=(x, B.n_rows))


def _rows(B: SuperBlockTriSolve, li: int):
    """(sb, py, pz, my, mz, (z, y) slices of the superblock's rows)."""
    nx, ny, nz, sx, sy, sz = B.spec_params
    sb = B.levels[li][0]
    py, pz = sb % sy, sb // sy
    return (sb, py, pz, ny // sy, nz // sz,
            (slice(pz, None, sz), slice(py, None, sy)))


def _axis_classes(B: SuperBlockTriSolve, li: int, device):
    """(cx (nx,), cy (my,), cz (mz,)): the prototype coordinate of each
    coordinate of level li's superblock, per axis: the JAX package's class
    map (exact near each edge, the phase inside), clamped to the
    prototype."""
    nx, ny, nz, sx, sy, sz = B.spec_params
    Px, Py, Pz = B.proto
    R = B.radius
    _sb, py, pz, my, mz, _ = _rows(B, li)

    def cls(i, n_a, P_a, s_a):
        if P_a == n_a:
            return i
        c = torch.where(i < R, i, torch.where(n_a - 1 - i < R,
                                              P_a - 1 - (n_a - 1 - i),
                                              R + (i - R) % s_a))
        return c.clamp(0, P_a - 1)

    ar = lambda k: torch.arange(k, device=device)  # noqa: E731
    return (cls(ar(nx), nx, Px, sx), cls(sy * ar(my) + py, ny, Py, sy),
            cls(sz * ar(mz) + pz, nz, Pz, sz))


def _class_base(B: SuperBlockTriSolve, li: int, device) -> torch.Tensor:
    """(mz, my, nx) prototype row of each row of level li's superblock."""
    Px, Py = B.proto[:2]
    cx, cy, cz = _axis_classes(B, li, device)
    return cx[None, None, :] + Px * (cy[None, :, None]
                                     + Py * cz[:, None, None])


def _cross_acc(B: SuperBlockTriSolve, li: int, y, x, base):
    """acc = y − Σ_cross f·x(src, Δ) on level li's rows, (mz, my, nx):
    cross legs in (src, Δ) order, each product and difference rounded
    alone.  Out-of-grid neighbours read the zero padding: f·0 leaves acc
    as the JAX package's masked plane does."""
    nx, ny, nz, sx, sy, sz = B.spec_params
    _sb, py, pz, my, mz, rows = _rows(B, li)
    hx, hy, hz = B.reach
    Xp = F.pad(x.view(nz, ny, nx), (hx, hx, hy, hy, hz, hz))
    acc = y.view(nz, ny, nx)[rows]
    legs = (B.table_cross[li] if B.is_table else B.const_cross[li])
    table = B.table.to(x.device) if B.is_table else None
    for f, dx, dy, dz in legs:
        if table is not None:
            f = table[f][base]
        z0, y0, x0 = hz + pz + dz, hy + py + dy, hx + dx
        nb = Xp[z0:z0 + sz * (mz - 1) + 1:sz, y0:y0 + sy * (my - 1) + 1:sy,
                x0:x0 + nx]
        acc = acc - f * nb
    return acc


def _parity_step(B: SuperBlockTriSolve, li: int, p: int, a, xt, base):
    """xt with parity p's rows set to (a − Σ_self f·x(dx))·D⁻¹, the self
    legs reading xt where their source parity is already solved."""
    nx = B.spec_params[0]
    hx = B.reach[0]
    gx = torch.arange(nx, device=xt.device)
    parity = gx % B.sx
    xtp = F.pad(xt, (hx, hx))
    legs = B.table_self[li] if B.is_table else B.const_self[li]
    table = B.table.to(xt.device) if B.is_table else None
    for f, dx in legs:
        if table is not None:
            f = table[f][base]
        src = gx + dx
        ok = (src >= 0) & (src < nx)
        ps = src % B.sx
        ok &= (ps > parity) if B.upper else (ps < parity)
        a = a - f * torch.where(ok, xtp[..., hx + dx:hx + dx + nx], 0.0)
    if not B.is_table:
        a = a * B.dinv
    elif B.table_dinv is not None:
        a = a * B.table_dinv.to(xt.device)[base]
    return torch.where(parity == p, a, xt)


def super_level_plain(B: SuperBlockTriSolve, li: int, y: torch.Tensor,
                      x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the level kernel (the JAX package's
    _super_level_xla in the flat order): writes the rows of level li's
    superblock of x and returns x.  Reads y on those rows and x on the
    superblocks already solved; y may be x itself."""
    _check_level(B, li, y, x)
    nx, ny, nz = B.spec_params[:3]
    base = _class_base(B, li, x.device) if B.is_table else None
    acc = _cross_acc(B, li, y, x, base)
    xt = torch.zeros_like(acc)
    for p in _parity_order(B):
        xt = _parity_step(B, li, p, acc, xt, base)
    x.view(nz, ny, nx)[_rows(B, li)[5]] = xt
    return x


def super_acc_plain(B: SuperBlockTriSolve, li: int, y: torch.Tensor,
                    x: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """Plain version of the split route's acc kernel (the JAX package's
    _super_acc_pallas): acc (m,), level li's rows in line order, gets
    y − Σ_cross f·x; returns acc."""
    _check_split(B, li, y=(y, B.n_rows), x=(x, B.n_rows), acc=(acc, B.m))
    base = _class_base(B, li, x.device)
    acc.copy_(_cross_acc(B, li, y, x, base).reshape(-1))
    return acc


def super_parity_plain(B: SuperBlockTriSolve, li: int, p: int,
                       y: torch.Tensor, acc: Optional[torch.Tensor],
                       x: torch.Tensor) -> torch.Tensor:
    """Plain version of the split route's parity kernel (the JAX package's
    _super_parity_pallas): parity p's rows of level li's superblock of x
    from acc (or from y when the level has no cross legs and acc is None)
    and the self legs; the level's other rows keep their values."""
    _check_parity_args(B, li, p, y, acc, x)
    nx, ny, nz = B.spec_params[:3]
    _sb, _py, _pz, my, mz, rows = _rows(B, li)
    base = _class_base(B, li, x.device)
    a = (y.view(nz, ny, nx)[rows] if acc is None
         else acc.view(mz, my, nx))
    X = x.view(nz, ny, nx)
    X[rows] = _parity_step(B, li, p, a, X[rows], base)
    return x


# ---------------------------------------------------------------------------
# One level: the kernels' wrappers
# ---------------------------------------------------------------------------

def _level_args(B: SuperBlockTriSolve, li: int):
    """The kernels' launch table for level li (cached on B)."""
    from .._build import MAX_LEGS, SuperLevelArgs
    if li in B._args:
        return B._args[li]
    nx, ny, nz, sx, sy, sz = B.spec_params
    sb = B.levels[li][0]
    cross = B.table_cross[li] if B.is_table else B.const_cross[li]
    selfs = B.table_self[li] if B.is_table else B.const_self[li]
    if len(cross) > MAX_LEGS or len(selfs) > MAX_LEGS:
        raise ValueError(f"the kernel takes at most {MAX_LEGS} cross and "
                         f"{MAX_LEGS} self legs a level")
    a = SuperLevelArgs()
    for j, (f, dx, dy, dz) in enumerate(cross):
        a.cross_off[j] = dx + nx * (dy + ny * dz)
        if B.is_table:
            a.cross_kd[j] = f
        else:
            a.cross_coeff[j] = f
        a.cross_dx[j], a.cross_dy[j], a.cross_dz[j] = dx, dy, dz
    for j, (f, dx) in enumerate(selfs):
        if B.is_table:
            a.self_kd[j] = f
        else:
            a.self_coeff[j] = f
        a.self_dx[j] = dx
    a.n_cross, a.n_self = len(cross), len(selfs)
    a.dinv = 1.0 if B.is_table else B.dinv
    a.nx, a.ny, a.nz, a.sx, a.sy, a.sz = nx, ny, nz, sx, sy, sz
    a.py, a.pz = sb % sy, sb // sy
    a.my = ny // sy
    a.lines = a.my * (nz // sz)
    a.upper = int(B.upper)
    a.block_x = min(128, -(-nx // 32) * 32)
    a.block_y = _BLOCK_THREADS // a.block_x
    a.grid_x = -(-a.lines // a.block_y)
    a.proto_x, a.proto_y, a.proto_z = B.proto
    a.radius = B.radius
    a.n_proto = B.proto[0] * B.proto[1] * B.proto[2]
    if B.n_rows >= 2 ** 62:
        raise ValueError(f"grid {B.spec_params[:3]} exceeds the kernel's "
                         "launch limits")
    B._args[li] = a
    return a


def _cuda_call(B: SuperBlockTriSolve, name: str, x: torch.Tensor, *args):
    """Launch `bis_<name>_<dtype>` with level args `args` on x's device and
    stream; raises on a CUDA error."""
    from .._build import load_library
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the superblock kernels take float32 or float64, "
                        f"not {x.dtype}")
    if B.is_table and B.table.device != x.device:
        raise ValueError(f"the factor table is on {B.table.device}, the "
                         f"vectors on {x.device}")
    lib = load_library()
    dt = "f32" if x.dtype == torch.float32 else "f64"
    fn = getattr(lib, f"bis_{name}_{dt}")
    err = fn(x.device.index, *args,
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error "
                           f"{err}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def super_level(B: SuperBlockTriSolve, li: int, y: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """Solve level li of B in place: the rows of its superblock of x from
    y and the superblocks of x already solved; returns x.  y may be x
    itself.

    A CUDA tensor goes through the hand-written kernel, which counts its
    launches in `super_level.launches` (const mode) or
    `super_level.table_launches` (factor-table mode); a CPU tensor takes
    the plain version."""
    _check_level(B, li, y, x)
    if x.device.type == "cuda":
        _cuda_call(B, "super_level", x, ctypes.byref(_level_args(B, li)),
                   y.data_ptr(), x.data_ptr(), _ptr(B.table),
                   _ptr(B.table_dinv))
        if B.is_table:
            super_level.table_launches += 1
        else:
            super_level.launches += 1
        return x
    if x.device.type == "cpu":
        return super_level_plain(B, li, y, x)
    raise ValueError(f"no super-level solve for device {x.device}")


super_level.launches = 0
super_level.table_launches = 0


def _check_split(B: SuperBlockTriSolve, li: int, **vecs):
    if not B.is_table:
        raise ValueError("the split route runs factor-table solves only")
    return _check_vectors(B, li, **vecs)


def _check_parity_args(B, li, p, y, acc, x):
    vecs = dict(y=(y, B.n_rows), x=(x, B.n_rows))
    if acc is not None:
        vecs["acc"] = (acc, B.m)
    elif B.levels[li][1]:
        raise ValueError(f"level {li} has cross legs: its parity steps "
                         "read acc")
    _check_split(B, li, **vecs)
    if not 0 <= p < B.sx:
        raise IndexError(f"parity {p} of {B.sx}")


def super_acc(B: SuperBlockTriSolve, li: int, y: torch.Tensor,
              x: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """Split route, step 1 of level li: acc (m,) gets y − Σ_cross f·x on
    the level's rows, in line order; returns acc.

    A CUDA tensor goes through the hand-written kernel, which counts its
    launches in `super_acc.launches`; a CPU tensor takes the plain
    version."""
    device = _check_split(B, li, y=(y, B.n_rows), x=(x, B.n_rows),
                          acc=(acc, B.m))
    if device.type == "cuda":
        _cuda_call(B, "super_acc", x, ctypes.byref(_level_args(B, li)),
                   y.data_ptr(), x.data_ptr(), acc.data_ptr(),
                   B.table.data_ptr())
        super_acc.launches += 1
        return acc
    if device.type == "cpu":
        return super_acc_plain(B, li, y, x, acc)
    raise ValueError(f"no super-acc step for device {device}")


super_acc.launches = 0


def super_parity(B: SuperBlockTriSolve, li: int, p: int, y: torch.Tensor,
                 acc: Optional[torch.Tensor],
                 x: torch.Tensor) -> torch.Tensor:
    """Split route, step 2 of level li: parity p's rows of the level's
    superblock of x from acc (y where the level has no cross legs and acc
    is None) and the self legs, in place; returns x.

    A CUDA tensor goes through the hand-written kernel, which counts its
    launches in `super_parity.launches`; a CPU tensor takes the plain
    version."""
    _check_parity_args(B, li, p, y, acc, x)
    if x.device.type == "cuda":
        _cuda_call(B, "super_parity", x, ctypes.byref(_level_args(B, li)),
                   p, y.data_ptr(), _ptr(acc), x.data_ptr(),
                   B.table.data_ptr(), _ptr(B.table_dinv))
        super_parity.launches += 1
        return x
    if x.device.type == "cpu":
        return super_parity_plain(B, li, p, y, acc, x)
    raise ValueError(f"no super-parity step for device {x.device}")


super_parity.launches = 0




# ---------------------------------------------------------------------------
# Rank-space solves (host-CSR factors under a mod colouring)
# ---------------------------------------------------------------------------

LANES = 128
#: the JAX package's default row tile; it sizes the padded block R_b
_TB = 256
#: the JAX package's refusal of irregular patterns: more (colour, colour,
#: Δ) groups than this and the planes would be mostly padding
_MAX_GROUPS = 512


@dataclasses.dataclass(eq=False)
class BlockedTriSolve:
    """One rank-space triangular solve.

    vals: (G, M) planes, one per (target colour, source colour, Δ) group;
    dinv: (C, M), 1/D at real slots and 0 at pads; d: (C, M) or None, D
    itself (the symmetric apply's middle multiply); M = R_b·128.  levels:
    ((colour, ((src, Δ, group), …)), …) in solve order, groups sorted."""

    vals: torch.Tensor
    dinv: torch.Tensor
    d: Optional[torch.Tensor]
    n_rows: int
    n_colors: int
    m: int
    R_b: int
    levels: Tuple
    spec_kind: str
    spec_params: Tuple[int, ...]
    #: each level's group table on the card, built at first launch
    _tables: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def dtype(self) -> torch.dtype:
        return self.dinv.dtype

    @property
    def M(self) -> int:
        return self.R_b * LANES


def _entries_of(T):
    """(rows, cols, vals, n) of a MatrixCSR or of (rows, cols, vals, n)
    triplets."""
    from ..matrix import MatrixCSR
    if isinstance(T, MatrixCSR):
        return T.rows(), T.col.astype(np.int64), T.val, T.n_rows
    rows, cols, vals, n = T
    return np.asarray(rows), np.asarray(cols), np.asarray(vals), int(n)


def _group_inverse(key, key_range):
    """np.unique(key, return_inverse=True), through a dense table where the
    key range is small."""
    if key_range <= (1 << 27):
        present = np.zeros(key_range, dtype=bool)
        present[key] = True
        uniq = np.flatnonzero(present)
        lut = np.zeros(key_range, dtype=np.int32)
        lut[uniq] = np.arange(uniq.size, dtype=np.int32)
        return uniq, lut[key]
    return np.unique(key, return_inverse=True)


def _check_spec(spec, n: int) -> int:
    """The slots per colour block, m; a spec without the rank-space form
    raises."""
    if spec.kind == "mod":
        return -(-n // spec.params[0])
    if spec.kind == "grid":
        raise NotImplementedError(
            "coloured triangular solves of a host CSR matrix under a grid "
            "colouring take the superblock form built from CSR, which "
            "arrives with ROADMAP Queue 1 slice 5b")
    raise BlockIneligibleError(
        f"blocked trisolve needs a grid/mod coloring, got {spec.kind!r}")


def spec_colors_valid(colors, spec, n: int) -> bool:
    """True iff `colors` is exactly the spec's structural colouring."""
    from ..coloring import spec_colors_np
    try:
        return np.array_equal(np.asarray(colors), spec_colors_np(spec, n))
    except ValueError:
        return False


def build_blocked_trisolve(T, D: Optional[np.ndarray], colors: np.ndarray,
                           spec, *, upper: bool, dtype=torch.float32,
                           need_d: bool = False,
                           device="cuda") -> BlockedTriSolve:
    """Pack the colour-lower (colour-upper) part of T, the entries with
    colour(j) < colour(i) (>), for the rank-space solve on `device`; D is
    the diagonal to divide by (None: unit).  T is a MatrixCSR or
    (rows, cols, vals, n) triplets.  An improper colouring raises
    ImproperColoringError; a structure without the blocked form raises
    BlockIneligibleError.  The JAX package's NumPy builder, step for step."""
    from ..stencil_op import resolve_device
    device = resolve_device(device)
    rows, cols, vals, n = _entries_of(T)
    C = spec.n_colors
    ci = colors[rows].astype(np.int64)
    cj = colors[cols].astype(np.int64)
    if np.any((ci == cj) & (rows != cols)):
        raise ImproperColoringError("coloring is not proper for this "
                                    "pattern")
    m = _check_spec(spec, n)
    if n and C != int(colors.max()) + 1:
        raise BlockIneligibleError("colors/spec mismatch")
    rank = np.arange(n, dtype=np.int64) // spec.params[0]
    keep = (cj > ci) if upper else (cj < ci)
    rows, cols, ci, cj = rows[keep], cols[keep], ci[keep], cj[keep]
    v = vals[keep]
    delta = rank[cols] - rank[rows]
    span = 2 * m + 1
    ukey, ginv = _group_inverse((ci * C + cj) * span + (delta + m),
                                C * C * span)
    G = ukey.size
    if G > _MAX_GROUPS:
        raise BlockIneligibleError(
            f"{G} (color,color,Δ) groups — pattern too irregular")
    g_tc, g_sc = (ukey // span) // C, (ukey // span) % C
    g_dl = (ukey % span) - m
    qmax = int(np.abs(g_dl).max()) // LANES + 1 if G else 0
    R_rows = -(-m // LANES)
    TB = max(8 * -(-(qmax + 1) // 8), min(_TB, 8 * -(-R_rows // 8)), 8)
    R_b = max(TB, -(-R_rows // TB) * TB)
    M = R_b * LANES
    vals_np = np.zeros((G, M), dtype=np.float64)
    vals_np[ginv, rank[rows]] = v
    dv = np.ones(n) if D is None else np.asarray(D, dtype=np.float64)
    if np.any(dv == 0):
        raise ValueError("zero diagonal in blocked trisolve")
    dinv_np = np.zeros((C, M), dtype=np.float64)
    dinv_np[colors, rank] = 1.0 / dv
    d_np = None
    if need_d:
        d_np = np.zeros((C, M), dtype=np.float64)
        d_np[colors, rank] = dv
    levels = []
    for c in (range(C - 1, -1, -1) if upper else range(C)):
        sel = np.nonzero(g_tc == c)[0]
        levels.append((int(c), tuple(sorted(
            (int(g_sc[g]), int(g_dl[g]), int(g)) for g in sel))))
    dtype = torch_dtype(dtype)
    as_t = lambda a: torch.from_numpy(a).to(dtype=dtype,  # noqa: E731
                                            device=device)
    return BlockedTriSolve(
        vals=as_t(vals_np), dinv=as_t(dinv_np),
        d=None if d_np is None else as_t(d_np), n_rows=n, n_colors=C, m=m,
        R_b=R_b, levels=tuple(levels), spec_kind=spec.kind,
        spec_params=tuple(int(p) for p in spec.params))


def build_best_trisolve_pair(T, D_L, D_U, colors, spec, *,
                             dtype=torch.float32, need_d: bool = False,
                             device="cuda"):
    """The (lower, upper) pair in one layout, the entries expanded once."""
    trip = _entries_of(T)
    return (build_blocked_trisolve(trip, D_L, colors, spec, upper=False,
                                   dtype=dtype, need_d=need_d,
                                   device=device),
            build_blocked_trisolve(trip, D_U, colors, spec, upper=True,
                                   dtype=dtype, device=device))


def permute_blocks(B: BlockedTriSolve, y: torch.Tensor) -> torch.Tensor:
    """Flat (n,) → the (C, M) colour blocks, rank-ordered, zero-padded."""
    k, m = B.spec_params[0], B.m
    arr = torch.nn.functional.pad(y, (0, k * m - B.n_rows)).view(m, k).t()
    return torch.nn.functional.pad(arr, (0, B.M - m)).contiguous()


def unpermute_blocks(B: BlockedTriSolve, X: torch.Tensor) -> torch.Tensor:
    """The (C, M) colour blocks → flat (n,)."""
    k, m = B.spec_params[0], B.m
    return X[:, :m].t().reshape(k * m)[:B.n_rows]


def _check_rank_level(B: BlockedTriSolve, li: int, Y, X):
    if not 0 <= li < len(B.levels):
        raise IndexError(f"level {li} of {len(B.levels)}")
    for name, v in (("y", Y), ("x", X)):
        if not isinstance(v, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if v.shape != (B.n_colors, B.M):
            raise ValueError(f"{name} has shape {tuple(v.shape)}, expected "
                             f"{(B.n_colors, B.M)}")
        if v.dtype != B.dtype:
            raise TypeError(f"{name} is {v.dtype}, the solve {B.dtype}")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if v.device != B.dinv.device:
            raise ValueError(f"{name} is on {v.device}, the solve on "
                             f"{B.dinv.device}")


def rank_level_plain(B: BlockedTriSolve, li: int, Y: torch.Tensor,
                     X: torch.Tensor) -> torch.Tensor:
    """Plain version of the level kernel (the JAX package's _level_xla):
    X[c] = (Y[c] − Σ_g vals_g·roll(X[src], −Δ))·dinv[c] for level li's
    colour c, in place; returns X.  roll wraps, but a wrapped slot always
    multiplies a zero value."""
    _check_rank_level(B, li, Y, X)
    c, groups = B.levels[li]
    acc = Y[c]
    for sc, delta, g in groups:
        acc = acc - B.vals[g] * torch.roll(X[sc], -delta)
    X[c] = acc * B.dinv[c]
    return X


def _rank_table(B: BlockedTriSolve, li: int, device) -> torch.Tensor:
    key = (li, str(device))
    if key not in B._tables:
        B._tables[key] = torch.tensor(
            [list(g) for g in B.levels[li][1]], dtype=torch.int64,
            device=device).reshape(-1).contiguous()
    return B._tables[key]


def rank_level(B: BlockedTriSolve, li: int, Y: torch.Tensor,
               X: torch.Tensor) -> torch.Tensor:
    """Solve level li of B in place: X[c] for its colour c from Y[c] and
    the colours of X already solved; returns X.  Y may be X itself.

    A CUDA tensor goes through the hand-written kernel, one launch per
    level with groups, counted in `rank_level.launches`; a CPU tensor takes
    the plain version."""
    _check_rank_level(B, li, Y, X)
    if X.device.type == "cpu":
        return rank_level_plain(B, li, Y, X)
    if X.device.type != "cuda":
        raise ValueError(f"no rank-space level for device {X.device}")
    from .._build import load_library
    if X.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the rank-space kernel takes float32 or float64, "
                        f"not {X.dtype}")
    c, groups = B.levels[li]
    table = _rank_table(B, li, X.device)
    lib = load_library()
    fn = lib.bis_rank_level_f32 if X.dtype == torch.float32 \
        else lib.bis_rank_level_f64
    err = fn(X.device.index, Y.data_ptr(), X.data_ptr(), B.vals.data_ptr(),
             B.dinv.data_ptr(), table.data_ptr(), len(groups), B.M, c,
             torch.cuda.current_stream(X.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rank_level kernel launch failed with CUDA "
                           f"error {err}")
    rank_level.launches += 1
    return X


rank_level.launches = 0


def solve_blocks(B: BlockedTriSolve, Y: torch.Tensor,
                 X: torch.Tensor) -> torch.Tensor:
    """All levels in order into X (which may be Y): a colour with no groups
    is Y·dinv in torch, the others one `rank_level` each."""
    for li, (c, groups) in enumerate(B.levels):
        if groups:
            rank_level(B, li, Y, X)
        else:
            X[c] = Y[c] * B.dinv[c]
    return X


# ---------------------------------------------------------------------------
# Whole solves
# ---------------------------------------------------------------------------

def _solve_super(B: SuperBlockTriSolve, y: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """All levels in order, into x (which may be y): one fused launch a
    level, or on the split route an acc step (where the level has cross
    legs) and one step per x-parity."""
    if B.fused:
        for li in range(len(B.levels)):
            super_level(B, li, y, x)
        return x
    acc = torch.empty(B.m, dtype=x.dtype, device=x.device)
    for li, (_sb, cross, _s) in enumerate(B.levels):
        if cross:
            super_acc(B, li, y, x, acc)
        for p in _parity_order(B):
            super_parity(B, li, p, y, acc if cross else None, x)
    return x


def blocked_trisolve(B, y: torch.Tensor) -> torch.Tensor:
    """x = (T_c + D)⁻¹y: the exact GS solve of the colour-sorted ordering,
    the same action as coloring.colored_sweep from zero."""
    if isinstance(B, BlockedTriSolve):
        Y = permute_blocks(B, y)
        return unpermute_blocks(B, solve_blocks(B, Y, Y))
    return _solve_super(B, y, torch.empty_like(y))


def blocked_sgs(L, U, y: torch.Tensor) -> torch.Tensor:
    """(U_c+D)⁻¹ D (L_c+D)⁻¹ y, the exact coloured symmetric GS apply: the
    levels of L, the multiply by D, the levels of U in place (L must be
    built with need_d=True)."""
    if L.d is None:
        raise ValueError("blocked_sgs needs L built with need_d=True")
    if isinstance(L, BlockedTriSolve):
        T = solve_blocks(L, permute_blocks(L, y), torch.empty(
            (L.n_colors, L.M), dtype=y.dtype, device=y.device)) * L.d
        return unpermute_blocks(U, solve_blocks(U, T, T))
    t = blocked_trisolve(L, y) * L.d
    return _solve_super(U, t, t)


def blocked_ilu0(L, U, y: torch.Tensor) -> torch.Tensor:
    """U⁻¹L⁻¹y with unit-diagonal L, the coloured ILU(0) apply: the levels
    of L, then the levels of U in place on the same state."""
    if isinstance(L, BlockedTriSolve):
        X = solve_blocks(L, permute_blocks(L, y), torch.empty(
            (L.n_colors, L.M), dtype=y.dtype, device=y.device))
        return unpermute_blocks(U, solve_blocks(U, X, X))
    if not (L.is_table and U.is_table):
        raise ValueError("blocked_ilu0 needs a factor-table pair "
                         "(build_superblock_ilu0_pair_stencil)")
    x = blocked_trisolve(L, y)
    return _solve_super(U, x, x)
