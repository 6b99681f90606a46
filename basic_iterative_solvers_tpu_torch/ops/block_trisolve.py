"""Blocked coloured triangular solves: the superblock solves (exact
coloured GS in const mode, exact coloured ILU(0) in factor-table mode on
stencils, both from host CSR in plane mode) and the rank-space solves of
host-CSR factors under a mod or grid colouring.

The port of the JAX package's ops/block_trisolve.py.  A grid colouring
with strides (sx, sy, sz) groups the rows of a grid into S = sy·sz
superblocks: superblock sb holds the rows with (y mod sy, z mod sz) =
(sb mod sy, sb // sy), and its colours are the sx x-parities.  In the colour-sorted
ordering the strict lower triangle L couples a superblock only to lower
ones (cross legs) and, inside it, a parity only to lower parities along x
(self legs); U mirrors that.  So a triangular solve is S levels, one per
superblock, each a parallel update with the x-parities chained:

    acc = y − Σ_cross f·mask·x(src, Δ)
    for each parity p:  x = (acc − Σ_self f·mask·x(dx))·D⁻¹  on parity p

Const mode (GS, SGS): f is the operator's leg coefficient (`const_cross`,
`const_self`) and D⁻¹ the constant diagonal's inverse, or, for a pair
built from host CSR, the diagonal's inverse per row: nothing else is
stored but metadata.  `blocked_trisolve` and `blocked_sgs` are the same actions as
the masked colour sweeps of coloring.py with the same colouring.

Factor-table mode (ILU(0)): f is the coloured ILU(0) factor value of the
row and leg, and D⁻¹ is 1 for L (unit diagonal) and the row's inverse U
pivot for U.  Under a proper grid colouring a row's factor values depend
only on its in-bounds masks within R = h·n_colours of it, so a prototype
grid of at most 2R + s points per axis holds every distinct row
(`_ilu0_translation_tables`); a row reads its values from that class table
at the class of its (x, y, z).  The table is (2h+1)³ × (Px·Py·Pz) values
(27 × 5,832 for HPCG at any size, ~630 KB in float32), so no factor plane
is stored for a stencil: the JAX package's plane mode of its translation
tables (per-row values in (R_b, 128) planes) and packed mode (x-classes
folded into 16 lane slots, bit-checked) are both this one mode here.

Plane mode (`build_superblock_trisolve`, from host CSR; the JAX
package's NumPy branch): f is a plane of per-row values over the
superblock's m slots, slot line·nx + x with line = y//sy + my·(z//sz).  A
cross group is keyed (src, Δ) in slot space: target slot t reads slot
t + Δ of superblock src (0 outside [0, m)); D⁻¹ is per row (`dinv_rows`).
The builder first tries const detection on the planes rounded to the
solve dtype: a pair whose every plane is coeff × (leg mask) is const mode,
with the per-row D it was built with (Anderson: constant legs, random
diagonal).

Vectors stay in the natural flat order: the JAX package's rank-space
permute, (R_b, 128) planes, TB tiles and fused/aligned layouts are TPU
geometry with no counterpart here (a plane keeps the m real slots, not
the R_b·128 padded ones).  Its flat-IO apply (`_ilu0_flat_apply`,
`_flat_io_eligible`) exists to skip the permute and unpermute passes
around an ILU(0) apply; the port has no such passes, so `blocked_ilu0`
needs no switch of its own.  Two switches are kept, each read at import as
the JAX package reads it.  `BIS_SB_ALIGNED=0`: a factor-table or plane
solve whose x-lines do not tile the TPU's 128 lanes (128 % nx != 0) runs
the split route, each level as `super_acc` (acc for the whole level) and
one `super_parity` per x-parity.  `BIS_SB_MEGA=1` (the module attribute
`MEGA`, which may be set in process): a fused const-mode solve runs as one
launch (`super_solve_mega`).  The TPU's lane rule stays too: a self leg
with |dx| ≥ min(nx, 128) refuses the superblock form, as the JAX package
refuses it, so both packages take the same route.

Rank-space solves (`BlockedTriSolve`, the JAX package's rank-space
layout, for a mod colouring of host-CSR factors): in the colour-sorted
ordering row j being a pattern neighbour of row i becomes rank(j) =
rank(i) + Δ with Δ constant per (target colour, source colour, leg), so a
strict triangle splits into groups (source colour, Δ), each a plane of
values aligned to the target's rank slots.  The colour blocks are one
(C, M) state tensor (M = R_b·128 slots, the JAX package's padded block),
and level c solves

    x_c = (y_c − Σ_groups vals_g ⊙ shift(x_src(g), Δ_g)) · D_c⁻¹

in one launch (`rank_level`).  A grid colouring of host CSR takes the
superblock form; where that refuses (BlockIneligibleError other than an
improper colouring), the rank-space form with the grid rank
(x//sx) + mx·((y//sy) + my·(z//sz)), as the JAX package falls back.

`super_level`, `super_acc`, `super_parity`, `super_solve_mega` and
`rank_level` are the kernels' entry points: on a CUDA tensor each launches
its hand-written kernel (csrc/block_trisolve.cu) or raises; on a CPU
tensor each runs its plain version (`super_level_plain`,
`super_acc_plain`, `super_parity_plain`, `super_solve_mega_plain`,
`rank_level_plain`).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
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

#: the TPU's lane width: the JAX package's self-reach rule (a self leg
#: reaches less than min(nx, 128)) and plane group keys use it
LANES = 128

#: BIS_SB_ALIGNED=0: factor-table and plane solves with 128 % nx != 0
#: take the split route (the JAX package's kill-switch of its
#: aligned-fused layout, read the same way, at import)
NO_ALIGNED = os.environ.get("BIS_SB_ALIGNED", "1") == "0"

#: BIS_SB_MEGA=1: a fused const-mode solve runs as one launch
#: (super_solve_mega), the JAX package's only route to its
#: _super_solve_pallas_mega, read the same way, at import; set the
#: attribute to switch in process
MEGA = os.environ.get("BIS_SB_MEGA", "0") == "1"


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
    through the prototype dims `proto` and the radius `radius`.

    Plane mode (`vals_cross` set; built from host CSR): vals_cross[li]
    (Gc, m) and vals_self[li] (Gs, m) at `dtype`, rows aligned with the
    level's cross groups and self legs (None where it has none), indexed
    by slot.  Pairs built from host CSR, plane or const mode, carry the
    per-row diagonal: `dinv_rows` (n,) its rounded inverse, `d_rows` (n,)
    D itself on L where a symmetric apply needs it; `dinv` and `d` stay
    None there.  `unit` marks L of an ILU(0) pair, which solves with a
    unit diagonal.  `fused` False sends the solve down the split route."""

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
    vals_cross: Optional[Tuple] = None
    vals_self: Optional[Tuple] = None
    dinv_rows: Optional[torch.Tensor] = None
    d_rows: Optional[torch.Tensor] = None
    unit: bool = False
    #: the kernels' launch tables per level, built at first launch
    _args: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def is_table(self) -> bool:
        return self.table is not None

    @property
    def is_plane(self) -> bool:
        return self.vals_cross is not None

    @property
    def is_const(self) -> bool:
        return not (self.is_table or self.is_plane)


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
            if abs(dx) >= min(nx, LANES):
                raise BlockIneligibleError(
                    "self coupling reach exceeds a lane row")
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
            table_dinv=table_dinv if upper else None, unit=not upper,
            proto=tuple(int(p) for p in proto), radius=int(R),
            table_cross=tuple(tuple((kd(*leg),) + leg
                                    for _, _, _, leg in rows)
                              for _, rows in levels),
            table_self=(tuple((kd(dx, 0, 0), dx) for dx in selfs),)
            * len(levels),
            fused=fused)

    return one(False), one(True)


# ---------------------------------------------------------------------------
# The superblock form from host CSR (plane mode, or const mode detected)
# ---------------------------------------------------------------------------

def _np_dtype(dtype: torch.dtype):
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"superblock planes take float32 or float64, not "
                        f"{dtype}")
    return np.float32 if dtype == torch.float32 else np.float64


def _leg_from_delta(sb_t: int, src: int, delta: int, spec_params):
    """The (dx, dy, dz) stencil leg behind a cross group (target sb, source
    src, slot offset Δ): the smallest-|dx| decomposition of
    Δ = dx + nx·(dRy + my·dRz).  The caller checks it against the plane,
    so an ambiguous decomposition fails detection instead of
    misclassifying."""
    nx, ny, nz, sx, sy, sz = spec_params
    my = ny // sy
    dx = ((delta + nx // 2) % nx) - nx // 2
    rem = (delta - dx) // nx
    dRy = ((rem + my // 2) % my) - my // 2
    dRz = (rem - dRy) // my
    dy = (src % sy - sb_t % sy) + sy * dRy
    dz = (src // sy - sb_t // sy) + sz * dRz
    return dx, dy, dz


@functools.lru_cache(maxsize=8)
def _slot_coords(spec_params, sb: int, m: int):
    """Per-slot (x, y, z) coordinates of superblock sb's m slots
    (read-only, shared by its groups)."""
    nx, ny, nz, sx, sy, sz = spec_params
    my = ny // sy
    s = np.arange(m, dtype=np.int64)
    t = s // nx
    out = (s % nx, sy * (t % my) + sb % sy, sz * (t // my) + sb // sy)
    for a in out:
        a.flags.writeable = False
    return out


def _leg_mask_np(sb_t: int, leg, spec_params, m: int, self_upper=None):
    """In-bounds mask of `leg`'s neighbour over superblock sb_t's slots:
    the nonzero structure a constant-coefficient plane must have.  A self
    leg (`self_upper` True or False) also keeps only the rows whose source
    x-parity is higher (U) or lower (L): inside a superblock the x-parity
    decides the triangle."""
    nx, ny, nz, sx, _sy, _sz = spec_params
    dx, dy, dz = leg
    x, y, z = _slot_coords(spec_params, sb_t, m)
    mask = (x + dx >= 0) & (x + dx < nx)
    if dy:
        mask &= (y + dy >= 0) & (y + dy < ny)
    if dz:
        mask &= (z + dz >= 0) & (z + dz < nz)
    if self_upper is not None:
        ps, pt = (x + dx) % sx, x % sx
        mask &= (ps > pt) if self_upper else (ps < pt)
    return mask


def _plane_const_coeff(plane: np.ndarray, mask: np.ndarray):
    """c if plane == c·mask exactly, else None; a subsample first, so that
    non-constant factors (ILU(0) values) fail at once."""
    probe = plane[:4096]
    pnz = probe[probe != 0]
    if pnz.size and not (pnz == pnz[0]).all():
        return None
    nz = np.flatnonzero(mask)
    if nz.size == 0:
        return None
    c = plane[nz[0]]
    if c == 0:
        return None
    ok = np.array_equal(plane != 0, mask) and (plane[nz] == c).all()
    return float(c) if ok else None


def _const_detect_level(sb: int, cross, selfs, vc, vs, spec_params, m: int,
                        upper: bool):
    """(cross consts ((c, dx, dy, dz), …), self consts ((c, dx), …)) of one
    level, or None where a plane is not coeff × leg mask."""
    cc = []
    for gi, (src, delta) in enumerate(cross):
        leg = _leg_from_delta(sb, src, delta, spec_params)
        c = _plane_const_coeff(vc[gi], _leg_mask_np(sb, leg, spec_params, m))
        if c is None:
            return None
        cc.append((c,) + leg)
    sc = []
    for gi, dx in enumerate(selfs):
        c = _plane_const_coeff(vs[gi], _leg_mask_np(
            sb, (dx, 0, 0), spec_params, m, self_upper=upper))
        if c is None:
            return None
        sc.append((c, dx))
    return tuple(cc), tuple(sc)


def _pack_levels(raw, spec_params, m: int, fused: bool, upper: bool):
    """Const detection on every level (fused layout only, as the JAX
    package runs it), else the planes.  raw: [(sb, cross, selfs, vc, vs)],
    vc/vs (G, m) NumPy at the solve dtype or None.  Returns (levels,
    const_cross, const_self) or (levels, None, None)."""
    levels = tuple((int(sb), cross, selfs) for sb, cross, selfs, _, _ in raw)
    if fused:
        consts = []
        for sb, cross, selfs, vc, vs in raw:
            det = _const_detect_level(
                sb, cross, selfs,
                vc if vc is not None else np.zeros((0, m)),
                vs if vs is not None else np.zeros((0, m)),
                spec_params, m, upper)
            if det is None:
                return levels, None, None
            consts.append(det)
        return (levels, tuple(c for c, _ in consts),
                tuple(s for _, s in consts))
    return levels, None, None


def build_superblock_trisolve(T, D: Optional[np.ndarray], colors: np.ndarray,
                              spec, *, upper: bool, dtype=torch.float32,
                              need_d: bool = False,
                              device="cuda") -> SuperBlockTriSolve:
    """The colour-lower (colour-upper) part of T, the entries with
    colour(j) < colour(i) (>), in superblock form on `device`; D is the
    diagonal to divide by (None: unit).  T is a MatrixCSR or (rows, cols,
    vals, n) triplets.  The JAX package's NumPy branch step for step, its
    refusals in its order: a spec that is no grid, dims, strides
    (BlockIneligibleError), an improper colouring (ImproperColoringError),
    a same-superblock coupling beyond x, a self leg reaching min(nx, 128)
    or more, more than _MAX_GROUPS groups (BlockIneligibleError).  The
    planes are filled at `dtype`, and const detection runs on those values,
    so a float32 and a float64 build may choose different modes, as they do
    in the JAX package."""
    from ..coloring import _grid_coords
    from ..stencil_op import resolve_device
    device = resolve_device(device)
    if spec.kind != "grid":
        raise BlockIneligibleError("superblock path needs a grid coloring")
    rows, cols, vals, n = _entries_of(T)
    nx, ny, nz, sx, sy, sz = (int(p) for p in spec.params)
    if nx * ny * nz != n:
        raise BlockIneligibleError("grid spec dims do not match n_rows")
    if ny % sy or nz % sz:
        raise BlockIneligibleError("grid strides must divide the dims")
    dtype = torch_dtype(dtype)
    np_dt = _np_dtype(dtype)
    fused = not (NO_ALIGNED and not (nx <= LANES and LANES % nx == 0))
    S = sy * sz
    my, mz = ny // sy, nz // sz
    m = nx * my * mz
    X, Y, Z = _grid_coords(np.arange(n, dtype=np.int64), nx, ny)
    SB = (Y % sy) + sy * (Z % sz)
    SLOT = X + nx * ((Y // sy) + my * (Z // sz))

    ci = colors[rows].astype(np.int64)
    cj = colors[cols].astype(np.int64)
    keep = (cj > ci) if upper else (cj < ci)
    if np.any((ci == cj) & (rows != cols)):
        raise ImproperColoringError("coloring is not proper for this "
                                    "pattern")
    rows, cols = rows[keep], cols[keep]
    v = vals[keep]
    sb_i, sb_j = SB[rows], SB[cols]
    is_self = sb_i == sb_j
    if np.any(is_self & ((Y[rows] != Y[cols]) | (Z[rows] != Z[cols]))):
        raise BlockIneligibleError("same-superblock coupling beyond x axis")
    dx_self = X[cols[is_self]] - X[rows[is_self]]
    if is_self.any() and np.abs(dx_self).max() >= min(nx, LANES):
        raise BlockIneligibleError("self coupling reach exceeds a lane row")

    delta = SLOT[cols] - SLOT[rows]
    span = 2 * m + 1
    # cross groups keyed (sb_i, sb_j, Δ), self groups (sb_i, dx)
    ukc, ginvc = _group_inverse(
        ((sb_i * S + sb_j) * span + (delta + m))[~is_self], S * S * span)
    uks, ginvs = _group_inverse(
        sb_i[is_self] * (2 * LANES + 1) + (dx_self + LANES),
        S * (2 * LANES + 1))
    Gc, Gs = ukc.size, uks.size
    if Gc + Gs > _MAX_GROUPS:
        raise BlockIneligibleError(
            f"{Gc + Gs} superblock groups — pattern too irregular")
    gc_tb, gc_sb = (ukc // span) // S, (ukc // span) % S
    gc_dl = (ukc % span) - m
    gs_tb = uks // (2 * LANES + 1)
    gs_dx = (uks % (2 * LANES + 1)) - LANES

    vc = np.zeros((Gc, m), dtype=np_dt)
    vc[ginvc, SLOT[rows[~is_self]]] = v[~is_self].astype(np_dt)
    vs = np.zeros((Gs, m), dtype=np_dt)
    vs[ginvs, SLOT[rows[is_self]]] = v[is_self].astype(np_dt)
    dv = np.ones(n) if D is None else np.asarray(D, dtype=np.float64)
    if np.any(dv == 0):
        raise ValueError("zero diagonal in blocked trisolve")

    raw = []
    for sb in (range(S - 1, -1, -1) if upper else range(S)):
        selc = np.nonzero(gc_tb == sb)[0]
        sels = np.nonzero(gs_tb == sb)[0]
        cidx = sorted(selc, key=lambda g: (int(gc_sb[g]), int(gc_dl[g])))
        sidx = sorted(sels, key=lambda g: int(gs_dx[g]))
        raw.append((sb, tuple((int(gc_sb[g]), int(gc_dl[g])) for g in cidx),
                    tuple(int(gs_dx[g]) for g in sidx),
                    vc[cidx] if cidx else None, vs[sidx] if sidx else None))
    spec_params = (nx, ny, nz, sx, sy, sz)
    levels, cc, cs = _pack_levels(raw, spec_params, m, fused, upper)
    as_t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    common = dict(
        n_rows=n, S=S, m=m, sx=sx, levels=levels, upper=upper,
        spec_params=spec_params, dtype=dtype, fused=fused, unit=D is None,
        dinv_rows=as_t((1.0 / dv).astype(np_dt)),
        d_rows=as_t(dv.astype(np_dt)) if need_d else None)
    if cc is not None:
        return SuperBlockTriSolve(reach=_reach_of(levels, cc),
                                  const_cross=cc, const_self=cs, **common)
    return SuperBlockTriSolve(
        reach=_reach_of(levels, None),
        vals_cross=tuple(None if r[3] is None else as_t(r[3]) for r in raw),
        vals_self=tuple(None if r[4] is None else as_t(r[4]) for r in raw),
        **common)


def _reach_of(levels, const_cross) -> Tuple[int, int, int]:
    """max |d| per axis over a pair's legs (the plain version's zero
    padding): the const legs and self legs, or in plane mode the self legs
    (its cross reads go through slot space)."""
    legs = [(dx, 0, 0) for _sb, _c, selfs in levels for dx in selfs]
    legs += [leg[1:] for lv in (const_cross or ()) for leg in lv]
    return tuple(max([0] + [abs(leg[a]) for leg in legs]) for a in range(3))


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


def _slots(B: SuperBlockTriSolve, v: torch.Tensor, sb: int) -> torch.Tensor:
    """Superblock sb's rows of flat v as an (mz, my, nx) view: slot order
    when flattened."""
    nx, ny, nz, sx, sy, sz = B.spec_params
    return v.view(nz, ny, nx)[sb // sy::sz, sb % sy::sy]


def _plane_cross_acc(B: SuperBlockTriSolve, li: int, y, x):
    """Plane mode: acc = y − Σ_g vals_g ⊙ x(src_g)[t + Δ_g] in slot space,
    a slot outside [0, m) reading 0; every group's values multiplied, zero
    or not, as the JAX package's XLA form does."""
    sb, cross, _selfs = B.levels[li]
    acc = _slots(B, y, sb)
    if not cross:
        return acc
    vals = B.vals_cross[li].to(x.device)
    P = max(abs(delta) for _src, delta in cross)
    padded = {}
    for g, (src, delta) in enumerate(cross):
        if src not in padded:
            padded[src] = F.pad(_slots(B, x, src).reshape(-1), (P, P))
        nb = padded[src][P + delta:P + delta + B.m].view(acc.shape)
        acc = acc - vals[g].view(acc.shape) * nb
    return acc


def _cross_acc(B: SuperBlockTriSolve, li: int, y, x, base):
    """acc = y − Σ_cross f·x(src, Δ) on level li's rows, (mz, my, nx):
    cross legs in (src, Δ) order, each product and difference rounded
    alone.  Out-of-grid neighbours read the zero padding: f·0 leaves acc
    as the JAX package's masked plane does."""
    if B.is_plane:
        return _plane_cross_acc(B, li, y, x)
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
    legs reading xt where their source parity is already solved (0
    elsewhere; plane mode multiplies that 0 by its plane's value)."""
    nx = B.spec_params[0]
    hx = B.reach[0]
    gx = torch.arange(nx, device=xt.device)
    parity = gx % B.sx
    xtp = F.pad(xt, (hx, hx))
    if B.is_plane:
        legs = tuple((f.view(a.shape), dx) for f, dx in zip(
            () if B.vals_self[li] is None else B.vals_self[li].to(xt.device),
            B.levels[li][2]))
    else:
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
    if B.is_table:
        if B.table_dinv is not None:
            a = a * B.table_dinv.to(xt.device)[base]
    elif B.dinv_rows is not None:
        a = a * _slots(B, B.dinv_rows.to(xt.device), B.levels[li][0])
    else:
        a = a * B.dinv
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
    base = _class_base(B, li, x.device) if B.is_table else None
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
    base = _class_base(B, li, x.device) if B.is_table else None
    a = (y.view(nz, ny, nx)[rows] if acc is None
         else acc.view(mz, my, nx))
    X = x.view(nz, ny, nx)
    X[rows] = _parity_step(B, li, p, a, X[rows], base)
    return x


# ---------------------------------------------------------------------------
# One level: the kernels' wrappers
# ---------------------------------------------------------------------------

#: BisSuperLevelArgs.mode (csrc/block_trisolve.cu)
_MODE_CONST, _MODE_TABLE, _MODE_PLANE = 0, 1, 2


def _level_args(B: SuperBlockTriSolve, li: int):
    """The kernels' launch table for level li (cached on B)."""
    from .._build import MAX_LEGS, SuperLevelArgs
    if li in B._args:
        return B._args[li]
    nx, ny, nz, sx, sy, sz = B.spec_params
    sb, groups, self_dx = B.levels[li]
    if B.is_plane:
        cross, selfs = groups, self_dx
    else:
        cross = B.table_cross[li] if B.is_table else B.const_cross[li]
        selfs = B.table_self[li] if B.is_table else B.const_self[li]
    if len(cross) > MAX_LEGS or len(selfs) > MAX_LEGS:
        raise ValueError(f"the kernel takes at most {MAX_LEGS} cross and "
                         f"{MAX_LEGS} self legs a level; level {li} has "
                         f"{len(cross)} and {len(selfs)}")
    a = SuperLevelArgs()
    if B.is_plane:
        a.mode = _MODE_PLANE
        for j, (src, delta) in enumerate(cross):
            a.cross_delta[j] = delta
            a.cross_spy[j], a.cross_spz[j] = src % sy, src // sy
        for j, dx in enumerate(selfs):
            a.self_dx[j] = dx
    else:
        a.mode = _MODE_TABLE if B.is_table else _MODE_CONST
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
    # const mode with a per-row diagonal reads dinv_rows instead
    a.dinv = B.dinv if B.is_const and B.dinv is not None else 1.0
    a.m = B.m
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
    planes = [t for t in (B.vals_cross or ()) + (B.vals_self or ())
              if t is not None]
    for what, t in [("factor table", B.table), ("diagonal", B.dinv_rows)] + [
            ("planes", t) for t in planes]:
        if t is not None and t.device != x.device:
            raise ValueError(f"the {what} is on {t.device}, the vectors on "
                             f"{x.device}")
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


def _planes(B: SuperBlockTriSolve, li: int):
    """(cross values, self values) of level li in plane mode, else
    (None, None)."""
    if not B.is_plane:
        return None, None
    return B.vals_cross[li], B.vals_self[li]


def super_level(B: SuperBlockTriSolve, li: int, y: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """Solve level li of B in place: the rows of its superblock of x from
    y and the superblocks of x already solved; returns x.  y may be x
    itself.

    A CUDA tensor goes through the hand-written kernel, which counts its
    launches in `super_level.launches` (const mode),
    `super_level.table_launches` (factor-table mode) or
    `super_level.plane_launches` (plane mode); a CPU tensor takes the plain
    version."""
    _check_level(B, li, y, x)
    if x.device.type == "cuda":
        vc, vs = _planes(B, li)
        _cuda_call(B, "super_level", x, ctypes.byref(_level_args(B, li)),
                   y.data_ptr(), x.data_ptr(), _ptr(B.table),
                   _ptr(B.table_dinv), _ptr(vc), _ptr(vs),
                   _ptr(B.dinv_rows))
        if B.is_table:
            super_level.table_launches += 1
        elif B.is_plane:
            super_level.plane_launches += 1
        else:
            super_level.launches += 1
        return x
    if x.device.type == "cpu":
        return super_level_plain(B, li, y, x)
    raise ValueError(f"no super-level solve for device {x.device}")


super_level.launches = 0
super_level.table_launches = 0
super_level.plane_launches = 0


def super_solve_mega_plain(B: SuperBlockTriSolve, y: torch.Tensor,
                           x: torch.Tensor) -> torch.Tensor:
    """Plain version of the one-launch solve: every level of B in order
    through super_level_plain, into x (which may be y); returns x."""
    for li in range(len(B.levels)):
        super_level_plain(B, li, y, x)
    return x


def _mega_levels(B: SuperBlockTriSolve, device) -> torch.Tensor:
    """Every level's launch table, in solve order, as bytes on `device`
    (cached on B)."""
    from .._build import SuperLevelArgs
    key = ("mega", str(device))
    if key not in B._args:
        tables = (SuperLevelArgs * len(B.levels))(
            *(_level_args(B, li) for li in range(len(B.levels))))
        B._args[key] = torch.frombuffer(bytearray(bytes(tables)),
                                        dtype=torch.uint8).to(device)
    return B._args[key]


def super_solve_mega(B: SuperBlockTriSolve, y: torch.Tensor,
                     x: torch.Tensor) -> torch.Tensor:
    """A whole fused const-mode solve of B into x (which may be y), every
    level in order; returns x.

    A CUDA tensor goes through the hand-written cooperative kernel, one
    launch for the whole solve, counted in `super_solve_mega.launches`; a
    launch the card refuses raises.  A CPU tensor takes the plain version,
    the per-level loop."""
    _check_vectors(B, 0, y=(y, B.n_rows), x=(x, B.n_rows))
    if not (B.is_const and B.fused):
        raise ValueError("the one-launch solve runs fused const-mode solves "
                         "only")
    if x.device.type == "cuda":
        levels = _mega_levels(B, x.device)
        a = _level_args(B, 0)
        max_blocks = max(_level_args(B, li).grid_x
                         for li in range(len(B.levels)))
        _cuda_call(B, "super_solve_mega", x, levels.data_ptr(),
                   len(B.levels), a.block_x, a.block_y, max_blocks,
                   y.data_ptr(), x.data_ptr(), _ptr(B.dinv_rows))
        super_solve_mega.launches += 1
        return x
    if x.device.type == "cpu":
        return super_solve_mega_plain(B, y, x)
    raise ValueError(f"no one-launch solve for device {x.device}")


super_solve_mega.launches = 0


def mega_grid(B: SuperBlockTriSolve, device) -> int:
    """The blocks of super_solve_mega's grid for B on the CUDA `device`:
    those that fit on the card at once, at most the most line blocks a
    level has."""
    from .._build import load_library
    device = torch.device(device)
    a = _level_args(B, 0)
    return load_library().bis_super_solve_mega_grid(
        device.index or 0, a.block_x * a.block_y,
        max(_level_args(B, li).grid_x for li in range(len(B.levels))),
        torch.empty(0, dtype=B.dtype).element_size())


def _check_split(B: SuperBlockTriSolve, li: int, **vecs):
    if B.is_const:
        raise ValueError("the split route runs factor-table and plane "
                         "solves only")
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
    """Split route, step 1 of level li (factor-table or plane mode): acc
    (m,) gets y − Σ_cross f·x on the level's rows, in slot order; returns
    acc.

    A CUDA tensor goes through the hand-written kernel, which counts its
    launches in `super_acc.launches`, either mode; a CPU tensor takes the
    plain version."""
    device = _check_split(B, li, y=(y, B.n_rows), x=(x, B.n_rows),
                          acc=(acc, B.m))
    if device.type == "cuda":
        _cuda_call(B, "super_acc", x, ctypes.byref(_level_args(B, li)),
                   y.data_ptr(), x.data_ptr(), acc.data_ptr(),
                   _ptr(B.table), _ptr(_planes(B, li)[0]))
        super_acc.launches += 1
        return acc
    if device.type == "cpu":
        return super_acc_plain(B, li, y, x, acc)
    raise ValueError(f"no super-acc step for device {device}")


super_acc.launches = 0


def super_parity(B: SuperBlockTriSolve, li: int, p: int, y: torch.Tensor,
                 acc: Optional[torch.Tensor],
                 x: torch.Tensor) -> torch.Tensor:
    """Split route, step 2 of level li (factor-table or plane mode):
    parity p's rows of the level's superblock of x from acc (y where the
    level has no cross legs and acc is None) and the self legs, in place;
    returns x.

    A CUDA tensor goes through the hand-written kernel, which counts its
    launches in `super_parity.launches`, either mode; a CPU tensor takes
    the plain version."""
    _check_parity_args(B, li, p, y, acc, x)
    if x.device.type == "cuda":
        _cuda_call(B, "super_parity", x, ctypes.byref(_level_args(B, li)),
                   p, y.data_ptr(), _ptr(acc), x.data_ptr(),
                   _ptr(B.table), _ptr(B.table_dinv),
                   _ptr(_planes(B, li)[1]), _ptr(B.dinv_rows))
        super_parity.launches += 1
        return x
    if x.device.type == "cpu":
        return super_parity_plain(B, li, p, y, acc, x)
    raise ValueError(f"no super-parity step for device {x.device}")


super_parity.launches = 0




# ---------------------------------------------------------------------------
# Rank-space solves (host-CSR factors under a mod colouring)
# ---------------------------------------------------------------------------

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
        nx, ny, nz, sx, sy, sz = spec.params
        if nx * ny * nz != n:
            raise BlockIneligibleError("grid spec dims do not match n_rows")
        if nx % sx or ny % sy or nz % sz:
            raise BlockIneligibleError("grid strides must divide the dims")
        return n // (sx * sy * sz)
    raise BlockIneligibleError(
        f"blocked trisolve needs a grid/mod coloring, got {spec.kind!r}")


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
    idx = np.arange(n, dtype=np.int64)
    if spec.kind == "mod":
        rank = idx // spec.params[0]
    else:
        from ..coloring import _grid_coords
        nx, ny, nz, sx, sy, sz = spec.params
        mx, my = nx // sx, ny // sy
        X, Y, Z = _grid_coords(idx, nx, ny)
        rank = (X // sx) + mx * ((Y // sy) + my * (Z // sz))
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


def build_best_trisolve(T, D, colors, spec, *, upper: bool,
                        dtype=torch.float32, need_d: bool = False,
                        device="cuda"):
    """The superblock form under a grid colouring where it applies, else
    the rank-space form.  An improper colouring raises
    ImproperColoringError from either."""
    if spec.kind == "grid":
        try:
            return build_superblock_trisolve(T, D, colors, spec, upper=upper,
                                             dtype=dtype, need_d=need_d,
                                             device=device)
        except ImproperColoringError:
            raise
        except BlockIneligibleError:
            pass
    return build_blocked_trisolve(T, D, colors, spec, upper=upper,
                                  dtype=dtype, need_d=need_d, device=device)


def build_best_trisolve_pair(T, D_L, D_U, colors, spec, *,
                             dtype=torch.float32, need_d: bool = False,
                             device="cuda"):
    """The (lower, upper) pair in one layout, the entries expanded once:
    the superblock form under a grid colouring where both triangles take
    it, else the rank-space form as a pair (blocked_sgs and blocked_ilu0
    feed L's output straight into U)."""
    trip = _entries_of(T)
    if spec.kind == "grid":
        try:
            return (build_superblock_trisolve(trip, D_L, colors, spec,
                                              upper=False, dtype=dtype,
                                              need_d=need_d, device=device),
                    build_superblock_trisolve(trip, D_U, colors, spec,
                                              upper=True, dtype=dtype,
                                              device=device))
        except ImproperColoringError:
            raise
        except BlockIneligibleError:
            pass
    return (build_blocked_trisolve(trip, D_L, colors, spec, upper=False,
                                   dtype=dtype, need_d=need_d,
                                   device=device),
            build_blocked_trisolve(trip, D_U, colors, spec, upper=True,
                                   dtype=dtype, device=device))


def permute_blocks(B: BlockedTriSolve, y: torch.Tensor) -> torch.Tensor:
    """Flat (n,) → the (C, M) colour blocks, rank-ordered, zero-padded."""
    m = B.m
    if B.spec_kind == "mod":
        k = B.spec_params[0]
        arr = F.pad(y, (0, k * m - B.n_rows)).view(m, k).t()
    else:
        nx, ny, nz, sx, sy, sz = B.spec_params
        arr = (y.view(nz // sz, sz, ny // sy, sy, nx // sx, sx)
               .permute(1, 3, 5, 0, 2, 4).reshape(B.n_colors, m))
    return F.pad(arr, (0, B.M - m)).contiguous()


def unpermute_blocks(B: BlockedTriSolve, X: torch.Tensor) -> torch.Tensor:
    """The (C, M) colour blocks → flat (n,)."""
    m = B.m
    if B.spec_kind == "mod":
        k = B.spec_params[0]
        return X[:, :m].t().reshape(k * m)[:B.n_rows]
    nx, ny, nz, sx, sy, sz = B.spec_params
    return (X[:, :m].reshape(sz, sy, sx, nz // sz, ny // sy, nx // sx)
            .permute(3, 0, 4, 1, 5, 2).reshape(B.n_rows))


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
    """All levels in order, into x (which may be y): with MEGA a fused
    const-mode solve in one launch (the JAX package's _mega_eligible
    without its TPU memory budget); else one fused launch a level, or on
    the split route an acc step (where the level has cross legs) and one
    step per x-parity."""
    if MEGA and B.is_const and B.fused:
        return super_solve_mega(B, y, x)
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
    d = L.d if isinstance(L, BlockedTriSolve) or L.d_rows is None \
        else L.d_rows
    if d is None:
        raise ValueError("blocked_sgs needs L built with need_d=True")
    if isinstance(L, BlockedTriSolve):
        T = solve_blocks(L, permute_blocks(L, y), torch.empty(
            (L.n_colors, L.M), dtype=y.dtype, device=y.device)) * L.d
        return unpermute_blocks(U, solve_blocks(U, T, T))
    t = blocked_trisolve(L, y) * d
    return _solve_super(U, t, t)


def blocked_ilu0(L, U, y: torch.Tensor) -> torch.Tensor:
    """U⁻¹L⁻¹y with unit-diagonal L, the coloured ILU(0) apply: the levels
    of L, then the levels of U in place on the same state."""
    if isinstance(L, BlockedTriSolve):
        X = solve_blocks(L, permute_blocks(L, y), torch.empty(
            (L.n_colors, L.M), dtype=y.dtype, device=y.device))
        return unpermute_blocks(U, solve_blocks(U, X, X))
    if not L.unit:
        raise ValueError("blocked_ilu0 needs an ILU(0) pair, whose L solves "
                         "with a unit diagonal: the factor-table pair "
                         "(build_superblock_ilu0_pair_stencil) or one built "
                         "from its factors with D None, not a GS pair")
    x = blocked_trisolve(L, y)
    return _solve_super(U, x, x)
