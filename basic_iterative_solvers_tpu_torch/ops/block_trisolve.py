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

Plane mode (`build_superblock_trisolve`, from host CSR, and the pairs
packed straight off the CSR, `build_superblock_gs_pair_from_csr` and
`build_superblock_ilu0_pair`; the JAX package's builders, their group
analysis and plane scatter native unless BIS_TPU_NO_NATIVE is set, the
NumPy branch the plain version): f is a plane of per-row values over the
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
launch (`super_solve_mega`), on the "brick" route where the solve's x fits
the card's shared memory in one wave of bricks (each block keeps its
brick of x there for the whole solve, as the TPU kernel keeps x in VMEM)
or the "direct" route, picked by `mega_route_for` and its bricks by
`brick_shape`.  The TPU's lane rule stays too: a self leg
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

in one launch (`rank_level`), on the "vec" route (the group table in the
launch's parameters, 16 bytes of slots a thread, one x window a source
colour) or the "scalar" route (a thread a slot), picked once a level by
`rank_route_for`.  A grid colouring of host CSR takes the
superblock form; where that refuses (BlockIneligibleError other than an
improper colouring), the rank-space form with the grid rank
(x//sx) + mx·((y//sy) + my·(z//sz)), as the JAX package falls back.

On a row-sharded mesh (the JAX package's shard_superblock and
_solve_super_mesh) a superblock solve is cut into contiguous row ranges
of whole x-lines (`shard_superblock` → `MeshSuperBlockTriSolve`), each
shard with its own plane values and per-row diagonals; a level runs the
same level kernel once a shard on the shard's rows of y and its window of
x (`super_level_halo`: line offsets, window offsets and global
coordinates in the launch table), then each shard passes the level's
superblock lines inside its halo rows to both neighbours (Mesh.ppermute).

`super_level`, `super_level_halo`, `super_acc`, `super_parity`,
`super_solve_mega` and `rank_level` are the kernels' entry points: on a
CUDA tensor each launches its hand-written kernel (csrc/block_trisolve.cu)
or raises; on a CPU tensor each runs its plain version
(`super_level_plain`, `super_level_halo_plain`, `super_acc_plain`,
`super_parity_plain`, `super_solve_mega_plain`, `rank_level_plain`).  A
level takes one of two routes of the level kernel, chosen by shape, type
and card before the launch (`level_route_for`) and counted apart
(`.table_staged_launches`, `.table_direct_launches`,
`.plane_line_launches`, ...).  A factor-table level: "staged" (float32)
keeps the block's lines, their factors and each x's class in shared
memory, where they fit in 48 KB and the launch fills the card, and
unrolls an interior row's cross legs.  A plane or const level: "line"
keeps the block's lines in shared memory on a block shaped to the launch
(`line_shape`), maps a plane group's slots to source rows with no
division and unrolls a const level's interior legs.  "direct", the
first port's kernel, keeps acc in x.  The split route's steps take the
route the fused level would take, each with kernels of its own that share
the fused kernels' bodies: `super_acc` the staged or line kernel's cross
half (counted in `.staged_launches`, `.line_launches`,
`.direct_launches`), `super_parity` their parity pass on a block shaped to
one parity's rows (`parity_shape`), picked by `split_route_for`.
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
from ..stencil_op import _rounded, sm_count, stencil_shard_rows

#: threads per kernel block (csrc/block_trisolve.cu: __launch_bounds__)
_BLOCK_THREADS = 256

#: the line route's limits (csrc/block_trisolve.cu: BIS_SL_LINE_THREADS,
#: its __launch_bounds__, so at most 64 registers a thread and 1,024
#: resident threads an SM; BIS_SL_LINE_SMEM_MAX), and the threads a block
#: takes where a launch's lines are short enough to pack (line_shape)
LINE_THREADS = 1024
LINE_SMEM_MAX = 48 * 1024
LINE_BLOCK = 256

#: the split parity kernels' resident threads an SM: they take 32
#: registers a thread (ptxas, chip_smoke's [ptxas]), so an SM holds 2,048
PARITY_RESIDENT = 2048

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

#: test hook: skip the native builders (csrc/bis_host.cpp's bis_sb_*) so
#: that the NumPy branch runs with the host library on
FORCE_NUMPY = False


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
    #: the kernels' launch tables per level, and each level's route
    #: (level_route_for) and line shape, built at first launch
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


@dataclasses.dataclass(eq=False)
class SuperBlockShard:
    """One mesh shard's part of a superblock solve B: the shard owns the
    global rows [row0, row0 + rows), whole x-lines, and reads a window of
    `halo` rows more on each side (x_row0 = row0 − halo).  lines[li] =
    (l0, l1): the superblock lines of level li it owns, a contiguous range
    of the superblock's line index ((0, 0) where it owns none).  Its own
    tensors: in plane mode the level's planes on its slots [l0·nx, l1·nx)
    (vals_cross[li] (Gc, (l1 − l0)·nx), vals_self[li]); the per-row 1/D
    (`dinv_rows`) and D (`d_rows`) on its rows, zero past n; in factor-
    table mode the table and its pivots (`table`, `table_dinv`).  All on
    the shard's device."""

    B: SuperBlockTriSolve
    row0: int
    rows: int
    halo: int
    lines: Tuple
    vals_cross: Optional[Tuple] = None
    vals_self: Optional[Tuple] = None
    dinv_rows: Optional[torch.Tensor] = None
    d_rows: Optional[torch.Tensor] = None
    table: Optional[torch.Tensor] = None
    table_dinv: Optional[torch.Tensor] = None
    #: the kernel's launch tables per level, and each level's route
    #: (level_route_for) and line shape, built at first launch
    _args: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def x_row0(self) -> int:
        return self.row0 - self.halo


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
                              need_d: bool = False, device="cuda",
                              _analysis=None) -> SuperBlockTriSolve:
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
    in the JAX package.

    Under a spec's own colouring the groups come from one native pass and
    the planes from a second (csrc/bis_host.cpp's bis_sb_analyze and
    bis_sb_scatter) unless BIS_TPU_NO_NATIVE is set; `_analysis` carries
    the pair builder's one analysis of both triangles.  A structural
    refusal of the native analysis falls to the NumPy branch, which raises
    in its order."""
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
    fused = _fused(nx)
    S = sy * sz
    my, mz = ny // sy, nz // sz
    m = nx * my * mz
    analysis = (_analysis if _analysis is not None
                else _native_analysis_for((rows, cols, vals, n), colors,
                                          spec))
    if analysis is not None:
        from .. import _native
        plan = _sb_plan(analysis, upper, spec)
        vc = np.zeros((max(plan.Gc, 1), m), dtype=np_dt)
        vs = np.zeros((max(plan.Gs, 1), m), dtype=np_dt)
        if not _native.sb_scatter(rows, cols, vals, nx, ny, nz, sx, sy, sz,
                                  upper, plan.ukc, plan.uks, m, vc, vs):
            raise RuntimeError("native host library switched off "
                               "mid-build")
        return _sb_assemble(plan, vc, vs, D, n, spec, upper=upper,
                            dtype=dtype, need_d=need_d, device=device)
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
    raw = []
    for sb in (range(S - 1, -1, -1) if upper else range(S)):
        selc = np.nonzero(gc_tb == sb)[0]
        sels = np.nonzero(gs_tb == sb)[0]
        cidx = sorted(selc, key=lambda g: (int(gc_sb[g]), int(gc_dl[g])))
        sidx = sorted(sels, key=lambda g: int(gs_dx[g]))
        raw.append((sb, tuple((int(gc_sb[g]), int(gc_dl[g])) for g in cidx),
                    tuple(int(gs_dx[g]) for g in sidx),
                    vc[cidx] if cidx else None, vs[sidx] if sidx else None))
    return _sb_finish(raw, D, n, (nx, ny, nz, sx, sy, sz), upper=upper,
                      dtype=dtype, need_d=need_d, fused=fused,
                      device=device)


def _fused(nx: int) -> bool:
    """False where the solve takes the split route: BIS_SB_ALIGNED=0 and
    x-lines that do not tile 128 lanes."""
    return not (NO_ALIGNED and not (nx <= LANES and LANES % nx == 0))


def _sb_finish(raw, D, n: int, spec_params, *, upper: bool, dtype,
               need_d: bool, fused: bool, device) -> SuperBlockTriSolve:
    """The SuperBlockTriSolve of the levels `raw` [(sb, cross, selfs, vc,
    vs)] in solve order: const mode where every plane is coeff × leg mask,
    else plane mode; the per-row diagonal D (None: unit) rounded to
    `dtype`."""
    nx, ny, nz, sx, sy, sz = spec_params
    S, m = sy * sz, nx * (ny // sy) * (nz // sz)
    np_dt = _np_dtype(dtype)
    dv = np.ones(n) if D is None else np.asarray(D, dtype=np.float64)
    if np.any(dv == 0):
        raise ValueError("zero diagonal in blocked trisolve")
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


def spec_colors_valid(colors, spec, n: int) -> bool:
    """True iff `colors` is the spec's own colouring (the native builders
    derive colours from the grid coordinates)."""
    from ..coloring import spec_colors_np
    try:
        return np.array_equal(np.asarray(colors), spec_colors_np(spec, n))
    except ValueError:
        return False


def _native_analysis_for(trip, colors, spec):
    """The native one-pass group discovery of both triangles, or None where
    it does not apply (FORCE_NUMPY, BIS_TPU_NO_NATIVE, no grid spec, dims
    or strides that do not fit, colours other than the spec's, or a
    structural refusal, which the NumPy branch then raises in its order).
    An improper colouring raises ImproperColoringError."""
    rows, cols, vals, n = trip
    if FORCE_NUMPY or spec.kind != "grid":
        return None
    nx, ny, nz, sx, sy, sz = (int(p) for p in spec.params)
    if nx * ny * nz != n or ny % sy or nz % sz or n == 0:
        return None
    if not spec_colors_valid(colors, spec, n):
        return None
    from .. import _native
    return _native.sb_analyze(rows, cols, nx, ny, nz, sx, sy, sz,
                              _MAX_GROUPS + 1)


def _sb_plan(analysis, upper: bool, spec):
    """One triangle's groups decoded from its ascending keys, whose order
    is the level order and, within a level, the sorted group order."""
    nx, ny, nz, sx, sy, sz = (int(p) for p in spec.params)
    S = sy * sz
    m = nx * (ny // sy) * (nz // sz)
    span = 2 * m + 1
    ukc = analysis["cross_up" if upper else "cross_lo"]
    uks = analysis["self_up" if upper else "self_lo"]
    Gc, Gs = len(ukc), len(uks)
    if Gc + Gs > _MAX_GROUPS:
        raise BlockIneligibleError(
            f"{Gc + Gs} superblock groups — pattern too irregular")
    return types.SimpleNamespace(
        ukc=ukc, uks=uks, Gc=Gc, Gs=Gs, gc_tb=(ukc // span) // S,
        gc_sb=(ukc // span) % S, gc_dl=(ukc % span) - m,
        gs_tb=uks // (2 * LANES + 1), gs_dx=(uks % (2 * LANES + 1)) - LANES,
        S=S, m=m)


def _sb_assemble(plan, vc_big, vs_big, D, n: int, spec, *, upper: bool,
                 dtype, need_d: bool, device) -> SuperBlockTriSolve:
    """The SuperBlockTriSolve of one triangle from its plan and the planes
    the native scatter filled in key order: each level's groups are a
    contiguous run of rows."""
    raw = []
    for sb in (range(plan.S - 1, -1, -1) if upper else range(plan.S)):
        c_lo, c_hi = np.searchsorted(plan.gc_tb, [sb, sb + 1])
        s_lo, s_hi = np.searchsorted(plan.gs_tb, [sb, sb + 1])
        raw.append((sb,
                    tuple((int(plan.gc_sb[g]), int(plan.gc_dl[g]))
                          for g in range(c_lo, c_hi)),
                    tuple(int(plan.gs_dx[g]) for g in range(s_lo, s_hi)),
                    vc_big[c_lo:c_hi] if c_hi > c_lo else None,
                    vs_big[s_lo:s_hi] if s_hi > s_lo else None))
    spec_params = tuple(int(p) for p in spec.params)
    return _sb_finish(raw, D, n, spec_params, upper=upper, dtype=dtype,
                      need_d=need_d, fused=_fused(spec_params[0]),
                      device=device)


def _sb_pack_pair_from_csr(Ap, vals, perm, spec, *, D_L, D_U,
                           need_d_L: bool, dtype, device):
    """(L, U, U_D): both triangles of the (colour-permuted) CSR Ap, row i
    being original row perm[i], analysed and scattered in two native
    passes (bis_sb_analyze_csr, bis_sb_scatter_csr) with no triplets; U_D
    the diagonal the scatter peels.  D_L None: unit L; D_U None: U divides
    by U_D.  BlockIneligibleError where the path does not apply."""
    from .. import _native
    from ..stencil_op import resolve_device
    if FORCE_NUMPY or spec.kind != "grid":
        raise BlockIneligibleError("the CSR-direct path needs a grid "
                                   "coloring")
    device = resolve_device(device)
    dtype = torch_dtype(dtype)
    np_dt = _np_dtype(dtype)
    nx, ny, nz, sx, sy, sz = (int(p) for p in spec.params)
    n = Ap.n_rows
    if nx * ny * nz != n or n == 0:
        raise BlockIneligibleError("grid spec dims do not match n_rows")
    if ny % sy or nz % sz:
        raise BlockIneligibleError("grid strides must divide the dims")
    analysis = _native.sb_analyze_csr(Ap, perm, nx, ny, nz, sx, sy, sz,
                                      _MAX_GROUPS + 1)
    if analysis is None:
        raise BlockIneligibleError(
            "native CSR analysis switched off or structurally ineligible")
    plan_L = _sb_plan(analysis, False, spec)
    plan_U = _sb_plan(analysis, True, spec)
    m = plan_L.m
    planes = [np.zeros((max(G, 1), m), dtype=np_dt)
              for G in (plan_L.Gc, plan_L.Gs, plan_U.Gc, plan_U.Gs)]
    U_D = _native.sb_scatter_csr(Ap, vals, perm, nx, ny, nz, sx, sy, sz,
                                 analysis, m, m, *planes)
    if U_D is None:
        raise RuntimeError("native host library switched off mid-build")
    L = _sb_assemble(plan_L, planes[0], planes[1], D_L, n, spec,
                     upper=False, dtype=dtype, need_d=need_d_L,
                     device=device)
    U = _sb_assemble(plan_U, planes[2], planes[3],
                     U_D if D_U is None else D_U, n, spec, upper=True,
                     dtype=dtype, need_d=False, device=device)
    return L, U, U_D


def build_superblock_gs_pair_from_csr(A, D, spec, *, dtype=torch.float32,
                                      need_d: bool = False, device="cuda"):
    """(L, U) of the GS family straight off the natural-order CSR, both
    dividing by the matrix diagonal D (`need_d`: D stored on L for the
    symmetric apply).  BlockIneligibleError where it does not apply."""
    perm = np.arange(A.n_rows, dtype=np.int32)
    L, U, _ = _sb_pack_pair_from_csr(A, A.val, perm, spec, D_L=D, D_U=D,
                                     need_d_L=need_d, dtype=dtype,
                                     device=device)
    return L, U


def build_superblock_ilu0_pair(Ap, lu_val, perm, spec, *,
                               dtype=torch.float32, device="cuda"):
    """(L, U, U_D) of coloured ILU(0) straight off the colour-permuted CSR
    Ap and its factor values: L solves with a unit diagonal, U with the
    peeled factor diagonal U_D.  BlockIneligibleError where it does not
    apply (callers take the triplet pipeline)."""
    return _sb_pack_pair_from_csr(Ap, lu_val, perm, spec, D_L=None,
                                  D_U=None, need_d_L=False, dtype=dtype,
                                  device=device)


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


def _whole(B: SuperBlockTriSolve) -> SuperBlockShard:
    """B as the one shard of a one-shard mesh: every row, no halo, B's own
    planes and diagonals (cached on B).  The single-device plain level is
    this shard's level."""
    Bs = B._args.get("whole")
    if Bs is None:
        Bs = B._args["whole"] = SuperBlockShard(
            B=B, row0=0, rows=B.n_rows, halo=0,
            lines=((0, B.m // B.spec_params[0]),) * len(B.levels),
            vals_cross=B.vals_cross, vals_self=B.vals_self,
            dinv_rows=B.dinv_rows, d_rows=B.d_rows)
    return Bs


def _check_halo(Bs: SuperBlockShard, li: int, y, x):
    _check_vectors(Bs.B, li, y=(y, Bs.rows), x=(x, Bs.rows + 2 * Bs.halo))


def _level_plan(Bs: SuperBlockShard, li: int, device):
    """What the plain level li of shard Bs reads, cached on Bs: (iy, ix,
    base, reads, vs, drows).  iy and ix: the offsets of its rows of the
    level's superblock (lines, nx) into y and into its window of x; base:
    their prototype rows (factor-table mode); reads: per cross leg (plane
    group) the factor (a float, table values or plane values), the window
    index of its source and the in-grid mask (a plane group's slot in
    [0, m)), all from global coordinates; vs: the self planes on those
    rows (plane mode); drows: their per-row 1/D, where B has one."""
    key = ("plain", li, str(device))
    if key in Bs._args:
        return Bs._args[key]
    B = Bs.B
    nx, ny, nz, sx, sy, sz = B.spec_params
    sb = B.levels[li][0]
    my = ny // sy
    line = torch.arange(*Bs.lines[li], device=device)
    gy = sy * (line % my) + sb % sy
    gz = sz * (line // my) + sb // sy
    gx = torch.arange(nx, device=device)
    rows = (nx * (gy + ny * gz))[:, None] + gx
    xr0, top = Bs.x_row0, Bs.rows + 2 * Bs.halo - 1
    base = (_class_base(B, li, device).view(-1, nx)[line] if B.is_table
            else None)
    reads = []
    if B.is_plane:
        t = line[:, None] * nx + gx
        cross = B.levels[li][1]
        vals = Bs.vals_cross[li].to(device) if cross else None
        for g, (src, delta) in enumerate(cross):
            s = t + delta
            ln = s.div(nx, rounding_mode="floor")
            srow = (s - ln * nx) + nx * (
                sy * (ln % my) + src % sy
                + ny * (sz * ln.div(my, rounding_mode="floor") + src // sy))
            reads.append((vals[g].view(rows.shape),
                          (srow - xr0).clamp(0, top), (s >= 0) & (s < B.m)))
    else:
        legs = B.table_cross[li] if B.is_table else B.const_cross[li]
        table = B.table.to(device) if B.is_table else None
        for f, dx, dy, dz in legs:
            ok = ((gx + dx >= 0) & (gx + dx < nx))[None, :] & (
                (gy + dy >= 0) & (gy + dy < ny) & (gz + dz >= 0)
                & (gz + dz < nz))[:, None]
            reads.append((table[f][base] if table is not None else f,
                          (rows + dx + nx * (dy + ny * dz) - xr0).clamp(
                              0, top), ok))
    vs = (None if not B.is_plane or Bs.vals_self[li] is None else
          [f.view(rows.shape) for f in Bs.vals_self[li].to(device)])
    drows = (None if B.is_table or Bs.dinv_rows is None
             else Bs.dinv_rows.to(device)[rows - Bs.row0])
    plan = (rows - Bs.row0, rows - xr0, base, tuple(reads), vs, drows)
    Bs._args[key] = plan
    return plan


def _cross_acc(Bs: SuperBlockShard, li: int, y, x):
    """acc = y − Σ_cross f·x(src, Δ) on shard Bs's rows of level li, (lines,
    nx): cross legs in (src, Δ) order, each product and difference rounded
    alone.  A source outside the grid (a plane slot outside [0, m)) reads
    0: f·0 leaves acc as the JAX package's masked plane does."""
    iy, _ix, _base, reads, _vs, _drows = _level_plan(Bs, li, x.device)
    acc = y[iy]
    for f, src, ok in reads:
        acc = acc - f * torch.where(ok, x[src], 0.0)
    return acc


def _parity_step(B: SuperBlockTriSolve, li: int, p: int, a, xt, base,
                 vs=None, drows=None):
    """xt with parity p's rows set to (a − Σ_self f·x(dx))·D⁻¹, the self
    legs reading xt where their source parity is already solved (0
    elsewhere; plane mode multiplies that 0 by its plane's value).  a, xt
    and base are (…, nx) arrays of whole x-lines; in plane mode `vs` holds
    the self planes on those rows, and `drows` the per-row 1/D where B has
    one."""
    nx = B.spec_params[0]
    hx = B.reach[0]
    gx = torch.arange(nx, device=xt.device)
    parity = gx % B.sx
    xtp = F.pad(xt, (hx, hx))
    if B.is_plane:
        legs = tuple(zip(() if vs is None else vs, B.levels[li][2]))
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
    elif drows is not None:
        a = a * drows
    else:
        a = a * B.dinv
    return torch.where(parity == p, a, xt)


def super_level_halo_plain(Bs: SuperBlockShard, li: int, y: torch.Tensor,
                           x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of one shard's level (the JAX package's
    _super_level_pallas, with row0 on a mesh shard): y holds the shard's
    rows (Bs.rows), x its window (Bs.rows + 2·Bs.halo, global row
    Bs.x_row0 first); writes the rows of level li's superblock the shard
    owns into x and returns x.  Masks, classes and a plane group's
    [0, m) test are global."""
    _check_halo(Bs, li, y, x)
    l0, l1 = Bs.lines[li]
    if l1 == l0:
        return x
    _iy, ix, base, _reads, vs, drows = _level_plan(Bs, li, x.device)
    acc = _cross_acc(Bs, li, y, x)
    xt = torch.zeros_like(acc)
    for p in _parity_order(Bs.B):
        xt = _parity_step(Bs.B, li, p, acc, xt, base, vs, drows)
    x[ix] = xt
    return x


def super_level_plain(B: SuperBlockTriSolve, li: int, y: torch.Tensor,
                      x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the level kernel (the JAX package's
    _super_level_xla in the flat order): writes the rows of level li's
    superblock of x and returns x.  Reads y on those rows and x on the
    superblocks already solved; y may be x itself.  The one-shard case of
    super_level_halo_plain."""
    return super_level_halo_plain(_whole(B), li, y, x)


def super_acc_plain(B: SuperBlockTriSolve, li: int, y: torch.Tensor,
                    x: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """Plain version of the split route's acc kernel (the JAX package's
    _super_acc_pallas): acc (m,), level li's rows in line order, gets
    y − Σ_cross f·x; returns acc."""
    _check_split(B, li, y=(y, B.n_rows), x=(x, B.n_rows), acc=(acc, B.m))
    acc.copy_(_cross_acc(_whole(B), li, y, x).reshape(-1))
    return acc


def super_parity_plain(B: SuperBlockTriSolve, li: int, p: int,
                       y: torch.Tensor, acc: Optional[torch.Tensor],
                       x: torch.Tensor) -> torch.Tensor:
    """Plain version of the split route's parity kernel (the JAX package's
    _super_parity_pallas): parity p's rows of level li's superblock of x
    from acc (or from y when the level has no cross legs and acc is None)
    and the self legs; the level's other rows keep their values."""
    _check_parity_args(B, li, p, y, acc, x)
    iy, ix, base, _reads, vs, drows = _level_plan(_whole(B), li, x.device)
    a = y[iy] if acc is None else acc.view(iy.shape)
    x[ix] = _parity_step(B, li, p, a, x[ix], base, vs, drows)
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
            a.cross_q[j], a.cross_r[j] = divmod(delta, nx)
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
        if cross:
            a.cross_rx, a.cross_ry, a.cross_rz = (
                max(abs(leg[k]) for leg in cross) for k in (1, 2, 3))
    a.n_cross, a.n_self = len(cross), len(selfs)
    # const mode with a per-row diagonal reads dinv_rows instead
    a.dinv = B.dinv if B.is_const and B.dinv is not None else 1.0
    a.m = a.plane_m = B.m
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


def _cuda_call(B: SuperBlockTriSolve, name: str, x: torch.Tensor, *args,
               operands=None, table=None):
    """Launch `bis_<name>_<dtype>` with level args `args` on x's device and
    stream (_build.launch); raises on a CUDA error.  `operands`: the
    planes and per-row diagonal the launch reads (B's own when None);
    `table`: the factor table it reads (B's own when None)."""
    from .._build import launch, load_library
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the superblock kernels take float32 or float64, "
                        f"not {x.dtype}")
    if operands is None:
        operands = (B.vals_cross or ()) + (B.vals_self or ()) + (
            B.dinv_rows,)
    table = B.table if table is None else table
    for what, t in [("factor table", table)] + [
            ("planes or diagonal", t) for t in operands]:
        if t is not None and t.device != x.device:
            raise ValueError(f"the {what} is on {t.device}, the vectors on "
                             f"{x.device}")
    lib = load_library()
    dt = "f32" if x.dtype == torch.float32 else "f64"
    fn = getattr(lib, f"bis_{name}_{dt}")
    err = launch(fn, x.device, *args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error "
                           f"{err}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def line_shape(nx: int, sx: int, lines: int, n_groups: int, itemsize: int,
               sms: int) -> Optional[Tuple[int, int]]:
    """(tl, lb): the line route's block for a launch of `lines` x-lines of
    nx rows (x-parities sx, `n_groups` plane cross groups, 0 in const
    mode, vectors of `itemsize` bytes) on a card of `sms`
    multiprocessors; None where one line's buffer exceeds LINE_SMEM_MAX.
    Threads a line tl: as many as keep the launch within one wave of the
    card's resident threads (sms × LINE_THREADS), a power of two, at most
    one a row (at most LINE_THREADS), at least a warp where a line has
    that many rows.  Lines a block lb: doubled while the block stays
    within LINE_BLOCK threads and LINE_SMEM_MAX bytes and the grid keeps
    a block for every SM.  On the H100 (scripts/superblock_line_sweep.py,
    every block timed) this gives 128 threads a line at fdm:2048 (1–8%
    above the fastest block on three of its four levels, 32% on the level
    with no cross group, where 256 was fastest), 1,024 on its 8-shard
    launches (the fastest) and 32 at 128³ (0–5% above the fastest)."""
    line_bytes = nx * itemsize + 8 * n_groups
    if line_bytes > LINE_SMEM_MAX:
        return None
    return _block_shape(nx, lines, line_bytes, 0, sms)


def _block_shape(rows: int, lines: int, line_bytes: int, fixed_bytes: int,
                 sms: int, resident: int = LINE_THREADS) -> Tuple[int, int]:
    """(tl, lb) for a launch of `lines` lines of `rows` rows a thread
    pass, `line_bytes` of shared memory a line and `fixed_bytes` a block:
    tl the power of two that keeps the launch within one wave of the
    card's resident threads (`resident` an SM), at least a warp where a
    line has that many rows, at most one a row; lb doubled while the block
    stays within LINE_BLOCK threads and LINE_SMEM_MAX bytes and the grid
    has a block an SM."""
    tl_max = min(LINE_THREADS, 1 << (rows - 1).bit_length())
    tl = 1 << (max(1, sms * resident // max(1, lines)).bit_length() - 1)
    tl = max(min(32, tl_max), min(tl, tl_max))
    lb = 1
    while (2 * lb * tl <= LINE_BLOCK
           and fixed_bytes + 2 * lb * line_bytes <= LINE_SMEM_MAX
           and -(-lines // (2 * lb)) >= sms):
        lb *= 2
    return tl, lb


def parity_shape(nx: int, sx: int, lines: int, line_bytes: int,
                 sms: int) -> Tuple[int, int]:
    """(tl, lb): the block of a split parity launch (the staged and line
    routes of `super_parity`) of `lines` x-lines of nx rows under sx
    x-parities on a card of `sms` multiprocessors, `line_bytes` of shared
    memory a line (factor-table mode: the line's self-leg factors and
    pivots; plane mode: 0).  A parity launch updates ⌈nx/sx⌉ rows a line,
    so the line route's rule (`_block_shape`) runs on that many rows, with
    a rule of its own for the card's resident threads: the parity kernels
    take 32 registers, an SM holds PARITY_RESIDENT (2,048) of them, and a
    row does far less work than in a fused level, so thread k of a line
    takes rows p + sx·k, p + sx·(k + tl), … with one parity's rows of the
    launch spread over those 2,048 an SM.  On the H100 (scripts/
    split_route_ab.py --sweep, every block timed): at fdm:2048, 256 × 1
    (four rows a thread), the fastest block on the L levels and 5–15%
    above it on the U levels, where the line route's 1,024 an SM gave
    128 × 2, 27–33% above the fastest; at 384³, 32 × 8 (six rows a
    thread), within 1% of the fastest block on every level."""
    return _block_shape(-(-nx // sx), lines, line_bytes,
                        4 * ((nx + 3) & ~3) if line_bytes else 0, sms,
                        PARITY_RESIDENT)


def _launch_lines(B: SuperBlockTriSolve, li: int,
                  shard: Optional["SuperBlockShard"]) -> int:
    """The superblock lines a launch of level li covers: all of them, or
    those mesh shard `shard` owns."""
    l0, l1 = (0, B.m // B.spec_params[0]) if shard is None \
        else shard.lines[li]
    return l1 - l0


def _card_index(device) -> int:
    """The index of the card `device` names ("cuda" alone: the current
    one): routes and shapes are kept per card, keyed on the launch's
    device, which the caller must give."""
    if device is None:
        raise ValueError("a route is picked for the launch's device: pass "
                         "it")
    device = torch.device(device)
    return torch.cuda.current_device() if device.index is None else \
        device.index


def _line_shape(B: SuperBlockTriSolve, li: int, itemsize: int,
                shard: Optional["SuperBlockShard"], index: int):
    """line_shape of level li's launch (the whole level's, or mesh shard
    `shard`'s part) on card `index`, kept with the launch table."""
    cache = B._args if shard is None else shard._args
    key = ("line_shape", li, itemsize, index)
    if key not in cache:
        cache[key] = line_shape(
            B.spec_params[0], B.sx, _launch_lines(B, li, shard),
            len(B.levels[li][1]) if B.is_plane else 0, itemsize,
            sm_count(index))
    return cache[key]


def level_route_for(B: SuperBlockTriSolve, li: int, itemsize: int,
                    shard: Optional["SuperBlockShard"] = None,
                    device=None) -> str:
    """The route of a launch of level li (the whole level's, or mesh shard
    `shard`'s part) on `device` for vectors of `itemsize` bytes.

    Factor-table mode: "staged" for float32 where the kernel's shared
    memory takes the level's lines and factors (at most 48 KB), its row
    offsets fit 32 bits and its grid has a block for every SM
    (csrc/block_trisolve.cu: bis_super_level_staged_grid; it runs 8 lines
    a block, so a mesh shard's launch at 128³ has 64 blocks, and there the
    direct route, 2 lines a block, ran faster); else "direct" (in float64
    the staged kernel needs twice the registers and shared memory a row,
    and the direct route ran faster on the H100 at 128³).

    Plane and const modes: "line" where the launch's rows fill the card's
    resident threads (lines × nx ≥ sms × LINE_THREADS), one line's buffer
    fits the line kernel's shared memory (line_shape) and the window's
    row offsets fit 32 bits; else "direct" (a launch that leaves threads
    idle gives each row its own thread there: at 128³ the 8 launches of
    an 8-shard mesh level, 512 lines each, ran 10–13% faster on it than
    on the line route's fastest block wherever the level has cross legs,
    2.5% slower on the level with none).

    The shape, type and card alone decide: worked out at the first launch
    and kept with the launch table (B's, or the shard's)."""
    index = _card_index(device)
    cache = B._args if shard is None else shard._args
    key = ("route", li, itemsize, index)
    if key not in cache:
        route = "direct"
        if B.is_table:
            if itemsize == 4 and B.n_rows < 2 ** 31:
                from .._build import load_library
                args = _level_args(B, li) if shard is None else _shard_args(
                    shard, li)
                grid = load_library().bis_super_level_staged_grid(
                    ctypes.byref(args))
                route = "staged" if grid >= sm_count(index) else "direct"
        else:
            window = B.n_rows if shard is None else (shard.rows
                                                     + 2 * shard.halo)
            fills = (_launch_lines(B, li, shard) * B.spec_params[0]
                     >= sm_count(index) * LINE_THREADS)
            if (fills and max(B.n_rows, window) < 2 ** 31 and _line_shape(
                    B, li, itemsize, shard, index) is not None):
                route = "line"
        cache[key] = route
    return cache[key]


def _launch_level(B: SuperBlockTriSolve, li: int, args, y, x, counter,
                  vc=None, vs=None, drows=None, operands=None, shard=None):
    """One level launch with the launch table `args` (the whole level's,
    or mesh shard `shard`'s), on `level_route_for`'s route, counted on
    `counter` (super_level or super_level_halo): in its mode's count and
    its mode and route's (`table_staged_launches`, `plane_line_launches`,
    `const_direct_launches`, ...)."""
    route = level_route_for(B, li, x.element_size(), shard, x.device)
    if B.is_table:
        table, tdinv = ((B.table, B.table_dinv) if shard is None
                        else (shard.table, shard.table_dinv))
        if route == "staged":
            _cuda_call(B, "super_level_staged", x, ctypes.byref(args),
                       y.data_ptr(), x.data_ptr(), _ptr(table), _ptr(tdinv),
                       operands=(), table=table)
        else:
            _cuda_call(B, "super_level", x, ctypes.byref(args),
                       y.data_ptr(), x.data_ptr(), _ptr(table), _ptr(tdinv),
                       None, None, None, operands=(), table=table)
        counter.table_launches += 1
        mode = "table"
    else:
        if route == "line":
            shape = _line_shape(B, li, x.element_size(), shard,
                                x.device.index)
            if shape is None:
                raise ValueError(f"level {li}'s lines do not fit the line "
                                 "route's shared memory")
            _cuda_call(B, "super_level_line", x, ctypes.byref(args), *shape,
                       y.data_ptr(), x.data_ptr(), _ptr(vc), _ptr(vs),
                       _ptr(drows), operands=operands)
        else:
            _cuda_call(B, "super_level", x, ctypes.byref(args), y.data_ptr(),
                       x.data_ptr(), None, None, _ptr(vc), _ptr(vs),
                       _ptr(drows), operands=operands)
        if B.is_plane:
            counter.plane_launches += 1
            mode = "plane"
        else:
            counter.launches += 1
            mode = "const"
    attr = f"{mode}_{route}_launches"
    setattr(counter, attr, getattr(counter, attr) + 1)


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

    A CUDA tensor goes through the hand-written kernel on
    `level_route_for`'s route, which counts its launches in
    `super_level.launches` (const mode), `super_level.table_launches`
    (factor-table mode) or `super_level.plane_launches` (plane mode), and
    each mode's routes apart (`.table_staged_launches`,
    `.table_direct_launches`, `.plane_line_launches`,
    `.plane_direct_launches`, `.const_line_launches`,
    `.const_direct_launches`); a CPU tensor takes the plain version."""
    _check_level(B, li, y, x)
    if x.device.type == "cuda":
        vc, vs = _planes(B, li)
        _launch_level(B, li, _level_args(B, li), y, x, super_level, vc, vs,
                      B.dinv_rows)
        return x
    if x.device.type == "cpu":
        return super_level_plain(B, li, y, x)
    raise ValueError(f"no super-level solve for device {x.device}")


def _zero_counts(counter):
    counter.launches = counter.table_launches = counter.plane_launches = 0
    for name in ("table_staged", "table_direct", "plane_line",
                 "plane_direct", "const_line", "const_direct"):
        setattr(counter, f"{name}_launches", 0)


_zero_counts(super_level)


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


#: threads a block of the brick route (csrc/block_trisolve.cu:
#: BIS_SB_BRICK_THREADS, its __launch_bounds__ with one block an SM: 128
#: registers a thread, room for a level's leg offsets and coefficients)
BRICK_THREADS = 512
#: the brick tables' layout (csrc/block_trisolve.cu: BIS_SB_BRICK_HDR,
#: BIS_SB_BRICK_COEF, BIS_SB_BRICK_OFFS): a level's shared part holds
#: BRICK_HDR ints of scalars, BRICK_COEF coefficients in the vectors'
#: type and BRICK_OFFS ints of leg offsets
BRICK_HDR, BRICK_COEF, BRICK_OFFS = 16, 64, 64


def brick_parts(itemsize: int, by: int, bz: int, ry: int, rz: int, sy: int,
                sz: int) -> Tuple[int, int]:
    """(shared, part): the ints of a level's shared part of the brick
    tables and of its part for one brick (csrc/block_trisolve.cu:
    brick_shared, brick_part), each a multiple of 4."""
    shared = BRICK_HDR + BRICK_COEF * itemsize // 4 + BRICK_OFFS
    frame = (by + 2 * ry) * (bz + 2 * rz) - by * bz
    return shared, -(-(2 * (by // sy) * (bz // sz) + 2 + 2 * frame) // 4) * 4


def brick_smem(n_levels: int, by: int, bz: int, rx: int, ry: int, rz: int,
               sy: int, sz: int, nx: int, itemsize: int, drows: bool) -> int:
    """Dynamic shared memory of a brick launch (csrc/block_trisolve.cu:
    brick_smem): the block's part of the brick tables (brick_tables), with
    a per-row D (`drows`) a stage of a level's 1/D on the brick's lines,
    and the brick framed by the cross legs' reach (rx, ry, rz): (by + 2ry)
    × (bz + 2rz) lines of nx + 2rx values."""
    shared, part = brick_parts(itemsize, by, bz, ry, rz, sy, sz)
    window = (by + 2 * ry) * (bz + 2 * rz)
    lines = (by // sy) * (bz // sz)
    return (n_levels * (shared + part) * 4
            + (-(-lines * nx * itemsize // 16) * 16 if drows else 0)
            + window * (nx + 2 * rx) * itemsize)


def _brick_frame(B: SuperBlockTriSolve) -> Tuple[int, int, int]:
    """(rx, ry, rz): the frame of B's bricks, the largest |dx| of its legs
    (cross and self: a line's x margin) and |dy|, |dz| of its cross
    legs."""
    legs = [leg[1:] for lv in B.const_cross for leg in lv]
    legs += [(leg[1], 0, 0) for lv in B.const_self for leg in lv]
    return tuple(max([0] + [abs(leg[k]) for leg in legs]) for k in range(3))


def _brick_smem_of(B: SuperBlockTriSolve, by: int, bz: int,
                   itemsize: int) -> int:
    nx, _ny, _nz, _sx, sy, sz = B.spec_params
    return brick_smem(len(B.levels), by, bz, *_brick_frame(B), sy, sz, nx,
                      itemsize, B.dinv_rows is not None)


def brick_tables(B: SuperBlockTriSolve, shape, itemsize: int) -> np.ndarray:
    """The brick route's tables for B on bricks `shape` (brick_shape), as
    int32 (csrc/block_trisolve.cu: the brick tables): first each level's
    shared part (cross legs, self legs, sx, upper; the coefficients and 1/D
    in the vectors' type; each cross leg's offset in the framed brick and
    each self leg's dx), then for each brick (b mod nby, b / nby) and level
    its part: a (place, row) pair for each of the level's lines of the
    brick, line k = iy + (ey/sy)·iz at (y0 + py + sy·iy, z0 + pz + sz·iz)
    (place: the line's x = 0 in the framed brick; row: its global row),
    the count of frame lines the level's cross legs read (their source
    lines outside the brick, inside the grid), a pad, and a (place, row)
    pair for each, from its shape alone."""
    nx, ny, nz, sx, sy, sz = B.spec_params
    by, bz = shape[:2]
    rx, ry, rz = _brick_frame(B)
    fy, ls = by + 2 * ry, nx + 2 * rx
    n_lv = len(B.levels)
    shared, part = brick_parts(itemsize, by, bz, ry, rz, sy, sz)
    kmax = (by // sy) * (bz // sz)
    np_dt = np.float32 if itemsize == 4 else np.float64
    head = np.zeros((n_lv, shared), np.int32)
    for li in range(n_lv):
        cross, selfs = B.const_cross[li], B.const_self[li]
        head[li, :4] = (len(cross), len(selfs), sx, int(B.upper))
        coef = np.zeros(BRICK_COEF, np_dt)
        coef[:len(cross)] = [leg[0] for leg in cross]
        coef[BRICK_COEF // 2:BRICK_COEF // 2 + len(selfs)] = [
            leg[0] for leg in selfs]
        coef[-1] = B.dinv if B.dinv is not None else 1.0
        head[li, BRICK_HDR:shared - BRICK_OFFS] = coef.view(np.int32)
        offs = head[li, shared - BRICK_OFFS:]
        offs[:len(cross)] = [(dz * fy + dy) * ls + dx
                             for _c, dx, dy, dz in cross]
        offs[BRICK_OFFS // 2:BRICK_OFFS // 2 + len(selfs)] = [
            dx for _c, dx in selfs]
    nby, nbz = -(-ny // by), -(-nz // bz)
    parts = np.zeros((nby * nbz, n_lv, part), np.int64)
    for b in range(nby * nbz):
        y0, z0 = (b % nby) * by, (b // nby) * bz
        ey, ez = min(by, ny - y0), min(bz, nz - z0)
        for li, (sb, _groups, _selfs) in enumerate(B.levels):
            iy, iz = np.meshgrid(np.arange(ey // sy), np.arange(ez // sz))
            gy = (y0 + sb % sy + sy * iy).reshape(-1)
            gz = (z0 + sb // sy + sz * iz).reshape(-1)
            K = gy.size
            parts[b, li, 0:2 * K:2] = ((gz - z0 + rz) * fy + gy - y0 + ry) \
                * ls + rx
            parts[b, li, 1:2 * K:2] = nx * (gy + ny * gz)
            legs = np.array([leg[2:] for leg in B.const_cross[li]],
                            np.int64).reshape(-1, 2)
            qy = (gy[:, None] + legs[None, :, 0]).reshape(-1)
            qz = (gz[:, None] + legs[None, :, 1]).reshape(-1)
            out = ~((qy >= y0) & (qy < y0 + ey) & (qz >= z0) & (qz < z0 + ez))
            ok = out & (qy >= 0) & (qy < ny) & (qz >= 0) & (qz < nz)
            src = np.unique(np.stack([qz[ok], qy[ok]], 1), axis=0)
            n_fr = len(src)
            parts[b, li, 2 * kmax] = n_fr
            fr = parts[b, li, 2 * kmax + 2:2 * kmax + 2 + 2 * n_fr]
            fr[0::2] = ((src[:, 0] - z0 + rz) * fy + src[:, 1] - y0 + ry) \
                * ls + rx
            fr[1::2] = nx * (src[:, 1] + ny * src[:, 0])
    if parts.size and parts.max() >= 2 ** 31:
        raise ValueError("the brick tables exceed 32-bit offsets")
    return np.concatenate([head.reshape(-1),
                           parts.astype(np.int32).reshape(-1)])


def _brick_tables_on(B: SuperBlockTriSolve, x: torch.Tensor) -> torch.Tensor:
    """brick_tables for B's cached brick shape on x's card, as int32 on
    that card (cached with the launch tables, by shape)."""
    item, index = x.element_size(), x.device.index
    shape = B._args[("brick_shape", item, index)]
    if shape is None:
        raise ValueError("the solve has no brick shape on this card")
    key = ("brick_tables", item, index, shape)
    if key not in B._args:
        B._args[key] = torch.from_numpy(brick_tables(B, shape, item)).to(
            x.device)
    return B._args[key]


def brick_shape(B: SuperBlockTriSolve, itemsize: int, sms: int,
                smem_per_block: int) -> Optional[Tuple[int, int, int, int]]:
    """(by, bz, tl, lb): the brick route's bricks and block for the const
    solve B with vectors of `itemsize` bytes on a card of `sms`
    multiprocessors giving a block `smem_per_block` bytes of shared
    memory; None where the solve's x does not fit the card's shared
    memory in one wave of bricks.

    A brick is by × bz (y, z) x-lines, by and bz multiples of sy and sz
    (the last brick of an axis may be shorter, still a multiple), a block
    a brick, at most `sms` bricks (one wave, one block an SM).  Among the
    extents whose shared memory (brick_smem: the framed brick, with the
    stage of a per-row D where B has one) fits, the fewest lines a brick,
    then the squarest, then the longest along y (whose lines lie next to
    each other in memory): 16 × 8 lines at 128³ (128 bricks), 16 × 1 on
    fdm:2048 (128).  The block: BRICK_THREADS threads, tl along x (a
    power of two, at least a warp where a line has that many rows, at most
    one a row) and lb of the K = (by/sy)·(bz/sz) lines a level has in a
    brick: 32 × 16 at 128³, 64 × 8 on fdm:2048."""
    nx, ny, nz, sx, sy, sz = B.spec_params
    if B.n_rows * itemsize > sms * smem_per_block:
        return None
    best = None
    for by in range(sy, ny + 1, sy):
        nbz = sms // -(-ny // by)
        if nbz < 1:
            continue
        bz = -(-nz // nbz)
        bz = -(-bz // sz) * sz
        if _brick_smem_of(B, by, bz, itemsize) > smem_per_block:
            continue
        key = (by * bz, by + bz, -by)
        if best is None or key < best[0]:
            best = (key, by, bz)
    if best is None:
        return None
    _key, by, bz = best
    K = (by // sy) * (bz // sz)
    tl_max = min(BRICK_THREADS, 1 << (nx - 1).bit_length())
    tl = max(min(32, tl_max),
             min(BRICK_THREADS >> (K - 1).bit_length(), tl_max))
    return by, bz, tl, min(K, BRICK_THREADS // tl)


def brick_count(B: SuperBlockTriSolve, shape) -> int:
    """The bricks (blocks) of a brick launch of B with `shape`."""
    _nx, ny, nz = B.spec_params[:3]
    return -(-ny // shape[0]) * -(-nz // shape[1])


def _brick_card(index: int) -> Tuple[int, int]:
    """(multiprocessors, shared memory a block may take) of card `index`."""
    from .._build import load_library, query
    return sm_count(index), query(
        load_library().bis_super_solve_brick_smem_optin, index)


def _brick_resident(index: int, itemsize: int, threads: int,
                    smem: int) -> int:
    """The brick kernel's blocks that card `index` holds at once with
    `threads` a block and `smem` bytes of dynamic shared memory; 0 where
    it cannot launch them cooperatively."""
    from .._build import load_library, query
    return query(load_library().bis_super_solve_brick_resident, index,
                 itemsize, threads, smem)


def mega_route_for(B: SuperBlockTriSolve, itemsize: int,
                   device=None) -> str:
    """The route of the one-launch solve of B on `device` for vectors of
    `itemsize` bytes: "brick" where the card launches cooperatively, the
    bricks of brick_shape (the solve's x in the card's shared memory) fit
    on it at once at the brick's shared memory (csrc/block_trisolve.cu:
    bis_super_solve_brick_resident) and the rows fit 32-bit offsets;
    "direct" (the first port's kernel, x in global memory) elsewhere, e.g.
    384³ (226 MB of x) or fdm:2048 in float64 (33.6 MB, more than 132 ×
    227 KB).  Worked out at the first launch and kept with the launch
    tables, with the brick shape."""
    index = _card_index(device)
    key = ("mega_route", itemsize, index)
    if key not in B._args:
        route, shape = "direct", None
        if B.is_const and B.fused and B.n_rows < 2 ** 31:
            sms, smem_max = _brick_card(index)
            shape = brick_shape(B, itemsize, sms, smem_max)
            if shape is not None and brick_count(B, shape) <= _brick_resident(
                    index, itemsize, shape[2] * shape[3],
                    _brick_smem_of(B, *shape[:2], itemsize)):
                route = "brick"
        B._args[("brick_shape", itemsize, index)] = shape
        B._args[key] = route
    return B._args[key]


def _brick_args(B: SuperBlockTriSolve, x: torch.Tensor):
    """The brick launch's arguments after its launch tables: the grid, its
    (y, z) strides, the frame and the cached brick shape."""
    nx, ny, nz, _sx, sy, sz = B.spec_params
    shape = B._args[("brick_shape", x.element_size(), x.device.index)]
    if shape is None:
        raise ValueError("the solve has no brick shape on this card")
    return (nx, ny, nz, sy, sz, *_brick_frame(B), *shape)


def super_solve_mega(B: SuperBlockTriSolve, y: torch.Tensor,
                     x: torch.Tensor) -> torch.Tensor:
    """A whole fused const-mode solve of B into x (which may be y), every
    level in order; returns x.

    A CUDA tensor goes through a hand-written cooperative kernel, one
    launch for the whole solve, on `mega_route_for`'s route: "brick"
    (each block keeps its brick of x in shared memory from the first level
    to the last) or "direct" (the first port's kernel); counted in
    `super_solve_mega.launches` and by route in `.brick_launches` and
    `.direct_launches`.  A launch the card refuses raises.  A CPU tensor
    takes the plain version, the per-level loop."""
    _check_vectors(B, 0, y=(y, B.n_rows), x=(x, B.n_rows))
    if not (B.is_const and B.fused):
        raise ValueError("the one-launch solve runs fused const-mode solves "
                         "only")
    if x.device.type == "cuda":
        if mega_route_for(B, x.element_size(), x.device) == "brick":
            _cuda_call(B, "super_solve_brick", x,
                       _brick_tables_on(B, x).data_ptr(), len(B.levels),
                       *_brick_args(B, x), y.data_ptr(), x.data_ptr(),
                       _ptr(B.dinv_rows))
            super_solve_mega.brick_launches += 1
        else:
            levels = _mega_levels(B, x.device)
            a = _level_args(B, 0)
            max_blocks = max(_level_args(B, li).grid_x
                             for li in range(len(B.levels)))
            _cuda_call(B, "super_solve_mega", x, levels.data_ptr(),
                       len(B.levels), a.block_x, a.block_y, max_blocks,
                       y.data_ptr(), x.data_ptr(), _ptr(B.dinv_rows))
            super_solve_mega.direct_launches += 1
        super_solve_mega.launches += 1
        return x
    if x.device.type == "cpu":
        return super_solve_mega_plain(B, y, x)
    raise ValueError(f"no one-launch solve for device {x.device}")


super_solve_mega.launches = 0
super_solve_mega.brick_launches = 0
super_solve_mega.direct_launches = 0


def brick_barrier_floor(B: SuperBlockTriSolve, y: torch.Tensor,
                        x: torch.Tensor) -> None:
    """The brick launch of B with no rows and no legs on CUDA tensors: its
    launch tables copied and its grid barriers met, nothing written (the
    barrier floor a brick solve's time is read against; not counted)."""
    if mega_route_for(B, x.element_size(), x.device) != "brick":
        raise ValueError("the solve does not take the brick route")
    _cuda_call(B, "super_solve_brick_floor", x,
               _brick_tables_on(B, x).data_ptr(), len(B.levels),
               *_brick_args(B, x), y.data_ptr(), x.data_ptr(),
               _ptr(B.dinv_rows))


def mega_grid(B: SuperBlockTriSolve, device) -> int:
    """The blocks of super_solve_mega's grid for B on the CUDA `device`:
    on the brick route its bricks; on the direct route those that fit on
    the card at once, at most the most line blocks a level has."""
    from .._build import load_library, query
    device = torch.device(device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    item = torch.empty(0, dtype=B.dtype).element_size()
    if mega_route_for(B, item, device) == "brick":
        return brick_count(B, B._args[("brick_shape", item, device.index)])
    a = _level_args(B, 0)
    return query(
        load_library().bis_super_solve_mega_grid, device.index,
        a.block_x * a.block_y,
        max(_level_args(B, li).grid_x for li in range(len(B.levels))), item)


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


def split_route_for(B: SuperBlockTriSolve, li: int, itemsize: int,
                    step: str, device=None) -> str:
    """The route of a split step ("acc" or "parity") of level li: the
    route the fused level takes (`level_route_for`, kept with the launch
    table), but for a factor table's parity step in float64, which takes
    "staged" where the float32 level would.  On the H100 at 384³ (scripts/
    split_route_ab.py) the staged parity step ran 0.128–0.129 ms against
    the direct route's 0.158–0.159 in float64, and the staged acc step
    0.594–0.606 against 0.405–0.409, so float64 acc steps stay direct, as
    the fused float64 levels do."""
    route = level_route_for(B, li, itemsize, device=device)
    if B.is_table and step == "parity" and itemsize == 8:
        route = level_route_for(B, li, 4, device=device)
    return route


def _parity_shape(B: SuperBlockTriSolve, li: int, itemsize: int,
                  index: int) -> Tuple[int, int]:
    """parity_shape of level li's parity launches on card `index`, kept
    with the launch table."""
    key = ("parity_shape", li, itemsize, index)
    if key not in B._args:
        nx = B.spec_params[0]
        line_bytes = ((len(B.levels[li][2]) + 1) * B.proto[0] * itemsize
                      if B.is_table else 0)
        B._args[key] = parity_shape(nx, B.sx, B.m // nx, line_bytes,
                                    sm_count(index))
    return B._args[key]


def _count_route(counter, route: str) -> None:
    counter.launches += 1
    attr = f"{route}_launches"
    setattr(counter, attr, getattr(counter, attr) + 1)


def super_acc(B: SuperBlockTriSolve, li: int, y: torch.Tensor,
              x: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """Split route, step 1 of level li (factor-table or plane mode): acc
    (m,) gets y − Σ_cross f·x on the level's rows, in slot order; returns
    acc.

    A CUDA tensor goes through a hand-written kernel on the route the
    fused level would take (`split_route_for`): "staged" (factor table,
    float32: the staged kernel's cross half, the line's factors in shared
    memory), "line" (plane mode: the line kernel's cross half on
    `line_shape`'s block) or "direct" (the first port's kernel).  Counted
    in `super_acc.launches` and by route in `.staged_launches`,
    `.line_launches`, `.direct_launches`.  A CPU tensor takes the plain
    version."""
    device = _check_split(B, li, y=(y, B.n_rows), x=(x, B.n_rows),
                          acc=(acc, B.m))
    if device.type == "cuda":
        item = x.element_size()
        route = split_route_for(B, li, item, "acc", device)
        args = ctypes.byref(_level_args(B, li))
        vc = _planes(B, li)[0]
        if route == "staged":
            _cuda_call(B, "super_acc_staged", x, args, y.data_ptr(),
                       x.data_ptr(), acc.data_ptr(), _ptr(B.table),
                       operands=())
        elif route == "line":
            _cuda_call(B, "super_acc_line", x, args,
                       *_line_shape(B, li, item, None, device.index),
                       y.data_ptr(), x.data_ptr(), acc.data_ptr(), _ptr(vc))
        else:
            _cuda_call(B, "super_acc", x, args, y.data_ptr(), x.data_ptr(),
                       acc.data_ptr(), _ptr(B.table), _ptr(vc))
        _count_route(super_acc, route)
        return acc
    if device.type == "cpu":
        return super_acc_plain(B, li, y, x, acc)
    raise ValueError(f"no super-acc step for device {device}")


def super_parity(B: SuperBlockTriSolve, li: int, p: int, y: torch.Tensor,
                 acc: Optional[torch.Tensor],
                 x: torch.Tensor) -> torch.Tensor:
    """Split route, step 2 of level li (factor-table or plane mode):
    parity p's rows of the level's superblock of x from acc (y where the
    level has no cross legs and acc is None) and the self legs, in place;
    returns x.

    A CUDA tensor goes through a hand-written kernel on the route the
    fused level would take (`split_route_for`; a factor table's parity
    step takes "staged" in float64 too): "staged" (factor table: each
    line's self-leg factors and pivots in shared memory) or "line"
    (plane mode), both on `parity_shape`'s block with every thread on a
    row of the parity, or "direct" (the first port's kernel).  Counted in
    `super_parity.launches` and by route in `.staged_launches`,
    `.line_launches`, `.direct_launches`.  A CPU tensor takes the plain
    version."""
    _check_parity_args(B, li, p, y, acc, x)
    if x.device.type == "cuda":
        item = x.element_size()
        route = split_route_for(B, li, item, "parity", x.device)
        args = ctypes.byref(_level_args(B, li))
        if route == "direct":
            _cuda_call(B, "super_parity", x, args, p, y.data_ptr(),
                       _ptr(acc), x.data_ptr(), _ptr(B.table),
                       _ptr(B.table_dinv), _ptr(_planes(B, li)[1]),
                       _ptr(B.dinv_rows))
        else:
            shape = _parity_shape(B, li, item, x.device.index)
            tail = ((_ptr(B.table), _ptr(B.table_dinv)) if route == "staged"
                    else (_ptr(_planes(B, li)[1]), _ptr(B.dinv_rows)))
            _cuda_call(B, f"super_parity_{route}", x, args, p, *shape,
                       y.data_ptr(), _ptr(acc), x.data_ptr(), *tail,
                       operands=() if route == "staged" else None)
        _count_route(super_parity, route)
        return x
    if x.device.type == "cpu":
        return super_parity_plain(B, li, p, y, acc, x)
    raise ValueError(f"no super-parity step for device {x.device}")


def _zero_split_counts():
    for counter in (super_acc, super_parity):
        counter.launches = 0
        for route in ("staged", "line", "direct"):
            setattr(counter, f"{route}_launches", 0)


_zero_split_counts()




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
            # one native analysis of both triangles
            analysis = _native_analysis_for(trip, colors, spec)
            return (build_superblock_trisolve(trip, D_L, colors, spec,
                                              upper=False, dtype=dtype,
                                              need_d=need_d, device=device,
                                              _analysis=analysis),
                    build_superblock_trisolve(trip, D_U, colors, spec,
                                              upper=True, dtype=dtype,
                                              device=device,
                                              _analysis=analysis))
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


#: kernel #8's "vec" route (csrc/block_trisolve.cu): its group buckets
#: (the template instances; a level of more groups takes the scalar
#: route), the 16-byte vectors a window holds (BIS_RV_WIN), the most
#: threads a block (BIS_RV_THREADS)
RANK_VEC_BUCKETS = (2, 4, 8)
RANK_VEC_WIN = 3
RANK_VEC_THREADS = 256
#: the vec route's resident blocks an SM, which sizes its launch
#: (rank_vec_shape)
RANK_VEC_RESIDENT = 8


def rank_windows(groups, vec: int):
    """The vec route's group table for one level's groups (sorted by source
    colour, then Δ, as the builder and the JAX kernel's per-source windows
    keep them): per group, in order, [plane, src, base, nvec, shift].  A
    source's groups share one window, the aligned vectors covering
    [t + Δmin, t + Δmax + vec) of a chunk's slot t, while it spans at most
    RANK_VEC_WIN vectors, else they open another; the group that opens a
    window carries its source colour `src`, first vector `base` (in
    vectors from t) and length `nvec`, the others src = -1 (they read the
    window before).  `shift` is the window lane of slot t's source, Δ −
    vec·base."""
    out, base, opener = [], None, None
    for sc, delta, g in groups:
        lo, hi = delta // vec, (delta + vec - 1) // vec
        if (opener is not None and out[opener][1] == sc
                and hi - base + 1 <= RANK_VEC_WIN):
            out[opener][3] = max(out[opener][3], hi - base + 1)
            out.append([g, -1, base, 0, delta - vec * base])
        else:
            base, opener = lo, len(out)
            out.append([g, sc, lo, hi - lo + 1, delta - vec * lo])
    return out


def _rank_rule(groups, c: int, M: int, itemsize: int, ptrs=()) -> str:
    """The route of one rank-space level: "vec" where its groups fit the
    largest bucket (in float64, the smallest: on band:8388608,2's
    4-group levels the vec route ran slower than the scalar one, both at
    86% of the byte bound; PERF.md, PR 15), no group reads its own colour,
    and M and every pointer the route reads or writes 16-byte-wide
    (`ptrs`) are 16-byte aligned; else "scalar" (the first port's thread
    a slot, any level)."""
    vec = 16 // itemsize
    most = RANK_VEC_BUCKETS[0 if itemsize == 8 else -1]
    if (not 1 <= len(groups) <= most or M % vec
            or any(sc == c for sc, _d, _g in groups)
            or any(p % 16 for p in ptrs)):
        return "scalar"
    return "vec"


def rank_vec_shape(M: int, itemsize: int, sms: int) -> Tuple[int, int]:
    """(threads, cpt): the vec route's block and chunks of 16 bytes a
    thread for a level of M slots on a card of `sms` multiprocessors.
    Whole waves of resident blocks (RANK_VEC_RESIDENT an SM) over the
    M·itemsize/16 chunks: cpt minimises waves × cpt, the smallest on a
    tie.  On the H100 (scripts/rank_vec_sweep.py, band:8388608,2 f32,
    blocks of 64, 128 and 256 threads, 1 to 8 chunks a thread) this gives
    256 × 1, within 1% of the fastest shape on every level; more chunks a
    thread were 0.4–16% slower."""
    chunks = -(-M * itemsize // 16)
    threads = RANK_VEC_THREADS
    wave = RANK_VEC_RESIDENT * sms

    def cost(cpt):
        return -(-(-(-chunks // (threads * cpt))) // wave) * cpt
    cpt = min(range(1, 9), key=lambda k: (cost(k), k))
    return threads, cpt


def _rank_table(B: BlockedTriSolve, li: int, device):
    """Level li's launch on `device`, built at its first launch and kept:
    (route, scalar table, vec table): the route by `_rank_rule` on the
    level and the solve's own tensors, the scalar route's int64 group
    triples on the card, the vec route's `rank_windows` wherever the vec
    kernel takes the level (None where it has more groups than the
    largest bucket or reads its own colour)."""
    key = (li, str(device))
    if key not in B._tables:
        c, groups = B.levels[li]
        item = B.vals.element_size()
        route = _rank_rule(groups, c, B.M, item,
                           (B.vals.data_ptr(), B.dinv.data_ptr()))
        table = torch.tensor([list(g) for g in groups], dtype=torch.int64,
                             device=device).reshape(-1).contiguous()
        takes = (len(groups) <= RANK_VEC_BUCKETS[-1]
                 and all(sc != c for sc, _d, _g in groups))
        B._tables[key] = (route, table,
                          rank_windows(groups, 16 // item) if takes else None)
    return B._tables[key]


def rank_route_for(B: BlockedTriSolve, li: int, Y: torch.Tensor = None,
                   X: torch.Tensor = None) -> str:
    """The route `rank_level` takes for level li of B: the level's, decided
    once and kept with its launch table (`_rank_table`), and "scalar" for
    a call whose Y or X does not start on 16 bytes."""
    route = _rank_table(B, li, B.dinv.device)[0]
    if route == "vec" and any(v.data_ptr() % 16 for v in (Y, X)
                              if v is not None):
        return "scalar"
    return route


def _rank_vec_args(B: BlockedTriSolve, li: int, windows, cpt: int):
    from .._build import RankVecArgs
    a = RankVecArgs()
    a.M, a.c, a.n_groups, a.cpt = B.M, B.levels[li][0], len(windows), cpt
    for g, (plane, src, base, nvec, shift) in enumerate(windows):
        a.plane[g], a.src[g], a.base[g] = plane, src, base
        a.nvec[g], a.shift[g] = nvec, shift
    return a


def rank_level(B: BlockedTriSolve, li: int, Y: torch.Tensor,
               X: torch.Tensor, route: str = None) -> torch.Tensor:
    """Solve level li of B in place: X[c] for its colour c from Y[c] and
    the colours of X already solved; returns X.  Y may be X itself.

    A CUDA tensor goes through the hand-written kernel, one launch per
    level with groups, on `route` (by default `rank_route_for`'s): "vec"
    (the group table in the launch's parameters, 16 bytes of slots a
    thread, one x window a source colour) or "scalar"; counted in
    `rank_level.launches` and by route in `.vec_launches` /
    `.scalar_launches`; both give the same X, bit for bit.  A CPU tensor
    takes the plain version."""
    _check_rank_level(B, li, Y, X)
    if X.device.type == "cpu":
        return rank_level_plain(B, li, Y, X)
    if X.device.type != "cuda":
        raise ValueError(f"no rank-space level for device {X.device}")
    from .._build import launch, load_library
    if X.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the rank-space kernel takes float32 or float64, "
                        f"not {X.dtype}")
    if route is None:
        route = rank_route_for(B, li, Y, X)
    c, groups = B.levels[li]
    _route, table, windows = _rank_table(B, li, X.device)
    lib = load_library()
    dt = "f32" if X.dtype == torch.float32 else "f64"
    if route == "vec":
        if windows is None:
            raise ValueError(f"level {li} does not take the vec route")
        key = ("vec_args", li, str(X.device))
        if key not in B._tables:
            threads, cpt = rank_vec_shape(B.M, X.element_size(),
                                          sm_count(X.device.index))
            B._tables[key] = (threads, _rank_vec_args(B, li, windows, cpt))
        threads, args = B._tables[key]
        err = launch(getattr(lib, f"bis_rank_level_vec_{dt}"), X.device,
                     ctypes.byref(args), threads, Y.data_ptr(), X.data_ptr(),
                     B.vals.data_ptr(), B.dinv.data_ptr())
    elif route == "scalar":
        err = launch(getattr(lib, f"bis_rank_level_{dt}"), X.device,
                     Y.data_ptr(), X.data_ptr(), B.vals.data_ptr(),
                     B.dinv.data_ptr(), table.data_ptr(), len(groups), B.M, c)
    else:
        raise ValueError(f"unknown rank-space route {route!r}")
    if err != 0:
        raise RuntimeError(f"rank_level kernel launch ({route} route) failed "
                           f"with CUDA error {err}")
    rank_level.launches += 1
    setattr(rank_level, f"{route}_launches",
            getattr(rank_level, f"{route}_launches") + 1)
    return X


rank_level.launches = 0
rank_level.vec_launches = 0
rank_level.scalar_launches = 0


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
# The row-sharded mesh (the JAX package's MeshSuperBlockTriSolve,
# shard_superblock and _solve_super_mesh)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class MeshSuperBlockTriSolve:
    """A SuperBlockTriSolve cut into a 1-D row mesh's shards: `rows` rows
    a shard (whole x-lines; the row count padded to n_dev·rows with inert
    rows), a halo of `halo` rows a side, each shard's tensors its own
    (`shards`).  exchange[li][k] = (left, right, from_left, from_right):
    the window lines of level li's superblock that shard k sends to its
    left and right neighbours after the level, and where in its window the
    lines its neighbours send land (line indices of the window as
    (rows + 2·halo) / nx lines)."""

    inner: SuperBlockTriSolve
    mesh: object
    axis: str
    rows: int
    halo: int
    shards: Tuple[SuperBlockShard, ...]
    exchange: Tuple

    @property
    def dtype(self) -> torch.dtype:
        return self.inner.dtype

    @property
    def d(self):
        return self.inner.d

    @property
    def n_devices(self) -> int:
        return self.mesh.size

    @property
    def n_rows(self) -> int:
        return self.inner.n_rows

    @property
    def blocks(self):
        """The row blocks of the vectors it takes (MeshVectors)."""
        return self.mesh.blocks(self.inner.n_rows, self.rows)


def _halo_lines(B: SuperBlockTriSolve) -> int:
    """The deepest cross read of B, in whole x-lines: in const and
    factor-table mode hy lines and hz planes (a cross leg's source lies in
    line (y + dy, z + dz)); in plane mode the largest |Δ line| a group
    (src, Δ) reaches from any target line through src's slot_row."""
    nx, ny, nz, sx, sy, sz = B.spec_params
    if not B.is_plane:
        return B.reach[1] + ny * B.reach[2]
    my, mz = ny // sy, nz // sz
    lt = np.arange(my * mz, dtype=np.int64)

    def glob(line, py, pz):
        return sy * (line % my) + py + ny * (sz * (line // my) + pz)

    h = 0
    for sb, cross, _selfs in B.levels:
        for src, delta in cross:
            q = delta // nx
            for dl in ((q,) if delta % nx == 0 else (q, q + 1)):
                ls = lt + dl
                ok = (ls >= 0) & (ls < my * mz)
                if ok.any():
                    d = (glob(ls[ok], src % sy, src // sy)
                         - glob(lt[ok], sb % sy, sb // sy))
                    h = max(h, int(np.abs(d).max()))
    return h


def superblock_rows(B, n_dev: int) -> Tuple[int, int]:
    """(the least rows a shard, the unit its rows come in) of B cut into
    n_dev shards: whole z-planes where nz ≥ n_dev, else whole x-lines, at
    least its halo, B's deepest cross read (_halo_lines)."""
    nx, ny, nz = B.spec_params[:3]
    H = _halo_lines(B) * nx
    return (stencil_shard_rows((nx, ny, nz), (H, H), n_dev),
            nx * ny if nz >= n_dev else nx)


def shard_superblock(B, mesh, axis: str = "rows",
                     rows: Optional[int] = None) -> MeshSuperBlockTriSolve:
    """Cut a superblock solve into the mesh's row shards (the JAX package's
    shard_superblock), refusing as it does, with its messages, a
    rank-space solve and the split route.  Its two other refusals, the
    packed layout and an aligned-fused shard width that breaks x
    alignment, come from its TPU tiles, which the port does not have: the
    port shards those solves.  Shards are contiguous natural-order row
    ranges of `rows` rows (`superblock_rows`' least where None: the mesh
    stencil's rows, stencil_op.stencil_shard_rows, at least the halo).
    Each shard's planes, per-row diagonals, factor table and exchange
    indices are copied out to its device as its own tensors."""
    if not isinstance(B, SuperBlockTriSolve):
        raise BlockIneligibleError(
            "only superblock trisolves shard (rank-space layout "
            "interleaves lanes across blocks)")
    if not B.fused:
        raise BlockIneligibleError(
            "split-mode superblock solves are not mesh-sharded yet")
    n_dev = mesh.size
    nx, ny, nz, sx, sy, sz = B.spec_params
    H = _halo_lines(B) * nx
    least, unit = superblock_rows(B, n_dev)
    R = least if rows is None else rows
    if R < least or R % unit:
        raise ValueError(f"{R} rows a shard do not serve this superblock "
                         f"solve: at least {least}, a multiple of {unit}")
    my = ny // sy
    n_lines = ny * nz
    # each level's superblock lines, as global line indices (increasing)
    g_of = []
    for sb, _c, _s in B.levels:
        t = np.arange(B.m // nx, dtype=np.int64)
        g_of.append(sy * (t % my) + sb % sy + ny * (sz * (t // my)
                                                    + sb // sy))

    def rows_of(v, k, device):
        if v is None:
            return None
        lo, hi = min(k * R, v.numel()), min((k + 1) * R, v.numel())
        return F.pad(v[lo:hi], (0, R - (hi - lo))).to(device, copy=True)

    tables = {dev: (None if B.table is None else B.table.to(dev),
                    None if B.table_dinv is None else B.table_dinv.to(dev))
              for dev in set(mesh.devices)}
    shards, exchange = [], []
    for k, device in enumerate(mesh.devices):
        lines = []
        for g in g_of:
            l0, l1 = np.searchsorted(g, [k * R // nx, (k + 1) * R // nx])
            lines.append((int(l0), int(l1)))

        def planes(vals, lines=lines, device=device):
            if vals is None:
                return None
            return tuple(None if v is None else
                         v[:, l0 * nx:l1 * nx].to(device, copy=True)
                         .contiguous()
                         for v, (l0, l1) in zip(vals, lines))

        shards.append(SuperBlockShard(
            B=B, row0=k * R, rows=R, halo=H, lines=tuple(lines),
            vals_cross=planes(B.vals_cross), vals_self=planes(B.vals_self),
            dinv_rows=rows_of(B.dinv_rows, k, device),
            d_rows=rows_of(B.d_rows, k, device),
            table=tables[device][0], table_dinv=tables[device][1]))
    h, Rl = H // nx, R // nx
    for li, (sb, _c, _s) in enumerate(B.levels):
        def ids(k, lo, hi, sb=sb):
            """Window lines of shard k holding superblock sb's real lines
            among global lines [lo, hi)."""
            g = np.arange(max(lo, 0), min(hi, n_lines), dtype=np.int64)
            g = g[((g % ny) % sy == sb % sy) & ((g // ny) % sz == sb // sy)]
            return g - (k * Rl - h)

        per = []
        for k, device in enumerate(mesh.devices):
            g0 = k * Rl
            per.append(tuple(torch.from_numpy(a).to(device) for a in (
                ids(k, g0, g0 + h), ids(k, g0 + Rl - h, g0 + Rl),
                ids(k, g0 - h, g0), ids(k, g0 + Rl, g0 + Rl + h))))
        exchange.append(tuple(per))
    return MeshSuperBlockTriSolve(inner=B, mesh=mesh, axis=axis, rows=R,
                                  halo=H, shards=tuple(shards),
                                  exchange=tuple(exchange))


def _shard_args(Bs: SuperBlockShard, li: int):
    """The kernel's launch table for shard Bs's part of level li: the
    level's table with the shard's lines, offsets and plane slots (cached
    on Bs)."""
    from .._build import SuperLevelArgs
    if li not in Bs._args:
        a = SuperLevelArgs.from_buffer_copy(_level_args(Bs.B, li))
        l0, l1 = Bs.lines[li]
        nx = Bs.B.spec_params[0]
        a.line0, a.lines = l0, l1 - l0
        a.grid_x = -(-a.lines // a.block_y)
        a.y_row0, a.x_row0 = Bs.row0, Bs.x_row0
        a.slot0, a.plane_m = l0 * nx, (l1 - l0) * nx
        Bs._args[li] = a
    return Bs._args[li]


def super_level_halo(Bs: SuperBlockShard, li: int, y: torch.Tensor,
                     x: torch.Tensor) -> torch.Tensor:
    """One mesh shard's part of level li (the JAX package's
    _super_level_pallas with row0): super_level_halo_plain's contract.  A
    CUDA tensor launches the level kernel (csrc/block_trisolve.cu) on the
    shard's window, its planes and diagonal, on `level_route_for`'s route
    for the shard's launch, counted as `super_level` counts (in
    `super_level_halo.launches`, `.table_launches`, `.plane_launches` and
    each mode's routes apart); a shard that owns none of the level's lines
    launches nothing.  A CPU tensor takes the plain version."""
    _check_halo(Bs, li, y, x)
    if x.device.type == "cuda":
        l0, l1 = Bs.lines[li]
        if l1 == l0:
            return x
        B = Bs.B
        vc = Bs.vals_cross[li] if B.is_plane else None
        vs = Bs.vals_self[li] if B.is_plane else None
        _launch_level(B, li, _shard_args(Bs, li), y, x, super_level_halo,
                      vc, vs, Bs.dinv_rows, operands=(vc, vs, Bs.dinv_rows),
                      shard=Bs)
        return x
    if x.device.type == "cpu":
        return super_level_halo_plain(Bs, li, y, x)
    raise ValueError(f"no super-level solve for device {x.device}")


_zero_counts(super_level_halo)


def _mesh_exchange(MB: MeshSuperBlockTriSolve, li: int, X) -> None:
    """After level li: each shard sends the level's superblock lines among
    its first (last) halo rows to its left (right) neighbour
    (Mesh.ppermute), which writes them into its window's right (left)
    halo."""
    if not MB.halo or MB.n_devices == 1:
        return
    nx = MB.inner.spec_params[0]
    views = [Xk.view(-1, nx) for Xk in X]
    ex = MB.exchange[li]
    to_left = MB.mesh.ppermute([v.index_select(0, e[0])
                                for v, e in zip(views, ex)], -1)
    to_right = MB.mesh.ppermute([v.index_select(0, e[1])
                                 for v, e in zip(views, ex)], 1)
    last = MB.n_devices - 1
    for k, (v, e) in enumerate(zip(views, ex)):
        if k > 0:
            v.index_copy_(0, e[2], to_right[k])
        if k < last:
            v.index_copy_(0, e[3], to_left[k])


def _mesh_rows(MB: MeshSuperBlockTriSolve, v):
    """v's shards, checked to be a MeshVector in MB's layout."""
    from ..parallel.mesh_vector import MeshVector
    if not isinstance(v, MeshVector) or v.blocks != MB.blocks:
        raise ValueError(
            "a mesh superblock solve takes a MeshVector of its layout "
            f"({MB.rows} rows a shard; Mesh.scatter), not "
            f"{type(v).__name__}")
    return v.shards


def _mesh_like(MB: MeshSuperBlockTriSolve, parts):
    """The shards' R-row parts cut to their own rows, as a MeshVector."""
    from ..parallel.mesh_vector import MeshVector
    blocks = MB.blocks
    return MeshVector([p[:hi - lo] for p, (lo, hi) in zip(parts,
                                                          blocks.bounds)],
                      blocks, check=False)


def _solve_super_mesh(MB: MeshSuperBlockTriSolve, y):
    """All levels in order on the mesh: each shard's part of a level
    (super_level_halo) on its own rows of y and its window of x, on its
    device, then the level's halo exchange; x starts at zero on every
    window (the JAX package's _solve_super_mesh).  y and x are MeshVectors
    of MB's layout.  MEGA is not read: the mesh route takes no one-launch
    solve."""
    R, H = MB.rows, MB.halo
    ys = [F.pad(v, (0, R - v.numel())) if v.numel() != R else v
          for v in _mesh_rows(MB, y)]
    X = [torch.zeros(R + 2 * H, dtype=y.dtype, device=dev)
         for dev in MB.mesh.devices]
    for li in range(len(MB.inner.levels)):
        for Bs, yk, Xk in zip(MB.shards, ys, X):
            super_level_halo(Bs, li, yk, Xk)
        _mesh_exchange(MB, li, X)
    return _mesh_like(MB, [Xk[H:H + R] for Xk in X])


def _mesh_times_d(MB: MeshSuperBlockTriSolve, t):
    """t·D for the symmetric apply's middle multiply, each shard's rows by
    its own slice of the per-row D (or the constant D)."""
    if MB.inner.d_rows is None:
        if MB.inner.d is None:
            raise ValueError("blocked_sgs needs L built with need_d=True")
        return t * MB.inner.d
    return _mesh_like(MB, [p * Bs.d_rows[:p.numel()] for p, Bs in
                           zip(_mesh_rows(MB, t), MB.shards)])


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
    the same action as coloring.colored_sweep from zero.  The three applies
    here are TIME'd as "sptrsv" in kernel-timing mode (utils/ktimers.py)."""
    from ..utils.ktimers import ktime
    return ktime("sptrsv", _blocked_trisolve, B, y)


def _blocked_trisolve(B, y: torch.Tensor) -> torch.Tensor:
    if isinstance(B, MeshSuperBlockTriSolve):
        return _solve_super_mesh(B, y)
    if isinstance(B, BlockedTriSolve):
        Y = permute_blocks(B, y)
        return unpermute_blocks(B, solve_blocks(B, Y, Y))
    return _solve_super(B, y, torch.empty_like(y))


def blocked_sgs(L, U, y: torch.Tensor) -> torch.Tensor:
    """(U_c+D)⁻¹ D (L_c+D)⁻¹ y, the exact coloured symmetric GS apply: the
    levels of L, the multiply by D, the levels of U in place (L must be
    built with need_d=True)."""
    from ..utils.ktimers import ktime
    return ktime("sptrsv", _blocked_sgs, L, U, y)


def _blocked_sgs(L, U, y: torch.Tensor) -> torch.Tensor:
    if isinstance(L, MeshSuperBlockTriSolve):
        return _solve_super_mesh(U, _mesh_times_d(L, _solve_super_mesh(L, y)))
    d = L.d if isinstance(L, BlockedTriSolve) or L.d_rows is None \
        else L.d_rows
    if d is None:
        raise ValueError("blocked_sgs needs L built with need_d=True")
    if isinstance(L, BlockedTriSolve):
        T = solve_blocks(L, permute_blocks(L, y), torch.empty(
            (L.n_colors, L.M), dtype=y.dtype, device=y.device)) * L.d
        return unpermute_blocks(U, solve_blocks(U, T, T))
    t = _blocked_trisolve(L, y) * d
    return _solve_super(U, t, t)


def blocked_ilu0(L, U, y: torch.Tensor) -> torch.Tensor:
    """U⁻¹L⁻¹y with unit-diagonal L, the coloured ILU(0) apply: the levels
    of L, then the levels of U in place on the same state."""
    from ..utils.ktimers import ktime
    return ktime("sptrsv", _blocked_ilu0, L, U, y)


def _blocked_ilu0(L, U, y: torch.Tensor) -> torch.Tensor:
    if isinstance(L, BlockedTriSolve):
        X = solve_blocks(L, permute_blocks(L, y), torch.empty(
            (L.n_colors, L.M), dtype=y.dtype, device=y.device))
        return unpermute_blocks(U, solve_blocks(U, X, X))
    mesh = isinstance(L, MeshSuperBlockTriSolve)
    if not (L.inner if mesh else L).unit:
        raise ValueError("blocked_ilu0 needs an ILU(0) pair, whose L solves "
                         "with a unit diagonal: the factor-table pair "
                         "(build_superblock_ilu0_pair_stencil) or one built "
                         "from its factors with D None, not a GS pair")
    if mesh:
        return _solve_super_mesh(U, _solve_super_mesh(L, y))
    x = _blocked_trisolve(L, y)
    return _solve_super(U, x, x)
