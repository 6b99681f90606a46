"""Const-mode superblock triangular solves: exact coloured GS on stencils.

The const-mode subset of the JAX package's ops/block_trisolve.py.  A grid
colouring with strides (sx, sy, sz) of a constant-coefficient stencil
groups the rows into S = sy·sz superblocks: superblock sb holds the rows
with (y mod sy, z mod sz) = (sb mod sy, sb // sy), and its colours are the
sx x-parities.  In the colour-sorted ordering the strict lower triangle L
couples a superblock only to lower ones (cross legs) and, inside it, a
parity only to lower parities along x (self legs); U mirrors that.  So
(L + D)⁻¹y is S levels, one per superblock, each a parallel update with
the x-parities chained:

    acc = y − Σ_cross c·mask·x(src, Δ)
    for each parity p:  x = (acc − Σ_self c·mask·x(dx))·D⁻¹  on parity p

and the factors are the operator's legs themselves (`const_cross`,
`const_self`): nothing is stored but metadata and the constant diagonal.
`blocked_trisolve` and `blocked_sgs` are the same actions as the masked
colour sweeps of coloring.py with the same colouring.

Vectors stay in the natural flat order: the JAX package's rank-space
permute, (R_b, 128) planes, TB tiles and fused/aligned/split layouts are
TPU geometry with no counterpart here.  `super_level` is one level's entry
point: on a CUDA tensor it launches the hand-written kernel
(csrc/block_trisolve.cu) or raises; on a CPU tensor it runs the plain
version, `super_level_plain`.
"""
from __future__ import annotations

import ctypes
import dataclasses
import types
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import torch_dtype
from ..stencil_op import _rounded

#: threads per kernel block (csrc/block_trisolve.cu: __launch_bounds__)
_BLOCK_THREADS = 256


class BlockIneligibleError(ValueError):
    """The superblock form does not apply to this operator and colouring."""


class ImproperColoringError(BlockIneligibleError):
    """The colouring couples two rows of the same colour."""


@dataclasses.dataclass(eq=False)
class SuperBlockTriSolve:
    """Const-mode superblock form of a coloured triangular solve.

    levels[li] = (sb, cross, selfs): the superblock solved at level li, its
    cross groups ((src, Δ), …) sorted by (src, Δ), its self legs (dx, …)
    sorted; const_cross[li] = ((c, dx, dy, dz), …) aligned with cross,
    const_self[li] = ((c, dx), …) aligned with selfs (the JAX package's
    fields, as Python tuples).  `dinv` and `d` are the constant diagonal's
    inverse and value rounded to `dtype` (`d` only where a symmetric apply
    multiplies by D between the two solves)."""

    n_rows: int
    S: int
    m: int
    sx: int
    levels: Tuple
    upper: bool
    spec_params: Tuple[int, ...]
    const_cross: Tuple
    const_self: Tuple
    dinv: float
    d: Optional[float]
    dtype: torch.dtype
    #: max |d| per axis over the legs (the plain version's zero padding)
    reach: Tuple[int, int, int]
    #: the kernel's launch table per level, built at first launch
    _args: dict = dataclasses.field(default_factory=dict, repr=False)


def _stencil_pair_plan(op, spec):
    """Eligibility and geometry of the analytic stencil pair: the constant
    diagonal, the self legs [(dx, c)], and per target superblock its cross
    legs [(src, Δ, c, leg)].  Raises BlockIneligibleError (or
    ImproperColoringError) where the const superblock form does not
    apply."""
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
    return types.SimpleNamespace(
        diag_c=diag_c, self_legs=sorted(self_legs), per_sb=per_sb, S=S,
        m=nx * my * mz, spec_params=tuple(int(p) for p in spec.params))


def stencil_blocked_eligible(op, spec) -> bool:
    """Can build_superblock_gs_pair_stencil succeed for this DeviceStencil
    and grid spec?  (Metadata checks only.)"""
    try:
        _stencil_pair_plan(op, spec)
        return True
    except BlockIneligibleError:
        return False


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
    S = plan.S
    dinv, d = _rounded([1.0 / plan.diag_c, plan.diag_c], dtype)
    selfs = tuple(dx for dx, _c in plan.self_legs)
    self_consts = tuple((c, dx) for dx, c in plan.self_legs)
    reach = tuple(max([0] + [abs(leg[a]) for leg in op.legs])
                  for a in range(3))

    def one(upper: bool):
        order = range(S - 1, -1, -1) if upper else range(S)
        levels, cc = [], []
        for sb in order:
            rows = [(src, delta, c, leg) for src, delta, c, leg
                    in plan.per_sb[sb]
                    if (src > sb if upper else src < sb)]
            rows.sort(key=lambda r: (r[0], r[1]))
            levels.append((sb, tuple((src, delta) for src, delta, _, _
                                     in rows), selfs))
            cc.append(tuple((c,) + leg for _, _, c, leg in rows))
        return SuperBlockTriSolve(
            n_rows=nx * ny * nz, S=S, m=plan.m, sx=sx, levels=tuple(levels),
            upper=upper, spec_params=plan.spec_params, const_cross=tuple(cc),
            const_self=(self_consts,) * len(levels), dinv=dinv,
            d=(d if (need_d and not upper) else None), dtype=dtype,
            reach=reach)

    return one(False), one(True)


def _parity_order(B: SuperBlockTriSolve):
    return range(B.sx - 1, -1, -1) if B.upper else range(B.sx)


# ---------------------------------------------------------------------------
# One level
# ---------------------------------------------------------------------------

def _check_level(B: SuperBlockTriSolve, li: int, y, x):
    if not 0 <= li < len(B.levels):
        raise IndexError(f"level {li} of {len(B.levels)}")
    for name, v in (("y", y), ("x", x)):
        if not isinstance(v, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if v.shape != (B.n_rows,):
            raise ValueError(f"{name} has shape {tuple(v.shape)}, expected "
                             f"({B.n_rows},)")
        if v.dtype != B.dtype:
            raise TypeError(f"{name} is {v.dtype}, the solve {B.dtype}")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if y.device != x.device:
        raise ValueError("y and x lie on different devices")


def super_level_plain(B: SuperBlockTriSolve, li: int, y: torch.Tensor,
                      x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel (the JAX package's
    _super_level_xla in the flat order): writes the rows of level li's
    superblock of x and returns x.  Reads y on those rows and x on the
    superblocks already solved; y may be x itself."""
    _check_level(B, li, y, x)
    nx, ny, nz, sx, sy, sz = B.spec_params
    sb = B.levels[li][0]
    py, pz = sb % sy, sb // sy
    my, mz = ny // sy, nz // sz
    hx, hy, hz = B.reach
    X = x.view(nz, ny, nx)
    rows = (slice(pz, None, sz), slice(py, None, sy))
    # out-of-grid neighbours read the zero padding: c·0 leaves acc as the
    # JAX package's masked plane does
    Xp = F.pad(X, (hx, hx, hy, hy, hz, hz))
    acc = y.view(nz, ny, nx)[rows]
    for c, dx, dy, dz in B.const_cross[li]:
        z0, y0, x0 = hz + pz + dz, hy + py + dy, hx + dx
        nb = Xp[z0:z0 + sz * (mz - 1) + 1:sz, y0:y0 + sy * (my - 1) + 1:sy,
                x0:x0 + nx]
        acc = acc - c * nb
    gx = torch.arange(nx, device=x.device)
    parity = gx % sx
    xt = torch.zeros_like(acc)
    for p in _parity_order(B):
        a = acc
        xtp = F.pad(xt, (hx, hx))
        for c, dx in B.const_self[li]:
            src = gx + dx
            ok = (src >= 0) & (src < nx)
            ps = src % sx
            ok &= (ps > parity) if B.upper else (ps < parity)
            a = a - c * torch.where(ok, xtp[..., hx + dx:hx + dx + nx], 0.0)
        xt = torch.where(parity == p, a * B.dinv, xt)
    X[rows] = xt
    return x


def _level_args(B: SuperBlockTriSolve, li: int):
    """The kernel's launch table for level li (cached on B)."""
    from .._build import MAX_LEGS, SuperLevelArgs
    if li in B._args:
        return B._args[li]
    nx, ny, nz, sx, sy, sz = B.spec_params
    sb = B.levels[li][0]
    cross, selfs = B.const_cross[li], B.const_self[li]
    if len(cross) > MAX_LEGS or len(selfs) > MAX_LEGS:
        raise ValueError(f"the kernel takes at most {MAX_LEGS} cross and "
                         f"{MAX_LEGS} self legs a level")
    a = SuperLevelArgs()
    for j, (c, dx, dy, dz) in enumerate(cross):
        a.cross_off[j] = dx + nx * (dy + ny * dz)
        a.cross_coeff[j] = c
        a.cross_dx[j], a.cross_dy[j], a.cross_dz[j] = dx, dy, dz
    for j, (c, dx) in enumerate(selfs):
        a.self_coeff[j] = c
        a.self_dx[j] = dx
    a.n_cross, a.n_self = len(cross), len(selfs)
    a.dinv = B.dinv
    a.nx, a.ny, a.nz, a.sx, a.sy, a.sz = nx, ny, nz, sx, sy, sz
    a.py, a.pz = sb % sy, sb // sy
    a.my = ny // sy
    a.lines = a.my * (nz // sz)
    a.upper = int(B.upper)
    a.block_x = min(128, -(-nx // 32) * 32)
    a.block_y = _BLOCK_THREADS // a.block_x
    a.grid_x = -(-a.lines // a.block_y)
    if B.n_rows >= 2 ** 62:
        raise ValueError(f"grid {B.spec_params[:3]} exceeds the kernel's "
                         "launch limits")
    B._args[li] = a
    return a


def _super_level_cuda(B: SuperBlockTriSolve, li: int, y, x):
    from .._build import load_library
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the super-level kernel takes float32 or float64, "
                        f"not {x.dtype}")
    args = _level_args(B, li)
    lib = load_library()
    fn = (lib.bis_super_level_f32 if x.dtype == torch.float32
          else lib.bis_super_level_f64)
    err = fn(x.device.index, ctypes.byref(args), y.data_ptr(), x.data_ptr(),
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"super_level kernel launch failed with CUDA "
                           f"error {err}")
    super_level.launches += 1
    return x


def super_level(B: SuperBlockTriSolve, li: int, y: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """Solve level li of B in place: the rows of its superblock of x from
    y and the superblocks of x already solved; returns x.  y may be x
    itself.

    A CUDA tensor goes through the hand-written kernel, which counts its
    launches in `super_level.launches`; a CPU tensor takes the plain
    version."""
    _check_level(B, li, y, x)
    if x.device.type == "cuda":
        return _super_level_cuda(B, li, y, x)
    if x.device.type == "cpu":
        return super_level_plain(B, li, y, x)
    raise ValueError(f"no super-level solve for device {x.device}")


super_level.launches = 0


# ---------------------------------------------------------------------------
# Whole solves
# ---------------------------------------------------------------------------

def _solve_super(B: SuperBlockTriSolve, y: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """All levels in order, into x (which may be y)."""
    for li in range(len(B.levels)):
        super_level(B, li, y, x)
    return x


def blocked_trisolve(B: SuperBlockTriSolve, y: torch.Tensor) -> torch.Tensor:
    """x = (T_c + D)⁻¹y: the exact GS solve of the colour-sorted ordering,
    the same action as coloring.colored_sweep from zero."""
    return _solve_super(B, y, torch.empty_like(y))


def blocked_sgs(L: SuperBlockTriSolve, U: SuperBlockTriSolve,
                y: torch.Tensor) -> torch.Tensor:
    """(U_c+D)⁻¹ D (L_c+D)⁻¹ y, the exact coloured symmetric GS apply: S
    levels of L, the multiply by D, S levels of U in place (L must be
    built with need_d=True)."""
    if L.d is None:
        raise ValueError("blocked_sgs needs L built with need_d=True")
    t = blocked_trisolve(L, y) * L.d
    return _solve_super(U, t, t)
