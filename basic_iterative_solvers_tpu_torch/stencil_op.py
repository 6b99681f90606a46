"""Matrix-free constant-coefficient stencil operator.

Every matrix family the reference benchmarks (HPCG 27-point, FDM
Laplacian, Anderson hopping) is a constant-coefficient stencil on a
regular grid.  The SpMV then needs no matrix traffic at all:
y[i] = Σ_leg c · x[i + off], with the open-boundary masks computed from
the grid coordinates of i.  It reads x (and a dense diagonal, if any) and
writes y.

`DeviceStencil` keeps its vectors in natural x-fastest flat order
(i = x + nx·(y + ny·z)), with no halo: Hopper's kernel computes the masks
from coordinates, so the TPU package's planar halo layout has no
counterpart here.

`stencil_spmv` is the SpMV's one entry point, and `stencil_gs_color_step`
the multicolour Gauss-Seidel step's: on a CUDA tensor each launches its
hand-written kernel (csrc/stencil_spmv.cu) or raises; on a CPU tensor each
runs its plain version (`stencil_spmv_plain`,
`stencil_gs_color_step_plain`).  The SpMV has two kernels: #1
(`stencil_spmv_resident` in the JAX package) and #2
(`stencil_spmv_stream`, x staged in shared memory), taken when `STREAM`
is set (`BIS_STENCIL_STREAM=1`, as in the JAX package) for every operator
within #2's reach (`stream_reach`).  Each has two routes, picked before
the launch by `route_for`: "box" (legs within the 3x3x3 box, the
neighbourhood in registers; #2 also needs lines of whole 16-byte
vectors) and "legs" (the first ports' leg loops, any legs), counted in
`box_launches` and `legs_launches`; y is the same on both, bit for bit.
The GS step (and its shard form) takes the same two routes, picked by
`gs_route_for` (`gs_halo_route_for`): "box" adds the step's epilogue to
#1's box route under a parity or grid colouring; x' is the same on both.
#1's shard form (`stencil_spmv_halo`) takes them too, picked by
`halo_route_for`: "box" runs #1's box route on the shard's window, whose
halo is the operator's rounded up to whole x-lines
(`DeviceStencil.window_halo`, the one layout the shard-local forms
read).  Every fused dot sums float32 products in float64
and is rounded once (`partial_dot`), so it does not hang on the cut into
blocks or shards.

The coefficients and the diagonal may be stored in bfloat16 beside float32
or float64 vectors (the JAX package's matrix_dtype): the coefficients are
rounded to bfloat16 once, when the operator is made, and reach the kernels
as exact vector-dtype values; a bfloat16 diagonal is widened before its
product, by the kernels' bfloat16-diagonal forms, whose launches are
counted in each wrapper's `bf16_launches`.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import os
import re
from typing import Optional, Tuple

import numpy as np
import torch

from .config import kernel_suffix, serves_vectors, torch_dtype

DOT_KINDS = ("x", "self", "aux")
#: threads per kernel block (csrc/stencil_spmv.cu: __launch_bounds__)
_BLOCK_THREADS = 256

#: the JAX package's BIS_STENCIL_STREAM switch, read at import
#: (stencil_op._stream_wanted there): set, every stencil SpMV on a card
#: within kernel #2's reach launches #2 instead of #1.  May be set in
#: process.
STREAM = os.environ.get("BIS_STENCIL_STREAM", "0") == "1"
#: kernel #2's (x, y) tile of threads and its staged halo (x, y, z):
#: BIS_STREAM_TX/TY and BIS_STREAM_HX/HY in csrc/stencil_spmv.cu; z holds
#: one plane a side (the ring of three)
STREAM_TILE = (32, 8)
STREAM_HALO = (1, 2, 1)
#: kernel #2's target block count (the z chunk shrinks until the grid has
#: about this many blocks: ~8 a streaming multiprocessor)
_STREAM_BLOCKS = 1024


@dataclasses.dataclass
class DeviceStencil:
    """Constant-coefficient stencil on an open-boundary nx×ny×nz grid.

    coeffs[l] multiplies x at grid offset legs[l] = (dx, dy, dz); when
    `diag` (n,) is given it overrides the (0,0,0) leg with a dense vector.
    `coeff_values` are the coefficients as Python floats, equal to `coeffs`
    (rounded to its dtype), so launches need no device read.
    """

    coeffs: torch.Tensor                   # (n_legs,)
    diag: Optional[torch.Tensor]           # (n,) or None
    legs: Tuple[Tuple[int, int, int], ...]
    coeff_values: Tuple[float, ...]
    dims: Tuple[int, int, int]
    n_rows: int
    n_cols: int
    #: the row mesh's shard count this operator is laid out for
    #: (parallel/mesh_ops.py); 1 = the single-device operator
    shards: int = 1

    @property
    def dtype(self) -> torch.dtype:
        return self.coeffs.dtype

    @property
    def device(self) -> torch.device:
        return self.coeffs.device

    @property
    def offsets(self) -> Tuple[int, ...]:
        nx, ny, _ = self.dims
        return tuple(sorted({dx + nx * (dy + ny * dz)
                             for (dx, dy, dz) in self.legs}))

    @property
    def halo(self) -> Tuple[int, int]:
        """(hneg, hpos): the rows a shard's window needs below and above
        its own, the largest negative and positive flat leg offsets."""
        offs = self.offsets
        return ((max(0, -min(offs)), max(0, max(offs))) if offs
                else (0, 0))

    @property
    def window_halo(self) -> Tuple[int, int]:
        """(hneg, hpos) of a shard's window, the one layout the shard-local
        forms read (the mesh and GSPMD modes build it): the halo rounded up
        to whole x-lines, so a shard's own rows start on a line of its
        window and the box routes' 16-byte loads stay aligned (the extra
        rows are real neighbour rows, or zeros past the grid's ends; no leg
        reads them)."""
        nx = self.dims[0]
        return tuple(-(-h // nx) * nx for h in self.halo)


def _legs_sorted(legs_coeffs):
    return tuple(sorted(legs_coeffs,
                        key=lambda lc: (lc[0][2], lc[0][1], lc[0][0])))


def _rounded(values, dtype: torch.dtype) -> Tuple[float, ...]:
    """Python floats equal to `values` stored in `dtype`."""
    return tuple(torch.tensor(values, dtype=torch.float64).to(dtype)
                 .to(torch.float64).tolist())


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device with no card raises,
    naming it (the entry points never fall back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was asked for, but no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    return device


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The multiprocessors of CUDA card `index` (the routes that pick a
    kernel by how far a launch fills the card read it)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def make_stencil(legs_coeffs, nx: int, ny: int, nz: int,
                 dtype=torch.float32, diag=None, *,
                 device="cuda") -> DeviceStencil:
    """legs_coeffs: iterable of ((dx, dy, dz), coefficient).  Legs that
    cannot reach inside the grid are dropped; legs are sorted z, y, x.
    The operator lives on `device`, the card unless the caller asks for
    the CPU."""
    dtype = torch_dtype(dtype)
    device = resolve_device(device)
    legs_coeffs = [(tuple(l), float(c)) for (l, c) in legs_coeffs
                   if (nx - abs(l[0])) > 0 and (ny - abs(l[1])) > 0
                   and (nz - abs(l[2])) > 0]
    legs_coeffs = _legs_sorted(legs_coeffs)
    legs = tuple(l for (l, _) in legs_coeffs)
    if len(set(legs)) != len(legs):
        raise ValueError("duplicate stencil legs")
    values = _rounded([c for (_, c) in legs_coeffs], dtype)
    coeffs = torch.tensor(values, dtype=dtype, device=device)
    n = nx * ny * nz
    d = None
    if diag is not None:
        d = torch.as_tensor(diag, dtype=dtype, device=device).reshape(-1)
        if d.numel() != n:
            raise ValueError(f"diag has {d.numel()} entries, grid has {n}")
        d = d.contiguous()
    return DeviceStencil(coeffs=coeffs, diag=d, legs=legs,
                         coeff_values=values, dims=(nx, ny, nz), n_rows=n,
                         n_cols=n)


def stencil_astype(A: DeviceStencil, dtype) -> DeviceStencil:
    """A with its coefficients and diagonal stored in `dtype` (the rounded
    coefficients of A's own dtype, as a cast of the tensors gives them)."""
    dtype = torch_dtype(dtype)
    if A.dtype == dtype:
        return A
    return dataclasses.replace(
        A, coeffs=A.coeffs.to(dtype),
        diag=None if A.diag is None else A.diag.to(dtype),
        coeff_values=_rounded(A.coeff_values, dtype))


# ---------------------------------------------------------------------------
# SpMV
# ---------------------------------------------------------------------------

def _check_operands(A: DeviceStencil, x: torch.Tensor, dots, aux):
    for kind in dots:
        if kind not in DOT_KINDS:
            raise ValueError(f"unknown fused-dot kind: {kind!r}")
    if "aux" in dots and aux is None:
        raise ValueError("dots containing 'aux' require the aux vector")
    vecs = [("x", x)] + [("diag", A.diag)] * (A.diag is not None)
    if "aux" in dots:
        vecs.append(("aux", aux))
    for name, v in vecs:
        if not isinstance(v, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if v.shape != (A.n_rows,):
            raise ValueError(f"{name} has shape {tuple(v.shape)}, "
                             f"expected ({A.n_rows},)")
        ok = (v.dtype == A.dtype if name == "diag" else
              serves_vectors(A.dtype, v.dtype) and v.dtype == x.dtype)
        if not ok:
            raise TypeError(f"{name} is {v.dtype}, the operator {A.dtype}")
        if v.device != A.device:
            raise ValueError(f"{name} is on {v.device}, the operator on "
                             f"{A.device}")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _leg_masks(g, legs, nx, ny, nz, n):
    """Boundary-validity mask per leg from the flat row index vector g."""
    xc = g % nx
    yc = (g // nx) % ny
    zc = g // (nx * ny)
    in_n = g < n
    axis_ok = {}                  # (axis, d) -> in-bounds mask, shared
    masks = []
    for leg in legs:
        m = in_n
        for axis, (c, d, size) in enumerate(zip((xc, yc, zc), leg,
                                                (nx, ny, nz))):
            if d != 0:
                if (axis, d) not in axis_ok:
                    axis_ok[axis, d] = (c + d >= 0) & (c + d < size)
                m = m & axis_ok[axis, d]
        masks.append(m)
    return masks


def stencil_spmv_plain(A: DeviceStencil, x: torch.Tensor, dots=(),
                       aux: torch.Tensor = None):
    """Plain PyTorch version of the kernel: one masked, shifted
    multiply-add per leg in leg order, then each requested dot
    (`partial_dot`, rounded once to x's dtype), the coefficients and the
    diagonal widened to x's dtype.  Returns
    y, or (y, *dots) when dots are requested.  It is the shard-local plain
    version on the whole grid: one shard, x zero-padded by the window's
    halo."""
    _check_operands(A, x, dots, aux)
    out = _spmv_window_plain(A, torch.nn.functional.pad(x, A.window_halo),
                             0, dots, aux, A.diag)
    if not dots:
        return out
    return (out[0],) + tuple(d.to(x.dtype) for d in out[1:])


def _spmv_window_plain(A: DeviceStencil, xw: torch.Tensor, row0: int, dots,
                       aux, diag):
    """The rows [row0, row0 + rows) of A·x from the window xw of x (hneg
    rows below them, hpos above: A.window_halo), masked by their global
    coordinates; rows at or past n are inert (0)."""
    n = A.n_rows
    nx, ny, nz = A.dims
    hneg, hpos = A.window_halo
    rows = xw.numel() - hneg - hpos
    g = row0 + torch.arange(rows, device=xw.device)
    masks = _leg_masks(g, A.legs, nx, ny, nz, n)
    y = torch.zeros(rows, dtype=xw.dtype, device=xw.device)
    for l, (dx, dy, dz) in enumerate(A.legs):
        lin = dx + nx * (dy + ny * dz)
        contrib = torch.where(masks[l], xw[hneg + lin:hneg + lin + rows],
                              0.0)
        coeff = (diag if ((dx, dy, dz) == (0, 0, 0) and diag is not None)
                 else A.coeffs[l])
        y = torch.addcmul(y, coeff.to(xw.dtype), contrib)
    if not dots:
        return y
    partner = {"x": xw[hneg:hneg + rows], "self": y, "aux": aux}
    return (y,) + tuple(partial_dot(y, partner[k]) for k in dots)


def partial_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A fused dot's unrounded sum over some rows (one device's or a
    shard's): float32 products summed in float64, as the kernels' float64
    partials sum them (ops/blas1.whole_dot's rule); the caller rounds the
    whole dot once, so it does not hang on how the rows are cut.  Other
    dtypes: torch.dot."""
    if a.dtype == torch.float32:
        return torch.sum(a * b, dtype=torch.float64)
    return torch.dot(a, b)


def _box_bit(leg) -> int:
    """The bit of a leg (dx, dy, dz) in a box mask: its position in the
    3 x 3 x 3 box, z, y, x order (-1 outside the box)."""
    dx, dy, dz = leg
    if max(abs(dx), abs(dy), abs(dz)) > 1:
        return -1
    return (dz + 1) * 9 + (dy + 1) * 3 + (dx + 1)


@functools.lru_cache(maxsize=64)
def _launch_table(legs, coeff_values, dims, use_diag: bool, dots):
    """(StencilArgs, n_blocks) for one operator and dot request.

    Legs sharing a coefficient value form one group (one multiply per
    group, groups in ascending value); with `use_diag` the (0,0,0) leg is
    left out, since the kernel adds diag[i]·x[i] itself.  `box_mask[g]`
    holds group g's legs as box positions (`_box_bit`), which the box
    routes read in place of the legs; n_blocks is the leg-loop route's."""
    from ._build import MAX_DOTS, MAX_LEGS, StencilArgs
    if len(legs) > MAX_LEGS or len(dots) > MAX_DOTS:
        raise ValueError(f"the kernel takes at most {MAX_LEGS} legs and "
                         f"{MAX_DOTS} dots")
    nx, ny, nz = dims
    groups = {}
    for l, leg in enumerate(legs):
        if use_diag and leg == (0, 0, 0):
            continue
        groups.setdefault(coeff_values[l], []).append(leg)
    a = StencilArgs()
    j = 0
    for gi, (c, group) in enumerate(sorted(groups.items())):
        a.group_begin[gi] = j
        a.group_coeff[gi] = c
        for (dx, dy, dz) in group:
            a.off[j] = dx + nx * (dy + ny * dz)
            a.dx[j], a.dy[j], a.dz[j] = dx, dy, dz
            bit = _box_bit((dx, dy, dz))
            if bit >= 0:
                a.box_mask[gi] |= 1 << bit
            j += 1
    a.n_groups = len(groups)
    a.group_begin[a.n_groups] = j
    a.nx, a.ny, a.nz = nx, ny, nz
    a.block_x = min(128, -(-nx // 32) * 32)
    a.block_y = _BLOCK_THREADS // a.block_x
    a.grid_x = -(-ny // a.block_y)
    a.grid_y = nz
    if a.grid_y > 65535 or nx * ny * nz >= 2 ** 62:
        raise ValueError(f"grid {dims} exceeds the kernel's launch limits")
    a.n_dots = len(dots)
    for k, kind in enumerate(dots):
        a.dot_kind[k] = DOT_KINDS.index(kind)
    return a, a.grid_x * a.grid_y


def _kernel_form(A: DeviceStencil, x: torch.Tensor):
    """(use_diag, entry-point suffix): the bfloat16-diagonal form where a
    bfloat16 diagonal takes part (the coefficients need no form of their
    own: the launch table carries them as exact doubles)."""
    use_diag = A.diag is not None and (0, 0, 0) in A.legs
    return use_diag, kernel_suffix(x.dtype,
                                   A.diag.dtype if use_diag else x.dtype)


# ---------------------------------------------------------------------------
# The box routes (csrc/stencil_spmv.cu: every leg within the 3x3x3 box)
# ---------------------------------------------------------------------------

def in_box(A: DeviceStencil) -> bool:
    """Does every leg of A lie within |dx|, |dy|, |dz| <= 1 (HPCG and its
    Galerkin levels, FDM 2-D and 3-D, Anderson)?"""
    return _legs_in_box(A.legs)


@functools.lru_cache(maxsize=256)
def _legs_in_box(legs) -> bool:
    return all(_box_bit(leg) >= 0 for leg in legs)


def box_form(A: DeviceStencil):
    """(legs, dims) of A as the box routes march it: a 2-D grid (nz = 1)
    with its y axis as z, legs (dx, dy, 0) as (dx, 0, dy), so the march
    runs along y.  The flat offsets, the boundary masks and the legs'
    z, y, x order are A's, so the arithmetic is the same."""
    return _box_form(A.legs, A.dims)


@functools.lru_cache(maxsize=64)
def _box_form(legs, dims):
    nx, ny, nz = dims
    if nz != 1:
        return legs, dims
    return tuple((dx, dz, dy) for (dx, dy, dz) in legs), (nx, 1, ny)


def box_vec(A: DeviceStencil, x: torch.Tensor, aux=None) -> int:
    """The x values a thread of a box route owns: 16 // itemsize where a
    line is a whole number of 16-byte vectors and every vector read or
    written that wide (x, aux, a diagonal of x's dtype) starts on 16
    bytes, else 1."""
    vec = 16 // x.element_size()
    use_diag = A.diag is not None and (0, 0, 0) in A.legs
    ptrs = [v.data_ptr() for v in (x, aux) if v is not None]
    if use_diag and A.diag.dtype == x.dtype:
        ptrs.append(A.diag.data_ptr())
    if A.dims[0] % vec or any(p % 16 for p in ptrs):
        return 1
    return vec


def route_for(A: DeviceStencil, x: torch.Tensor, aux=None,
              stream: bool = None) -> str:
    """The route of the SpMV kernel that `stencil_spmv` launches for A on a
    card (`stream`: kernel #2 rather than #1; by default `spmv_route`'s
    choice): "box" where every leg lies within the 3x3x3 box and, for #2,
    x's lines are whole 16-byte vectors (its slabs are bulk copies) and
    its ring fits an SM's shared memory (lines up to ~3,000 wide); else
    "legs", the leg-loop kernels (#1's first port, #2's synchronous
    ring).  A rule on the legs, the grid's x extent, the dtype and the
    vectors' alignment, read at each call."""
    if stream is None:
        stream = spmv_route(A) == "stream"
    if not in_box(A):
        return "legs"
    if stream:
        vec = box_vec(A, x, aux)
        if vec == 1 or not _box_resident(True, box_form(A)[1], vec,
                                          x.element_size()):
            return "legs"
    return "box"


#: consumer threads a block of the box routes, a chunk of x each
#: (BIS_BOX_THREADS), and #2's ring depth (BIS_BOX_STAGES)
BOX_THREADS = 256
BOX_STAGES = 8
#: blocks of #1's box route and of #2's in float32 resident on a
#: streaming multiprocessor, as the kernels' __launch_bounds__ ask
#: (BIS_BOX_MIN_BLOCKS, BIS_BOX_STREAM_MIN_BLOCKS); #2 in float64 takes
#: #1's count
BOX_RESIDENT = (2, 3)
#: shared memory of an H100's SM that blocks may take (227 KB)
_SMEM_PER_SM = 232448


def _box_ring_bytes(dims, vec: int, itemsize: int) -> int:
    """Shared memory a block of #2's box route takes on an SM: its ring of
    BOX_STAGES slots, the mbarriers, and the 1 KB the card keeps a
    block."""
    return 128 + BOX_STAGES * _box_slot(dims, vec) * itemsize + 1024


def _box_resident(stream: bool, dims, vec: int, itemsize: int) -> int:
    """Blocks of a box launch resident on an SM: BOX_RESIDENT's, and for
    #2 as far as its ring fits the SM's shared memory (0: not once)."""
    if not stream:
        return BOX_RESIDENT[0]
    return min(BOX_RESIDENT[1] if itemsize == 4 else BOX_RESIDENT[0],
               _SMEM_PER_SM // _box_ring_bytes(dims, vec, itemsize))


@functools.lru_cache(maxsize=64)
def _box_grid(dims, vec: int, sms: int = 132,
              resident: int = 2) -> Tuple[int, int, int]:
    """(grid_x, grid_y, zr) of a box route on `dims` (as `box_form` gives
    them) on a card of `sms` multiprocessors that holds `resident` blocks
    each: grid_x tiles of BOX_THREADS chunks of `vec` x values cover a
    plane, grid_y runs of zr planes cover z.  A block's time grows with
    zr + 2 (its planes and the two beyond them it loads) and the launch
    takes as many of those times as it has waves of resident blocks, so
    zr minimises waves × (zr + 2), the shortest run on a tie."""
    nx, ny, nz = dims
    gx = -(-(nx * ny // vec) // BOX_THREADS)
    wave = resident * sms

    def cost(zr):
        return -(-(gx * -(-nz // zr)) // wave) * (zr + 2)
    zr = min(range(1, nz + 1), key=lambda r: (cost(r), r))
    gy = -(-nz // zr)
    if gy > 65535 or gx >= 2 ** 31:
        raise ValueError(f"grid {dims} exceeds the box route's launch "
                         "limits")
    return gx, gy, zr


def _box_slot(dims, vec: int) -> int:
    """Elements of one slot of #2's ring on the box route: the widest slab
    a block stages (its chunks, a line and a vector on each side, cut to
    the plane)."""
    nx, ny, _ = dims
    return min(nx * ny, BOX_THREADS * vec + 2 * nx + 2 * vec)


def _box_slab(dims, vec: int, bx: int) -> Tuple[int, int]:
    """[lo, hi): the elements of a plane that block column bx of #2's box
    route stages (the kernel's own rule)."""
    nx, ny, _ = dims
    plane = nx * ny
    cb = bx * BOX_THREADS
    ce = min(cb + BOX_THREADS, plane // vec)
    return max(0, cb * vec - nx - vec), min(plane, ce * vec + nx + vec)


# ---------------------------------------------------------------------------
# SpMV
# ---------------------------------------------------------------------------

def _bind_spmv(A: DeviceStencil, x: torch.Tensor, dots, aux, stream: bool,
               route: str):
    """(launch, y, partials, bf16): one launch of kernel #2 (`stream`) or
    #1 on `route` ("box" or "legs") with its operands bound and its
    outputs allocated; launch() makes the ctypes call and raises on a CUDA
    error.  The wrappers call it once a call; a timing loop may call
    launch() many times."""
    from ._build import launch as _launch, load_library
    use_diag, suffix = _kernel_form(A, x)
    kernel = "stencil_spmv_stream" if stream else "stencil_spmv"
    if route == "box":
        if not in_box(A):
            raise ValueError(f"legs {A.legs} lie outside the box route's "
                             "3x3x3 box")
        legs, dims = box_form(A)
        vec = box_vec(A, x, aux if "aux" in dots else None)
        if stream and (vec == 1 or not _box_resident(
                True, dims, vec, x.element_size())):
            raise ValueError("kernel #2's box route needs x in whole "
                             "16-byte vectors of a line and its ring in "
                             "an SM's shared memory")
        args, _ = _launch_table(legs, A.coeff_values, dims, use_diag,
                                tuple(dots))
        gx, gy, zr = _box_grid(dims, vec, sm_count(x.device.index),
                               _box_resident(stream, dims, vec,
                                             x.element_size()))
        grid = ((zr, gx, gy, _box_slot(dims, vec)) if stream
                else (vec, zr, gx, gy))
        n_blocks = gx * gy
        fn = getattr(load_library(), f"bis_{kernel}_box_{suffix}")
    elif route == "legs":
        args, n_blocks = _launch_table(A.legs, A.coeff_values, A.dims,
                                       use_diag, tuple(dots))
        grid = ()
        if stream:
            if not stream_reach(A):
                raise ValueError(f"legs {A.legs} lie outside kernel #2's "
                                 f"halo {STREAM_HALO}")
            grid = _stream_grid(A.dims)
            n_blocks = grid[0] * grid[1] * grid[2]
        fn = getattr(load_library(), f"bis_{kernel}_{suffix}")
    else:
        raise ValueError(f"unknown stencil SpMV route {route!r}")
    y = torch.empty_like(x)
    partials = (torch.empty((n_blocks, len(dots)), dtype=torch.float64,
                            device=x.device) if dots else None)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    argv = (ctypes.byref(args), *grid, ptr(x),
            ptr(A.diag if use_diag else None),
            ptr(aux if "aux" in dots else None), ptr(y), ptr(partials))

    def launch():
        err = _launch(fn, x.device, *argv)
        if err != 0:
            raise RuntimeError(f"{kernel} kernel launch ({route} route) "
                               f"failed with CUDA error {err}")
    return launch, y, partials, suffix.endswith("_bf16")


def _spmv_cuda(counter, A, x, dots, aux, stream, route):
    """Launch #1 or #2 on `route` (by default `route_for`'s), count the
    launch in `counter` (by form and by route) and return y, or (y, *dots)
    with the per-block partials summed."""
    if route is None:
        route = route_for(A, x, aux if "aux" in dots else None, stream)
    launch, y, partials, bf16 = _bind_spmv(A, x, dots, aux, stream, route)
    launch()
    if bf16:
        counter.bf16_launches += 1
    else:
        counter.launches += 1
    if route == "box":
        counter.box_launches += 1
    else:
        counter.legs_launches += 1
    if not dots:
        return y
    return (y,) + tuple(partials.sum(dim=0).to(x.dtype).unbind())


def _stencil_spmv_cuda(A: DeviceStencil, x: torch.Tensor, dots, aux,
                       route: str = None):
    return _spmv_cuda(stencil_spmv, A, x, dots, aux, False, route)


def stream_reach(A: DeviceStencil) -> bool:
    """Is A within kernel #2's reach: every leg inside the staged halo,
    |dx| <= 1, |dy| <= 2, |dz| <= 1?  The JAX package's planar rule
    (`_planar_ok`: |dz| <= 1, |dy| <= 2, |dx| below its lane width), with
    the x reach of #2's halo.  Every stencil the repo builds (HPCG and its
    Galerkin levels, FDM, Anderson) lies within it."""
    return _legs_in_reach(A.legs)


@functools.lru_cache(maxsize=256)
def _legs_in_reach(legs) -> bool:
    hx, hy, hz = STREAM_HALO
    return all(abs(dx) <= hx and abs(dy) <= hy and abs(dz) <= hz
               for (dx, dy, dz) in legs)


def spmv_route(A: DeviceStencil) -> str:
    """The kernel `stencil_spmv` launches for A on a card: "stream" (#2)
    when STREAM is set and A is within #2's reach, else "resident" (#1).
    A static rule on the legs, read at each call."""
    return "stream" if STREAM and stream_reach(A) else "resident"


def stencil_spmv(A: DeviceStencil, x: torch.Tensor, dots=(),
                 aux: torch.Tensor = None):
    """y = A @ x, with optional fused dots drawn from {"x", "self", "aux"}:
    dot(y, x), dot(y, y), dot(y, aux).  Returns y, or (y, *dots).

    A CUDA tensor goes through a hand-written kernel: #1, counting its
    launches in `stencil_spmv.launches` (`stencil_spmv.bf16_launches` for
    its bfloat16-diagonal form) and, by route (`route_for`), in
    `stencil_spmv.box_launches` or `.legs_launches`; or, where
    `spmv_route` says "stream", #2 (`stencil_spmv_stream`).  With STREAM
    set, an operator outside #2's reach launches #1, as the JAX package
    sends it to its non-Pallas path, and is counted in
    `stencil_spmv_stream.outside_reach`; a failed build or launch of
    either kernel raises.  A CPU tensor takes the plain version."""
    dots = tuple(dots)
    _check_operands(A, x, dots, aux)
    if x.device.type == "cuda":
        if STREAM:
            if stream_reach(A):
                return _stencil_spmv_stream_cuda(A, x, dots, aux)
            stencil_spmv_stream.outside_reach += 1
        return _stencil_spmv_cuda(A, x, dots, aux)
    if x.device.type == "cpu":
        return stencil_spmv_plain(A, x, dots, aux)
    raise ValueError(f"no stencil SpMV for device {x.device}")


stencil_spmv.launches = 0
stencil_spmv.bf16_launches = 0
stencil_spmv.box_launches = 0
stencil_spmv.legs_launches = 0


@functools.lru_cache(maxsize=64)
def _stream_grid(dims) -> Tuple[int, int, int, int]:
    """(grid_x, grid_y, grid_z, zc) of kernel #2 on the legs route: a block
    a tile of STREAM_TILE, marching zc planes of z."""
    nx, ny, nz = dims
    gx = -(-nx // STREAM_TILE[0])
    gy = -(-ny // STREAM_TILE[1])
    chunks = min(nz, max(1, -(-_STREAM_BLOCKS // (gx * gy))))
    zc = -(-nz // chunks)
    gz = -(-nz // zc)
    if gy > 65535 or gz > 65535:
        raise ValueError(f"grid {dims} exceeds kernel #2's launch limits")
    return gx, gy, gz, zc


def _stencil_spmv_stream_cuda(A: DeviceStencil, x: torch.Tensor, dots, aux,
                              route: str = None):
    if not stream_reach(A):
        raise ValueError(f"legs {A.legs} lie outside kernel #2's halo "
                         f"{STREAM_HALO}")
    return _spmv_cuda(stencil_spmv_stream, A, x, dots, aux, True, route)


def stencil_spmv_stream(A: DeviceStencil, x: torch.Tensor, dots=(),
                        aux: torch.Tensor = None):
    """Kernel #2: `stencil_spmv`'s function and contract (y, then the
    requested dots y·x, y·y, y·aux; the dense diagonal), with x staged in
    shared memory a z-plane at a time (csrc/stencil_spmv.cu).  A CUDA tensor
    launches it, counted in `stencil_spmv_stream.launches`
    (`stencil_spmv_stream.bf16_launches` for its bfloat16-diagonal form)
    and, by route (`route_for`), in `.box_launches` or `.legs_launches`,
    and raises for an operator outside its reach (`stream_reach`); a CPU
    tensor takes the plain version.  #2 computes the same function as #1,
    so its plain version is #1's, `stencil_spmv_plain`: y equals #1's bit
    for bit, the dots differ only in the order of their sums."""
    dots = tuple(dots)
    _check_operands(A, x, dots, aux)
    if x.device.type == "cuda":
        return _stencil_spmv_stream_cuda(A, x, dots, aux)
    if x.device.type == "cpu":
        return stencil_spmv_plain(A, x, dots, aux)
    raise ValueError(f"no stencil SpMV for device {x.device}")


stencil_spmv_stream.launches = 0
stencil_spmv_stream.bf16_launches = 0
stencil_spmv_stream.box_launches = 0
stencil_spmv_stream.legs_launches = 0
stencil_spmv_stream.outside_reach = 0


# ---------------------------------------------------------------------------
# Shard-local SpMV (the JAX package's halo/row0 form of #1)
# ---------------------------------------------------------------------------

def stencil_shard_rows(dims, halo, n_dev: int) -> int:
    """R_local of a stencil on n_dev shards: whole z-planes where nz ≥
    n_dev, else whole x-lines, enough for n rows and at least the halo
    (HPCG 8x8x8 on 8 shards: a 73-row halo over 64-row planes takes two
    planes a shard, four shards inert)."""
    nx, ny, nz = dims
    unit = nx * ny if nz >= n_dev else nx
    need = max(-(-(nx * ny * nz) // n_dev), max(halo), 1)
    return -(-need // unit) * unit


def _check_window(A: DeviceStencil, xw: torch.Tensor, row0: int, diag,
                  out, dots=(), aux=None) -> int:
    """Check a shard's window and return its own row count: whole x-lines
    from a line start between a halo of A.window_halo (whole lines), the
    diagonal slice (rows,) in A's dtype where A has a diagonal, `out`
    and, for an "aux" dot, `aux` (rows,) like xw."""
    for kind in dots:
        if kind not in DOT_KINDS:
            raise ValueError(f"unknown fused-dot kind: {kind!r}")
    if "aux" in dots and aux is None:
        raise ValueError("dots containing 'aux' require the aux vector")
    hneg, hpos = A.window_halo
    nx = A.dims[0]
    assert hneg % nx == 0 and hpos % nx == 0
    if not isinstance(xw, torch.Tensor) or xw.dim() != 1:
        raise TypeError("the window must be a 1-D torch.Tensor")
    rows = xw.numel() - hneg - hpos
    if rows <= 0 or rows % nx or row0 < 0 or row0 % nx:
        raise ValueError(f"a shard owns whole x-lines: window of "
                         f"{xw.numel()} with halo ({hneg}, {hpos}), row0 "
                         f"{row0}, nx {nx}")
    if not serves_vectors(A.dtype, xw.dtype):
        raise TypeError(f"xw is {xw.dtype}, the operator {A.dtype}")
    if xw.device != A.device or not xw.is_contiguous():
        raise ValueError("the window must be contiguous, on the operator's "
                         "device")
    if (diag is None) != (A.diag is None):
        raise ValueError("pass the shard's diagonal slice exactly when the "
                         "operator has a diagonal")
    for name, v, dt in (("diag", diag, A.dtype), ("out", out, xw.dtype),
                        ("aux", aux if "aux" in dots else None, xw.dtype)):
        if v is not None and (v.shape != (rows,) or v.dtype != dt
                              or v.device != xw.device
                              or not v.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous ({rows},) "
                             f"{dt} tensor on {xw.device}")
    return rows


def stencil_spmv_halo_plain(A: DeviceStencil, xw: torch.Tensor, row0: int,
                            dots=(), aux: torch.Tensor = None,
                            diag: torch.Tensor = None):
    """Plain PyTorch version of the shard-local kernel: the shard's rows
    [row0, row0 + rows) of A·x, read from its window xw (its left
    neighbour's last hneg rows, its own rows, its right neighbour's first
    hpos rows: (hneg, hpos) = A.window_halo), masked by global
    coordinates, inert past n; `diag`
    is the shard's slice of A's diagonal, the dots are the shard's partial
    sums (`partial_dot`: float64 for float32 vectors, which the mesh
    rounds once after summing the shards).  Returns y, or (y, *dots)."""
    dots = tuple(dots)
    _check_window(A, xw, row0, diag, None, dots, aux)
    return _spmv_window_plain(A, xw, row0, dots, aux, diag)


def halo_route_for(A: DeviceStencil, xw: torch.Tensor,
                   aux: torch.Tensor = None, diag: torch.Tensor = None,
                   out: torch.Tensor = None) -> str:
    """The route of the shard-local SpMV that `stencil_spmv_halo`
    launches on a card: "box" (#1's box route on the window) where every
    leg lies within the 3x3x3 box, a line is whole 16-byte vectors and
    every operand read or written 16 bytes wide (the window, aux when an
    "aux" dot is asked, a diagonal of x's dtype, `out`) starts on 16
    bytes; else "legs" (the first port's leg loop: legs outside the box,
    37-wide lines, an operand off 16 bytes).  The window's halo is whole
    lines (A.window_halo), so the shard's rows start on a vector.  A rule
    on the legs, the grid's x extent and the operands' alignment, read at
    each call."""
    ptrs = [v.data_ptr() for v in (xw, aux, out) if v is not None]
    ptrs += _gs_diag_ptrs(A, xw, diag)
    ok = (in_box(A) and A.dims[0] % (16 // xw.element_size()) == 0
          and not any(p % 16 for p in ptrs))
    return "box" if ok else "legs"


def _shard_box_grid(dims, vec: int, row0: int, rows: int, sms: int,
                    resident: int) -> Tuple[int, int, int]:
    """(zr, grid_x, grid_y) of a box route over rows [row0, row0 + rows)
    of `dims` (box_form's): `_box_grid` over the planes holding them,
    with `resident` blocks an SM."""
    nx, ny, _nz = dims
    plane = nx * ny
    qa, qb = row0 // plane, -(-(row0 + rows) // plane)
    gx, gy, zr = _box_grid((nx, ny, qb - qa), vec, sms, resident)
    return zr, gx, gy


def _bind_spmv_halo(A: DeviceStencil, xw, row0, rows, dots, aux, diag, out,
                    route: str):
    """(launch, y, partials, bf16): one launch of the shard-local SpMV on
    `route` ("box" or "legs") with its operands bound and its outputs
    allocated (y is `out` where given); launch() makes the ctypes call and
    raises on a CUDA error.  The wrapper calls it once a call; a timing
    loop may call launch() many times."""
    from ._build import launch as _launch, load_library
    use_diag, suffix = _kernel_form(A, xw)
    if route == "box":
        if not in_box(A):
            raise ValueError(f"legs {A.legs} lie outside the box route's "
                             "3x3x3 box")
        legs, dims = box_form(A)
        args, _ = _launch_table(legs, A.coeff_values, dims, use_diag,
                                tuple(dots))
        zr, gx, gy = _shard_box_grid(dims, 16 // xw.element_size(), row0,
                                     rows, sm_count(xw.device.index),
                                     BOX_RESIDENT[0])
        n_blocks = gx * gy
        fn = getattr(load_library(), f"bis_stencil_spmv_halo_box_{suffix}")
        shard = (zr, gx, gy, row0, rows, A.window_halo[0], xw.numel())
    elif route == "legs":
        args, _ = _launch_table(A.legs, A.coeff_values, A.dims, use_diag,
                                tuple(dots))
        nx = A.dims[0]
        lines = rows // nx
        n_blocks = -(-lines // args.block_y) * -(-nx // args.block_x)
        fn = getattr(load_library(), f"bis_stencil_spmv_halo_{suffix}")
        shard = (row0, lines, A.n_rows, A.window_halo[0])
    else:
        raise ValueError(f"unknown shard SpMV route {route!r}")
    y = torch.empty_like(xw[:rows]) if out is None else out
    partials = (torch.empty((n_blocks, len(dots)), dtype=torch.float64,
                            device=xw.device) if dots else None)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    argv = (ctypes.byref(args), *shard, ptr(xw),
            ptr(diag if use_diag else None),
            ptr(aux if "aux" in dots else None), ptr(y), ptr(partials))

    def launch():
        err = _launch(fn, xw.device, *argv)
        if err != 0:
            raise RuntimeError(f"stencil_spmv_halo kernel launch ({route} "
                               f"route) failed with CUDA error {err}")
    return launch, y, partials, suffix.endswith("_bf16")


def _stencil_spmv_halo_cuda(A: DeviceStencil, xw, row0, rows, dots, aux,
                            diag, out, route: str = None):
    """Launch the shard-local SpMV on `route` (by default
    `halo_route_for`'s), count the launch (by form and by route) and
    return y, or (y, *dots) with the per-block partials summed (the
    shard's float64 partial dots: `partial_dot`'s)."""
    if route is None:
        route = halo_route_for(A, xw, aux if "aux" in dots else None, diag,
                               out)
    launch, y, partials, bf16 = _bind_spmv_halo(A, xw, row0, rows, dots, aux,
                                                diag, out, route)
    launch()
    if bf16:
        stencil_spmv_halo.bf16_launches += 1
    else:
        stencil_spmv_halo.launches += 1
    setattr(stencil_spmv_halo, f"{route}_launches",
            getattr(stencil_spmv_halo, f"{route}_launches") + 1)
    if not dots:
        return y
    return (y,) + tuple(partials.sum(dim=0).unbind())


def stencil_spmv_halo(A: DeviceStencil, xw: torch.Tensor, row0: int,
                      dots=(), aux: torch.Tensor = None,
                      diag: torch.Tensor = None,
                      out: torch.Tensor = None):
    """One mesh shard's SpMV (the JAX package's stencil_spmv_resident with
    halo= and row0=): `stencil_spmv_halo_plain`'s contract (the window's
    halo A.window_halo), y written to `out` when given.  A
    CUDA tensor launches the shard-local kernel (csrc/stencil_spmv.cu),
    counted in `stencil_spmv_halo.launches` (`.bf16_launches` for the
    bfloat16-diagonal form) and, by route (`halo_route_for`), in
    `.box_launches` or `.legs_launches`: y bit-equal to #1's rows on
    both; a CPU tensor takes the plain version (a meta tensor its
    shapes)."""
    dots = tuple(dots)
    rows = _check_window(A, xw, row0, diag, out, dots, aux)
    if xw.device.type == "cuda":
        return _stencil_spmv_halo_cuda(A, xw, row0, rows, dots, aux, diag,
                                       out)
    if xw.device.type not in ("cpu", "meta"):
        raise ValueError(f"no stencil SpMV for device {xw.device}")
    res = _spmv_window_plain(A, xw, row0, dots, aux, diag)
    if out is None:
        return res
    out.copy_(res[0] if dots else res)
    return (out,) + tuple(res[1:]) if dots else out


stencil_spmv_halo.launches = 0
stencil_spmv_halo.bf16_launches = 0
stencil_spmv_halo.box_launches = 0
stencil_spmv_halo.legs_launches = 0


# ---------------------------------------------------------------------------
# Multicolour Gauss-Seidel step
# ---------------------------------------------------------------------------

def _colors(color) -> Tuple[int, ...]:
    return tuple(int(c) for c in color) if isinstance(color, (tuple, list)) \
        else (int(color),)


def _check_gs_operands(A: DeviceStencil, x, rhs, dinv, spec):
    _check_operands(A, x, (), None)
    for name, v in (("rhs", rhs), ("dinv", dinv)):
        if not isinstance(v, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if (v.shape != x.shape or v.dtype != x.dtype
                or v.device != x.device):
            raise ValueError(f"{name} must match x in shape, dtype and "
                             "device")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if spec.kind in ("grid", "parity") and tuple(spec.params[:3]) != A.dims:
        raise ValueError(f"colour spec dims {spec.params[:3]} do not match "
                         f"the operator's {A.dims}")


def stencil_gs_color_step_plain(A: DeviceStencil, x: torch.Tensor,
                                rhs: torch.Tensor, dinv: torch.Tensor, spec,
                                color) -> torch.Tensor:
    """Plain PyTorch version of the kernel: per colour c (in the given
    order), the full plain SpMV then
    x = where(colour == c, x + (rhs − A·x)·dinv, x)."""
    from .coloring import color_ids
    _check_gs_operands(A, x, rhs, dinv, spec)
    ids = color_ids(spec, A)
    for c in _colors(color):
        Ax = stencil_spmv_plain(A, x)
        x = torch.where(ids == c, x + (rhs - Ax) * dinv, x)
    return x


def _check_gs_window(A: DeviceStencil, xw, row0, rhs, dinv, spec, diag,
                     out) -> int:
    rows = _check_window(A, xw, row0, diag, out)
    for name, v in (("rhs", rhs), ("dinv", dinv)):
        if (not isinstance(v, torch.Tensor) or v.shape != (rows,)
                or v.dtype != xw.dtype or v.device != xw.device
                or not v.is_contiguous()):
            raise ValueError(f"{name} must be the shard's contiguous "
                             f"({rows},) slice, like xw")
    if spec.kind in ("grid", "parity") and tuple(spec.params[:3]) != A.dims:
        raise ValueError(f"colour spec dims {spec.params[:3]} do not match "
                         f"the operator's {A.dims}")
    return rows


def _next_window(xw, own, hneg: int):
    """xw with its own rows replaced by `own` (the next colour of a tuple
    reads the shard's updated rows; the halo rows hold no colour of the
    tuple)."""
    return torch.cat([xw[:hneg], own, xw[hneg + own.numel():]])


def stencil_gs_color_step_halo_plain(A: DeviceStencil, xw: torch.Tensor,
                                     row0: int, rhs: torch.Tensor,
                                     dinv: torch.Tensor, spec, color,
                                     diag: torch.Tensor = None
                                     ) -> torch.Tensor:
    """Plain PyTorch version of the shard-local GS step: per colour c, the
    shard's plain SpMV from its window (its halo A.window_halo), then its
    own rows x = where(colour == c, x + (rhs − A·x)·dinv,
    x), colours and masks from global coordinates, inert rows (at or past
    n) copied through.  rhs and dinv are the shard's slices; returns its
    own rows."""
    from .coloring import color_ids_of
    rows = _check_gs_window(A, xw, row0, rhs, dinv, spec, diag, None)
    hneg = A.window_halo[0]
    g = row0 + torch.arange(rows, device=xw.device)
    ids = torch.where(g < A.n_rows, color_ids_of(spec, g), -1)
    colors = _colors(color)
    for j, c in enumerate(colors):
        Ax = _spmv_window_plain(A, xw, row0, (), None, diag)
        x = xw[hneg:hneg + rows]
        x = torch.where(ids == c, x + (rhs - Ax) * dinv, x)
        if j + 1 < len(colors):
            xw = _next_window(xw, x, hneg)
    return x


_COLOR_KINDS = {"parity": 0, "grid": 1, "mod": 2}


def _gs_color_params(A: DeviceStencil, spec, box: bool):
    """(kind, p0, p1, p2) of the GS step's colouring for a launch table in
    A's axes, or (`box`) in box_form's, where a 2-D grid colouring's
    (sx, sy) come as (sx, 1, sy)."""
    if spec.kind == "grid":
        sx, sy, sz = spec.params[3:6]
        p = (sx, 1, sy) if box and A.dims[2] == 1 else (sx, sy, sz)
    else:
        p = (spec.params[0], 1, 1) if spec.kind == "mod" else (1, 1, 1)
    return (_COLOR_KINDS[spec.kind],) + tuple(int(v) for v in p)


def _gs_box_ok(A: DeviceStencil, spec, itemsize: int, ptrs) -> bool:
    """#3's box route takes A: every leg within the 3x3x3 box (as #1's box
    route), a parity or grid colouring, lines of whole 16-byte vectors,
    every operand read or written 16 bytes wide (`ptrs`) starting on 16
    bytes; and float32
    vectors, or a flat plane (a 2-D operator: box_form's ny = 1).  In
    float64 on three-line planes (HPCG, Anderson) the box route, at its
    128-register cap, ran slower than the leg loop on the H100 (PERF.md,
    PR 15), so the leg loop keeps those."""
    vec = 16 // itemsize
    flat = box_form(A)[1][1] == 1
    return (in_box(A) and spec.kind in ("parity", "grid")
            and (itemsize == 4 or flat)
            and A.dims[0] % vec == 0 and not any(p % 16 for p in ptrs))


def _gs_diag_ptrs(A: DeviceStencil, x, diag):
    """The diagonal among the operands read 16 bytes wide: where it takes
    part and is stored in x's dtype (a bfloat16 one is read value by
    value)."""
    use_diag = diag is not None and (0, 0, 0) in A.legs
    return [diag.data_ptr()] if use_diag and diag.dtype == x.dtype else []


def gs_route_for(A: DeviceStencil, x: torch.Tensor, rhs: torch.Tensor,
                 dinv: torch.Tensor, spec) -> str:
    """The route of the GS colour-step kernel that `stencil_gs_color_step`
    launches on a card: "box" (#1's box pieces with the step's epilogue)
    where `_gs_box_ok` holds for x, rhs, dinv and A's diagonal, else
    "legs" (the first port's leg loop: legs outside the box, the mod
    colouring, lines not of whole vectors, unaligned operands, float64 on
    a 3-D grid).  A rule on the legs, the colouring, the grid's extents,
    the dtype and the operands' alignment, read at each call."""
    ptrs = [x.data_ptr(), rhs.data_ptr(), dinv.data_ptr(),
            *_gs_diag_ptrs(A, x, A.diag)]
    return "box" if _gs_box_ok(A, spec, x.element_size(), ptrs) else "legs"


#: blocks of #3's box route resident on an SM where a box_form plane is
#: one line (ny = 1, every 2-D operator: BIS_GS_BOX_FLAT_BLOCKS, its
#: __launch_bounds__); three-line planes take #1's BOX_RESIDENT[0]
GS_BOX_FLAT_RESIDENT = 4


def _gs_box_grid(dims, vec: int, row0: int, rows: int,
                 sms: int) -> Tuple[int, int, int]:
    """(zr, grid_x, grid_y) of #3's box route on `dims` (box_form's) over
    rows [row0, row0 + rows): `_shard_box_grid` with the blocks an SM the
    kernel's form holds."""
    return _shard_box_grid(dims, vec, row0, rows, sms,
                           GS_BOX_FLAT_RESIDENT if dims[1] == 1
                           else BOX_RESIDENT[0])


def _gs_box_launch(A: DeviceStencil, x, spec, row0: int, rows: int,
                   use_diag: bool):
    """(args, color params, grid) of #3's box route over rows [row0,
    row0 + rows) (whole lines): the launch table in box_form's axes, the
    colouring's parameters there, and `_gs_box_grid`'s grid."""
    legs, dims = box_form(A)
    args, _ = _launch_table(legs, A.coeff_values, dims, use_diag, ())
    grid = _gs_box_grid(dims, 16 // x.element_size(), row0, rows,
                        sm_count(x.device.index))
    return args, _gs_color_params(A, spec, box=True), grid


def _stencil_gs_color_step_cuda(A: DeviceStencil, x, rhs, dinv, spec, color,
                                route: str = None):
    from ._build import launch as _launch, load_library
    use_diag, suffix = _kernel_form(A, x)
    if route is None:
        route = gs_route_for(A, x, rhs, dinv, spec)
    lib = load_library()
    if route == "box":
        args, p, grid = _gs_box_launch(A, x, spec, 0, A.n_rows, use_diag)
        fn = getattr(lib, f"bis_stencil_gs_color_step_box_{suffix}")
    elif route == "legs":
        args, _ = _launch_table(A.legs, A.coeff_values, A.dims, use_diag, ())
        p, grid = _gs_color_params(A, spec, box=False), ()
        fn = getattr(lib, f"bis_stencil_gs_color_step_{suffix}")
    else:
        raise ValueError(f"unknown GS step route {route!r}")
    diag = A.diag.data_ptr() if use_diag else None
    for c in _colors(color):
        out = torch.empty_like(x)
        err = _launch(fn, x.device, ctypes.byref(args), *p, c, *grid,
                      x.data_ptr(), diag, rhs.data_ptr(), dinv.data_ptr(),
                      out.data_ptr())
        if err != 0:
            raise RuntimeError(f"stencil_gs_color_step kernel launch ({route}"
                               f" route) failed with CUDA error {err}")
        if suffix.endswith("_bf16"):
            stencil_gs_color_step.bf16_launches += 1
        else:
            stencil_gs_color_step.launches += 1
        setattr(stencil_gs_color_step, f"{route}_launches",
                getattr(stencil_gs_color_step, f"{route}_launches") + 1)
        x = out
    return x


def stencil_gs_color_step(A: DeviceStencil, x: torch.Tensor,
                          rhs: torch.Tensor, dinv: torch.Tensor, spec,
                          color) -> torch.Tensor:
    """One multicolour Gauss-Seidel step, out of place:
    x' = where(colour == c, x + (rhs − A·x)·D⁻¹, x), the colour ids from
    the ColorSpec `spec` (coloring.py).  `color` may be a tuple of colours,
    run in order (the JAX package's superstep).

    A CUDA tensor goes through the hand-written kernel, one launch per
    colour, counted in `stencil_gs_color_step.launches`
    (`stencil_gs_color_step.bf16_launches` for its bfloat16-diagonal form)
    and, by route (`gs_route_for`), in `.box_launches` or
    `.legs_launches`: x' is the same on both, bit for bit; a CPU tensor
    takes the plain version."""
    _check_gs_operands(A, x, rhs, dinv, spec)
    if x.device.type == "cuda":
        return _stencil_gs_color_step_cuda(A, x, rhs, dinv, spec, color)
    if x.device.type == "cpu":
        return stencil_gs_color_step_plain(A, x, rhs, dinv, spec, color)
    raise ValueError(f"no GS colour step for device {x.device}")


stencil_gs_color_step.launches = 0
stencil_gs_color_step.bf16_launches = 0
stencil_gs_color_step.box_launches = 0
stencil_gs_color_step.legs_launches = 0


def gs_halo_route_for(A: DeviceStencil, xw: torch.Tensor,
                      rhs: torch.Tensor, dinv: torch.Tensor, spec,
                      diag: torch.Tensor = None,
                      out: torch.Tensor = None) -> str:
    """The route of the shard-local GS step that
    `stencil_gs_color_step_halo` launches: "box" where `_gs_box_ok` holds
    for the window, the shard's rhs, dinv, diagonal slice and `out` (the
    window's halo, A.window_halo, is whole lines, so every line an owned
    row reads lies inside the window), else "legs"."""
    ptrs = [xw.data_ptr(), rhs.data_ptr(), dinv.data_ptr(),
            *_gs_diag_ptrs(A, xw, diag)]
    if out is not None:
        ptrs.append(out.data_ptr())
    return "box" if _gs_box_ok(A, spec, xw.element_size(), ptrs) else "legs"


def _stencil_gs_color_step_halo_cuda(A: DeviceStencil, xw, row0, rows,
                                     rhs, dinv, spec, color, diag, out,
                                     route: str = None):
    from ._build import launch as _launch, load_library
    use_diag, suffix = _kernel_form(A, xw)
    if route is None:
        route = gs_halo_route_for(A, xw, rhs, dinv, spec, diag, out)
    hneg = A.window_halo[0]
    if route == "box":
        args, p, grid = _gs_box_launch(A, xw, spec, row0, rows, use_diag)
        fn = getattr(load_library(),
                     f"bis_stencil_gs_color_step_halo_box_{suffix}")
        shard = (row0, rows, hneg, xw.numel())
    elif route == "legs":
        args, _ = _launch_table(A.legs, A.coeff_values, A.dims, use_diag, ())
        p, grid = _gs_color_params(A, spec, box=False), ()
        fn = getattr(load_library(),
                     f"bis_stencil_gs_color_step_halo_{suffix}")
        shard = (row0, rows // A.dims[0], A.n_rows, hneg)
    else:
        raise ValueError(f"unknown GS step route {route!r}")
    d = diag.data_ptr() if use_diag else None
    colors = _colors(color)
    for j, c in enumerate(colors):
        y = out if (out is not None and j + 1 == len(colors)) else \
            torch.empty_like(xw[:rows])
        err = _launch(fn, xw.device, ctypes.byref(args), *p, c, *grid,
                      *shard, xw.data_ptr(), d, rhs.data_ptr(),
                      dinv.data_ptr(), y.data_ptr())
        if err != 0:
            raise RuntimeError(f"stencil_gs_color_step_halo kernel launch "
                               f"({route} route) failed with CUDA error "
                               f"{err}")
        if suffix.endswith("_bf16"):
            stencil_gs_color_step_halo.bf16_launches += 1
        else:
            stencil_gs_color_step_halo.launches += 1
        setattr(stencil_gs_color_step_halo, f"{route}_launches",
                getattr(stencil_gs_color_step_halo, f"{route}_launches") + 1)
        if j + 1 < len(colors):
            xw = _next_window(xw, y, hneg)
    return y


def stencil_gs_color_step_halo(A: DeviceStencil, xw: torch.Tensor,
                               row0: int, rhs: torch.Tensor,
                               dinv: torch.Tensor, spec, color,
                               diag: torch.Tensor = None,
                               out: torch.Tensor = None) -> torch.Tensor:
    """One mesh shard's GS colour step (the JAX package's
    stencil_gs_color_step with halo= and row0=):
    `stencil_gs_color_step_halo_plain`'s contract (the window's halo
    A.window_halo), the shard's new rows written to `out` when given.  A tuple of colours runs in order from
    one window (the JAX package's superstep: its colours couple only along
    x, inside the shard's lines).  A CUDA tensor launches the shard-local
    kernel once per colour, counted in `stencil_gs_color_step_halo.launches`
    (`.bf16_launches` for the bfloat16-diagonal form) and, by route
    (`gs_halo_route_for`), in `.box_launches` or `.legs_launches`:
    bit-equal to #3's rows; a CPU tensor takes the plain version."""
    rows = _check_gs_window(A, xw, row0, rhs, dinv, spec, diag, out)
    if xw.device.type == "cuda":
        return _stencil_gs_color_step_halo_cuda(A, xw, row0, rows, rhs, dinv,
                                                spec, color, diag, out)
    if xw.device.type != "cpu":
        raise ValueError(f"no GS colour step for device {xw.device}")
    x = stencil_gs_color_step_halo_plain(A, xw, row0, rhs, dinv, spec, color,
                                         diag)
    return x if out is None else out.copy_(x)


stencil_gs_color_step_halo.launches = 0
stencil_gs_color_step_halo.bf16_launches = 0
stencil_gs_color_step_halo.box_launches = 0
stencil_gs_color_step_halo.legs_launches = 0


def stencil_diag(A: DeviceStencil) -> torch.Tensor:
    """Dense main diagonal (n,)."""
    if A.diag is not None:
        return A.diag
    for l, leg in enumerate(A.legs):
        if leg == (0, 0, 0):
            return torch.full((A.n_rows,), 1.0, dtype=A.dtype,
                              device=A.device) * A.coeffs[l]
    raise ValueError("stencil has no (0,0,0) leg")


def stencil_diag_vec(A: DeviceStencil) -> torch.Tensor:
    """The diagonal in A's vector layout, which here is always flat."""
    return stencil_diag(A)


def stencil_split(A: DeviceStencil):
    """(L_strict, U_strict, D, D_inv) by the linear-offset sign of each
    leg; D and D_inv are flat vectors in A's dtype."""
    nx, ny, nz = A.dims
    if A.diag is None and (0, 0, 0) not in A.legs:
        raise ValueError("matrix has no stored main diagonal")
    lower, upper = [], []
    for leg, c in zip(A.legs, A.coeff_values):
        lin = leg[0] + nx * (leg[1] + ny * leg[2])
        if lin < 0:
            lower.append((leg, c))
        elif lin > 0:
            upper.append((leg, c))
    L = make_stencil(lower, nx, ny, nz, dtype=A.dtype, device=A.device)
    U = make_stencil(upper, nx, ny, nz, dtype=A.dtype, device=A.device)
    if A.shards != 1:   # the splits share the parent's shard layout
        L = dataclasses.replace(L, shards=A.shards)
        U = dataclasses.replace(U, shards=A.shards)
    D = stencil_diag_vec(A)
    if bool((D == 0).any()):
        raise ValueError("zero on the matrix diagonal")
    return L, U, D, 1.0 / D


def stencil_to_dia(A: DeviceStencil):
    """A as an explicit DeviceDIA on its own device (format comparisons,
    paths that need matrix data): the legs' diagonals as dia.py builds
    them, a dense diagonal written into offset 0."""
    from .dia import _stencil_dia
    nx, ny, nz = A.dims
    M = _stencil_dia(nx, ny, nz, list(zip(A.legs, A.coeff_values)), A.dtype,
                     A.device)
    if A.diag is not None:
        M.data[M.offsets.index(0)] = stencil_diag(A)
    return M


# ---------------------------------------------------------------------------
# Builders / source dispatch
# ---------------------------------------------------------------------------

def stencil_27pt_operator(nx: int, ny: int = None, nz: int = None,
                          diag: float = 26.0, off: float = -1.0,
                          dtype=torch.float32, *,
                          device="cuda") -> DeviceStencil:
    ny = nx if ny is None else ny
    nz = nx if nz is None else nz
    legs = [((dx, dy, dz), diag if (dx, dy, dz) == (0, 0, 0) else off)
            for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    return make_stencil(legs, nx, ny, nz, dtype=dtype, device=device)


def fdm_2d_operator(nx: int, diag: float = -4.0, off: float = 1.0,
                    dtype=torch.float32, *, device="cuda") -> DeviceStencil:
    legs = [((0, 0, 0), diag)]
    legs += [((dx, dy, 0), off)
             for (dx, dy) in ((-1, 0), (1, 0), (0, -1), (0, 1))]
    return make_stencil(legs, nx, nx, 1, dtype=dtype, device=device)


def anderson_operator(Lx: int, Ly: int = None, Lz: int = None,
                      t: float = 1.0, ranpot: float = 0.0, seed: int = 1,
                      boundary: str = "open", dtype=torch.float32, *,
                      device="cuda") -> DeviceStencil:
    if boundary != "open":
        raise ValueError("stencil operator supports open boundary only")
    Ly = Lx if Ly is None else Ly
    Lz = Lx if Lz is None else Lz
    n = Lx * Ly * Lz
    # numpy's generator, as the JAX package draws it: both build one operator
    eps = np.random.default_rng(seed).uniform(-ranpot / 2.0, ranpot / 2.0,
                                              size=n)
    legs = [((dx, dy, dz), -t)
            for (dx, dy, dz) in ((-1, 0, 0), (1, 0, 0), (0, -1, 0),
                                 (0, 1, 0), (0, 0, -1), (0, 0, 1))]
    legs.append(((0, 0, 0), 0.0))
    return make_stencil(legs, Lx, Ly, Lz, dtype=dtype, diag=eps,
                        device=device)


_GEN_RE = re.compile(r"^(scamac|hpcg|fdm|anderson):(.*)$", re.IGNORECASE)


def stencil_buildable(source: str) -> bool:
    """True when from_source_operator can build this spec."""
    m = _GEN_RE.match(source)
    if not m:
        return False
    kind = m.group(1).lower()
    if kind == "scamac":
        from .generators import _split_scamac_spec
        return _split_scamac_spec(m.group(2))[0] == "anderson"
    return True


def from_source_operator(source: str, dtype=torch.float32, *,
                         device="cuda") -> DeviceStencil:
    """Matrix-free operator for a generator spec: `hpcg:NXxNYxNZ`,
    `fdm:N`, `anderson:Lx=..,...` or `scamac:Anderson,...`."""
    m = _GEN_RE.match(source)
    if not m:
        raise ValueError(f"not a stencil-operator source: {source}")
    kind, spec = m.group(1).lower(), m.group(2)
    if kind in ("scamac", "anderson"):
        from .generators import _parse_anderson_kwargs
        return anderson_operator(dtype=dtype, device=device,
                                 **_parse_anderson_kwargs(spec))
    if kind == "hpcg":
        dims = [int(d) for d in re.split(r"[x,]", spec) if d]
        return stencil_27pt_operator(*dims, dtype=dtype, device=device)
    return fdm_2d_operator(int(spec), dtype=dtype, device=device)
