"""Multicolour orderings → parallel exact Gauss-Seidel.

The JAX package's coloring.py in PyTorch, for the matrix-free stencils.
After a proper colouring, rows of one colour never couple, so a
Gauss-Seidel sweep in colour-sorted order is one parallel step per colour:

    for c in colours (ascending):
        x ← where(colour == c, x + (y − A·x)·D⁻¹, x)

evaluated with the full operator in the original (flat, natural) ordering.
From x = 0 the sweep is the exact triangular solve (L_c + D)⁻¹y (forward)
or (U_c + D)⁻¹y (reverse colour order) of the colour-sorted ordering.

Colourings of a stencil come from index arithmetic, never from stored ids:

* grid   — per-axis block colouring with strides s_a = max|leg_a| + 1
           (2×2×2 = 8 colours for HPCG's 27-point stencil);
* parity — red-black, (x + y + z) mod 2, when every leg has odd
           |dx|+|dy|+|dz| (FDM 5-point, Anderson 7-point);
* mod    — colour = row mod k for the smallest k ≥ 2 dividing no stored
           offset (DIA matrices; a diagonal-only stencil: k = 1);
* greedy — general host CSR: sequential first-fit, or balanced (the
           least-loaded admissible colour), carried as a colour-id array.

Colouring changes the sweep order, so coloured GS/SGS is a different
(equally valid) iteration from the reference's natural-order GS.

`colored_sweep` runs each colour step of a stencil with a structural
colouring through `stencil_gs_color_step` (the hand-written kernel on a
CUDA tensor, the plain version on a CPU one); any other operator or a
colour-id array takes one SpMV of the full operator and a masked update
per colour, as the JAX package's generic branch does.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ColorSpec:
    """Static (hashable) description of a colouring.

    kind "grid":   params = (nx, ny, nz, sx, sy, sz); colour from grid coords.
    kind "parity": params = (nx, ny, nz); colour = (x + y + z) mod 2.
    kind "mod":    params = (k,); colour = row mod k.
    """

    kind: str
    n_colors: int
    params: Tuple[int, ...] = ()


def grid_color_spec(legs, dims) -> ColorSpec:
    """Proper colouring of a constant-stencil adjacency graph: red-black
    when every nonzero leg has odd |dx|+|dy|+|dz|, else per-axis blocks
    with stride max|d_a|+1 per axis."""
    nx, ny, nz = dims
    nonzero = [leg for leg in legs if leg != (0, 0, 0)]
    if not nonzero:
        return ColorSpec("mod", 1, (1,))
    if all((abs(dx) + abs(dy) + abs(dz)) % 2 == 1 for dx, dy, dz in nonzero):
        return ColorSpec("parity", 2, (nx, ny, nz))
    sx = min(max(abs(leg[0]) for leg in nonzero) + 1, nx)
    sy = min(max(abs(leg[1]) for leg in nonzero) + 1, ny)
    sz = min(max(abs(leg[2]) for leg in nonzero) + 1, nz)
    return ColorSpec("grid", sx * sy * sz, (nx, ny, nz, sx, sy, sz))


def mod_color_spec(offsets, n_rows: int) -> ColorSpec:
    """colour[i] = i mod k with the smallest k ≥ 2 dividing no nonzero
    offset: rows i and i+d then never share a colour."""
    offs = sorted({abs(int(o)) for o in offsets if int(o) != 0})
    if not offs:
        return ColorSpec("mod", 1, (1,))
    k = 2
    while any(o % k == 0 for o in offs):
        k += 1
        if k > n_rows:
            raise ValueError("no valid modular coloring (dense band?)")
    return ColorSpec("mod", min(k, n_rows), (min(k, n_rows),))


@functools.lru_cache(maxsize=16)
def _color_ids_cached(spec: ColorSpec, n: int, device: str) -> torch.Tensor:
    return color_ids_of(spec, torch.arange(n, dtype=torch.int64,
                                           device=device))


def color_ids_of(spec: ColorSpec, i: torch.Tensor) -> torch.Tensor:
    """The colour of each global row index in `i` (a mesh shard's rows)."""
    if spec.kind == "mod":
        return i % spec.params[0]
    nx, ny = spec.params[0], spec.params[1]
    x = i % nx
    y = (i // nx) % ny
    z = i // (nx * ny)
    if spec.kind == "parity":
        return (x + y + z) % 2
    if spec.kind == "grid":
        sx, sy, sz = spec.params[3:6]
        return (x % sx) + sx * ((y % sy) + sy * (z % sz))
    raise ValueError(f"unknown color spec kind: {spec.kind}")


def color_ids(spec: ColorSpec, A) -> torch.Tensor:
    """int64 colour id per row of A, in its flat vector layout (cached per
    spec, size and device); a mesh operator's a MeshVector of its layout,
    each shard's ids made on its device (cached on the operator)."""
    from .parallel.mesh_ops import DIST_TYPES, MESH_TYPES, unwrap
    if isinstance(A, MESH_TYPES):
        key = (spec, A.rows)
        cache = A.__dict__.setdefault("_color_ids", {})
        if key not in cache:
            cache[key] = A.blocks.from_rows(lambda lo, hi, dev: color_ids_of(
                spec, torch.arange(lo, hi, dtype=torch.int64, device=dev)))
        return cache[key]
    if isinstance(A, DIST_TYPES):
        # a GSPMD operator's: the rank's rows, a Shard(0) DTensor
        from .parallel.gspmd import from_rows
        lay = A.layout
        return from_rows(color_ids(spec, A.inner)[
            lay.start:lay.start + lay.rows], lay)
    A = unwrap(A)
    return _color_ids_cached(spec, A.n_rows, str(A.device))


def _grid_coords(idx, nx: int, ny: int):
    """(x, y, z) grid coordinates of flat x-fastest row indices (NumPy)."""
    q, x = np.divmod(idx, nx)
    z, y = np.divmod(q, ny)
    return x, y, z


def spec_colors_np(spec: ColorSpec, n: int) -> np.ndarray:
    """int32 colour id per row, the NumPy twin of color_ids for host
    set-up work."""
    i = np.arange(n, dtype=np.int32 if n < 2**31 else np.int64)
    if spec.kind == "mod":
        return (i % spec.params[0]).astype(np.int32)
    if spec.kind not in ("parity", "grid"):
        raise ValueError(f"unknown color spec kind: {spec.kind}")
    x, y, z = _grid_coords(i, spec.params[0], spec.params[1])
    if spec.kind == "parity":
        return ((x + y + z) % 2).astype(np.int32)
    sx, sy, sz = spec.params[3:6]
    return ((x % sx) + sx * ((y % sy) + sy * (z % sz))).astype(np.int32)


def greedy_coloring(A, balanced: bool = False) -> np.ndarray:
    """Sequential greedy colouring of the (structurally symmetric) host CSR
    graph, int32 ids; `balanced` picks the least-loaded admissible colour
    instead of the first.  Native unless BIS_TPU_NO_NATIVE is set."""
    from . import _native
    colors = _native.greedy_color(A, balanced)
    if colors is not None:
        return colors
    n = A.n_rows
    row_ptr, col = A.row_ptr, A.col
    colors = np.full(n, -1, dtype=np.int32)
    loads = []
    for i in range(n):
        nbr = colors[col[row_ptr[i]:row_ptr[i + 1]]]
        used = set(int(c) for c in nbr if c >= 0)
        if balanced:
            best, best_load = None, None
            for c, ld in enumerate(loads):
                if c not in used and (best is None or ld < best_load):
                    best, best_load = c, ld
            c = best if best is not None else len(loads)
        else:
            c = 0
            while c in used:
                c += 1
        if c == len(loads):
            loads.append(0)
        loads[c] += 1
        colors[i] = c
    return colors


def check_coloring(A, colors: np.ndarray) -> bool:
    """True iff no off-diagonal entry couples two rows of one colour."""
    rows = A.rows()
    off = A.col != rows
    return not np.any(colors[rows[off]] == colors[A.col[off]])


def colors_to_perm(colors: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(perm, inv_perm) sorting rows by colour, stable within a colour
    (perm[new] = old)."""
    perm = np.argsort(colors, kind="stable").astype(np.int32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size, dtype=np.int32)
    return perm, inv


def spec_for_device(A) -> ColorSpec:
    """The natural zero-cost colouring of a device operator: a grid or
    parity colouring of a stencil, a mod colouring of a DIA matrix."""
    from .device_matrix import DeviceDIA
    from .stencil_op import DeviceStencil
    if isinstance(A, DeviceStencil):
        return grid_color_spec(A.legs, A.dims)
    if isinstance(A, DeviceDIA):
        return mod_color_spec(A.offsets, A.n_rows)
    raise TypeError(
        f"no structural coloring for {type(A).__name__}; use "
        "greedy_coloring on the host CSR")


def colored_sweep(A, D_inv, y: torch.Tensor, x: Optional[torch.Tensor],
                  spec: Optional[ColorSpec], n_colors: int,
                  reverse: bool = False,
                  color_arr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One exact Gauss-Seidel sweep over the colours.

    x given:  the GS iteration update x ← (L_c+D)⁻¹(y − U_c·x) in residual
              form, one colour step at a time.
    x = None: the triangular solve (L_c+D)⁻¹y (forward) or (U_c+D)⁻¹y
              (reverse) from a zero initial guess, the preconditioner
              apply: the first colour's step is y·D⁻¹ on its rows (A·0 = 0).

    Colour ids come from `color_arr` (greedy colourings) or from `spec`.
    D_inv may be the number 1.0 (the unit-diagonal L of coloured ILU(0)).
    """
    from .ops.spmv import spmv
    from .parallel import mesh_ops as mo
    from .stencil_op import DeviceStencil, stencil_gs_color_step
    if isinstance(A, (mo.MeshStencil, mo.DistStencil)) and color_arr is None:
        step = (mo.mesh_gs_color_step if isinstance(A, mo.MeshStencil)
                else mo.dist_gs_color_step)
        return _mesh_sweep(A, D_inv, y, x, spec, n_colors, reverse, step)
    step_kernel = isinstance(A, DeviceStencil) and color_arr is None
    ids = color_arr if color_arr is not None else color_ids(spec, A)
    order = range(n_colors - 1, -1, -1) if reverse else range(n_colors)
    for step, c in enumerate(order):
        if x is None and step == 0:
            x = torch.where(ids == c, y * D_inv, torch.zeros_like(y))
        elif step_kernel:
            x = stencil_gs_color_step(A, x, y, D_inv, spec, c)
        else:
            x = torch.where(ids == c, x + (y - spmv(A, x)) * D_inv, x)
    return x


def _mesh_sweep(A, D_inv, y, x, spec: ColorSpec, n_colors: int,
                reverse: bool, step) -> torch.Tensor:
    """`colored_sweep` on a mesh or GSPMD stencil (the JAX package's mesh
    branch, coloring.py:242-262): every colour step is one shard-local GS
    step (`step`) with one halo exchange; under a grid colouring with
    sx > 1 the sx colours sharing (cy, cz) go as one superstep (they
    couple only along x, inside a shard's lines), so a sweep exchanges
    once per group."""
    groups = [(c,) for c in range(n_colors)]
    if spec.kind == "grid" and spec.params[3] > 1:
        sx = spec.params[3]
        groups = [tuple(range(g * sx, (g + 1) * sx))
                  for g in range(n_colors // sx)]
    if reverse:
        groups = [tuple(reversed(g)) for g in reversed(groups)]
    if x is None:
        # the first colour from zero: A·0 = 0
        x = torch.where(color_ids(spec, A) == groups[0][0], y * D_inv,
                        torch.zeros_like(y))
        if len(groups[0]) > 1:
            x = step(A, x, y, D_inv, spec, groups[0][1:])
        groups = groups[1:]
    for g in groups:
        x = step(A, x, y, D_inv, spec, g)
    return x
