"""Carry operators and vectors across from the JAX package.

The JAX package's `DeviceStencil` exposes `legs`, `coeff_values`, `dims`
and `diag`; with those fields (and its vectors) as numpy arrays, these
functions build the port's counterparts, so both packages compute on
identical inputs.  The JAX package stores a diagonal or vector either flat
(n,), possibly zero-padded to a tile multiple, or in its planar halo layout
(rows_pad, L); the planar layout is decoded here with the JAX package's
geometry rule (basic_iterative_solvers_tpu/stencil_op.py:152-185),
reimplemented in numpy.  A bfloat16 array (the JAX package's matrix data
under matrix_dtype="bfloat16", numpy's ml_dtypes.bfloat16) comes across
exactly: its bits are reinterpreted, or it is widened to float64 and
rounded back.

`ilu0_pair_from_numpy` carries the JAX package's exact ILU(0) factors
across: the translation tables of its `_ilu0_translation_tables` become
the port's factor-table superblock pair.  The host-CSR path's objects come
across the same way, from their fields as numpy arrays: `csr_from_numpy`,
`dia_from_numpy` (the TPU row-tile padding cropped), `lane_ell_from_numpy`,
`trisolve_levels_from_numpy`, `blocked_trisolve_from_numpy` and
`superblock_from_numpy` (a superblock pair built from host CSR).
`mg_levels_from_numpy` carries a multigrid hierarchy across, so that a
V-cycle is compared on the same operators, and `carry_cheby_lmax` a
Chebyshev preconditioner's λmax, so that float32 histories are compared
with the same interval.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import torch_dtype
from .stencil_op import DeviceStencil, make_stencil, resolve_device

#: the JAX package's planar row tile (stencil_op._ROW_TILE_2D)
_PLANAR_ROW_TILE = 1024


def _planar_geometry(legs, dims):
    """(L, rows_plane, rows_pad) of the single-device planar layout."""
    nx, ny, nz = dims
    L = max(128, -(-nx // 128) * 128)
    rows_plane = ny + 2
    rows_total = (nz + 2) * rows_plane
    drmax = max([rows_plane + 1]
                + [abs(dz) * rows_plane + abs(dy) for (dx, dy, dz) in legs])
    TR = max(_PLANAR_ROW_TILE,
             -(-2 * drmax // _PLANAR_ROW_TILE) * _PLANAR_ROW_TILE)
    rows_pad = -(-rows_total // TR) * TR
    return L, rows_plane, rows_pad


def _widened(v) -> np.ndarray:
    """v as a numpy array, bfloat16 widened to float64 (exact)."""
    v = np.asarray(v)
    return v.astype(np.float64) if v.dtype.name == "bfloat16" else v


def _flat(v, legs, dims) -> np.ndarray:
    """Flat (n,) numpy copy of a flat, tile-padded flat or planar vector."""
    v = _widened(v)
    nx, ny, nz = dims
    n = nx * ny * nz
    if v.ndim == 2:
        L, rows_plane, rows_pad = _planar_geometry(legs, dims)
        if v.shape != (rows_pad, L):
            raise ValueError(f"planar vector has shape {v.shape}, expected "
                             f"{(rows_pad, L)}")
        y3 = v[:(nz + 2) * rows_plane].reshape(nz + 2, rows_plane, L)
        return y3[1:nz + 1, 1:ny + 1, :nx].reshape(n)
    if v.ndim != 1 or v.shape[0] < n:
        raise ValueError(f"flat vector has shape {v.shape}, grid has {n} rows")
    return v[:n]


def stencil_from_numpy(legs, coeff_values, dims, diag=None, *, dtype,
                       device) -> DeviceStencil:
    """The port's operator from a JAX DeviceStencil's fields."""
    legs = tuple(tuple(int(d) for d in leg) for leg in legs)
    d = None if diag is None else _flat(diag, legs, dims)
    return make_stencil(zip(legs, coeff_values), *dims, dtype=dtype,
                        diag=d, device=device)


def vector_from_numpy(v, A: DeviceStencil, dtype=None) -> torch.Tensor:
    """A JAX-package vector (flat or planar) as a flat tensor on A's device,
    in `dtype` (default: A's)."""
    return torch.as_tensor(_flat(v, A.legs, A.dims).copy(),
                           dtype=dtype or A.dtype, device=A.device)


def ilu0_pair_from_numpy(op: DeviceStencil, tables, *, dtype):
    """The port's (L, U) ILU(0) pair for `op` from the JAX package's
    translation tables (T, Tdiag, (Px, Py, Pz), R, h), NumPy float64, as
    its ops/block_trisolve._ilu0_translation_tables returns them."""
    from .coloring import spec_for_device
    from .ops.block_trisolve import ilu0_pair_from_tables
    T, Tdiag, proto, R, h = tables
    proto = tuple(int(p) for p in proto)
    T = np.asarray(T, dtype=np.float64)
    Tdiag = np.asarray(Tdiag, dtype=np.float64)
    w = 2 * int(h) + 1
    if (T.shape != (w ** 3,) + proto[::-1]
            or Tdiag.shape != proto[::-1]):
        raise ValueError(f"tables of shape {T.shape} and {Tdiag.shape} do "
                         f"not match the prototype {proto} and reach {h}")
    return ilu0_pair_from_tables(op, spec_for_device(op),
                                 (T, Tdiag, proto, int(R), int(h)),
                                 dtype=dtype)


def _tensor(a, dtype, device) -> torch.Tensor:
    a = np.array(a)
    t = (torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
         if a.dtype.name == "bfloat16" else torch.from_numpy(a))
    return t.to(dtype=torch_dtype(dtype), device=resolve_device(device))


def csr_from_numpy(n_rows, n_cols, row_ptr, col, val):
    """The port's MatrixCSR from a JAX MatrixCSR's fields."""
    from .matrix import MatrixCSR
    val = np.asarray(val, dtype=np.float64).copy()
    return MatrixCSR(int(n_rows), int(n_cols), int(val.size),
                     np.asarray(row_ptr, dtype=np.int64).copy(),
                     np.asarray(col, dtype=np.int32).copy(), val)


def dia_from_numpy(data, offsets, n_rows, n_cols, *, dtype, device):
    """The port's DeviceDIA from a JAX DeviceDIA's fields: the data rows of
    the stored offsets, cropped to n_rows columns (the JAX package pads
    them to its Pallas row tile)."""
    from .device_matrix import DeviceDIA
    offsets = tuple(int(o) for o in offsets)
    data = np.asarray(data)[:len(offsets), :int(n_rows)]
    return DeviceDIA(data=_tensor(data, dtype, device), offsets=offsets,
                     n_rows=int(n_rows), n_cols=int(n_cols))


def lane_ell_from_numpy(vals, idx, n_rows, K, S, R, *, dtype, device):
    """The port's DeviceLaneELL from a JAX DeviceLaneELL's fields."""
    from .ops.lane_ell import DeviceLaneELL
    return DeviceLaneELL(
        vals=_tensor(vals, dtype, device),
        idx=_tensor(np.asarray(idx, dtype=np.int32), torch.int32, device),
        n_rows=int(n_rows), n_cols=int(n_rows), K=int(K), S=int(S),
        R=int(R))


def trisolve_levels_from_numpy(rows, cols, vals, dinv, n_rows, *, dtype,
                               device):
    """The port's TriSolveLevels from a JAX TriSolveLevels' fields."""
    from .ops.trisolve import TriSolveLevels
    rows = np.asarray(rows)
    return TriSolveLevels(
        rows=_tensor(rows, torch.int64, device),
        cols=_tensor(cols, torch.int64, device),
        vals=_tensor(vals, dtype, device), dinv=_tensor(dinv, dtype, device),
        n_rows=int(n_rows), n_levels=int(rows.shape[0]),
        max_width=int(rows.shape[1]))


def blocked_trisolve_from_numpy(vals, dinv, d, n_rows, n_colors, m, R_b,
                                levels, spec_kind, spec_params, *, dtype,
                                device):
    """The port's BlockedTriSolve from a JAX BlockedTriSolve's fields: its
    tuples of (R_b, 128) planes and blocks stacked into (G, M) and (C, M)
    tensors."""
    from .ops.block_trisolve import BlockedTriSolve
    stack = lambda blocks: _tensor(  # noqa: E731
        np.stack([np.asarray(b).reshape(-1) for b in blocks]), dtype, device)
    levels = tuple((int(c), tuple((int(s), int(dl), int(g))
                                  for s, dl, g in groups))
                   for c, groups in levels)
    return BlockedTriSolve(
        vals=(stack(vals) if len(vals) else
              _tensor(np.zeros((0, int(R_b) * 128)), dtype, device)),
        dinv=stack(dinv), d=None if d is None else stack(d),
        n_rows=int(n_rows), n_colors=int(n_colors), m=int(m), R_b=int(R_b),
        levels=levels, spec_kind=spec_kind,
        spec_params=tuple(int(p) for p in spec_params))


def superblock_from_numpy(vals_cross, vals_self, dinv, d, n_rows, S, m, sx,
                          levels, upper, spec_params, fused=True,
                          const_cross=None, const_self=None, *, dtype,
                          device):
    """The port's SuperBlockTriSolve from a JAX SuperBlockTriSolve built
    from host CSR (plane mode, or const mode with its diagonal per row):
    each level's (G, R_b, 128) planes cropped to the m real slots, (G, m),
    and the per-superblock dinv and d blocks (S of R_b·128 slots) turned
    into per-row (n,) vectors.  An L whose diagonal is 1 on every row is
    the L of an ILU(0) pair and is marked `unit`."""
    from .coloring import _grid_coords
    from .ops.block_trisolve import SuperBlockTriSolve, _reach_of
    nx, ny, nz, sx_, sy, sz = (int(p) for p in spec_params)
    n, m = int(n_rows), int(m)
    X, Y, Z = _grid_coords(np.arange(n, dtype=np.int64), nx, ny)
    SB = (Y % sy) + sy * (Z % sz)
    SLOT = X + nx * ((Y // sy) + (ny // sy) * (Z // sz))

    def rows_of(blocks):
        return np.stack([np.asarray(b).reshape(-1) for b in blocks])[SB, SLOT]

    def planes(v):
        if v is None:
            return None
        v = np.asarray(v)
        return _tensor(v.reshape(v.shape[0], -1)[:, :m], dtype, device)

    levels = tuple((int(sb), tuple((int(s), int(dl)) for s, dl in cross),
                    tuple(int(dx) for dx in selfs))
                   for sb, cross, selfs in levels)
    const = const_cross is not None
    if const:
        const_cross = tuple(tuple((float(c), int(a), int(b), int(e))
                                  for c, a, b, e in lv) for lv in const_cross)
        const_self = tuple(tuple((float(c), int(dx)) for c, dx in lv)
                           for lv in const_self)
    dinv_rows = rows_of(dinv)
    return SuperBlockTriSolve(
        n_rows=n, S=int(S), m=m, sx=int(sx), levels=levels, upper=bool(upper),
        spec_params=(nx, ny, nz, sx_, sy, sz), dtype=torch_dtype(dtype),
        reach=_reach_of(levels, const_cross if const else None),
        const_cross=const_cross if const else (),
        const_self=const_self if const else (), fused=bool(fused),
        vals_cross=None if const else tuple(planes(v) for v in vals_cross),
        vals_self=None if const else tuple(planes(v) for v in vals_self),
        dinv_rows=_tensor(dinv_rows, dtype, device),
        d_rows=None if d is None else _tensor(rows_of(d), dtype, device),
        unit=not upper and bool(np.all(dinv_rows == 1)))



def mg_levels_from_numpy(levels, *, dtype, device):
    """The port's multigrid level tuple from the JAX package's: each level
    as (legs, coeff_values, dims, D_inv, lmax), D_inv flat or planar and
    lmax a scalar, as numpy arrays of the JAX MGLevel's fields."""
    from .mg import MGLevel
    out = []
    for legs, coeff_values, dims, D_inv, lmax in levels:
        dims = tuple(int(d) for d in dims)
        A = stencil_from_numpy(legs, coeff_values, dims, dtype=dtype,
                               device=device)
        out.append(MGLevel(
            A=A, D_inv=vector_from_numpy(D_inv, A, dtype=torch_dtype(dtype)),
            lmax=torch.tensor(float(np.asarray(lmax)),
                              dtype=torch_dtype(dtype), device=A.device)))
    return tuple(out)


def carry_cheby_lmax(M, lmax) -> None:
    """Give a Chebyshev preconditioner the JAX package's λmax (a scalar),
    in M's vector dtype, dropping any schedule computed from its own."""
    M.cheby_lmax = torch.tensor(float(np.asarray(lmax)),
                                dtype=M.A_D_inv.dtype,
                                device=M.A_D_inv.device)
    M._cheby_schedules.clear()
