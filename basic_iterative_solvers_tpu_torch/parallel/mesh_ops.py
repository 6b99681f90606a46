"""Mesh-wrapped device operators: the hand-written kernels per shard.

The JAX package's parallel/mesh_ops.py.  Each operator is wrapped with its
mesh, and its SpMV (and a stencil's GS colour step) runs as

    halo exchange (Mesh.ppermute)  →  the shard-local kernel, once a shard

with a stencil's fused dots summed by `Mesh.psum`.  Each shard's launch
reads only its own window (its left neighbour's last rows, its own rows,
its right neighbour's first rows, a tensor of its own), its own slice of
the matrix data and its global row offset, and writes only its own rows.

Layouts: shard k owns rows [k·R_local, (k+1)·R_local) of the row count
padded to n_dev·R_local with inert rows, R_local at least the halo width:
* stencil: whole z-planes (nx·ny rows) when nz ≥ n_dev, else whole
  x-lines (fdm:2048 has nz = 1); the kernels' (line, x) grid then covers
  the shard's own lines, and masks and colours come from global
  coordinates;
* DIA: R_local = max(⌈n/n_dev⌉, hneg, hpos), each shard's data rows copied
  out as its own (k, R_local) tensor;
* lane-ELL: the slot planes' x2-rows padded to a multiple of the JAX
  package's row tile times n_dev (ops/lane_ell.lane_ell_extend_rows), each
  shard's planes its own tensors, a halo of S x2-rows (every slot's column
  lies within S x2-rows of its row's).
Solver vectors stay n rows long: each SpMV pads x to the padded count
(no copy where n already fills it, as at 128^3 on 8 shards) and returns
the first n rows of y.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..device_matrix import DeviceDIA
from ..ops.dia_spmv import dia_spmv_halo
from ..ops.lane_ell import (LANES, DeviceLaneELL, lane_ell_extend_rows,
                            lane_ell_row_tile, lane_ell_spmv_halo)
from ..stencil_op import (DeviceStencil, stencil_gs_color_step_halo,
                          stencil_shard_rows, stencil_spmv_halo)
from .sharded import Mesh, _halo, _halo_exchange, _split


def _pad(v: torch.Tensor, npad: int) -> torch.Tensor:
    return (v if v.shape[0] == npad
            else torch.nn.functional.pad(v, (0, npad - v.shape[0])))


@dataclasses.dataclass
class MeshStencil:
    """A DeviceStencil bound to a 1-D row mesh (inner.shards == the mesh
    size): R_local rows a shard, the diagonal cut into the shards' slices."""

    inner: DeviceStencil
    mesh: Mesh
    axis: str
    rows: int
    diag_shards: Optional[Tuple[torch.Tensor, ...]] = None

    dtype = property(lambda self: self.inner.dtype)
    device = property(lambda self: self.inner.device)
    n_rows = property(lambda self: self.inner.n_rows)
    n_cols = property(lambda self: self.inner.n_cols)
    n_devices = property(lambda self: self.mesh.size)


@dataclasses.dataclass
class MeshDIA:
    """A DeviceDIA bound to a 1-D row mesh: R_local rows a shard, each
    shard's (k, R_local) data its own tensor."""

    inner: DeviceDIA
    mesh: Mesh
    axis: str
    rows: int
    data_shards: Tuple[torch.Tensor, ...]

    dtype = property(lambda self: self.inner.dtype)
    device = property(lambda self: self.inner.device)
    n_rows = property(lambda self: self.inner.n_rows)
    n_cols = property(lambda self: self.inner.n_cols)
    n_devices = property(lambda self: self.mesh.size)


@dataclasses.dataclass
class MeshLaneELL:
    """A DeviceLaneELL bound to a 1-D row mesh: its planes' x2-rows padded
    to whole shards of `rows` x2-rows, each shard's (K, rows, 128) planes
    its own tensors (the index plane in 16 bits where the operator has
    that plane, else int32; each shard reads its rows of inner.row_len)."""

    inner: DeviceLaneELL
    mesh: Mesh
    axis: str
    rows: int
    vals_shards: Tuple[torch.Tensor, ...]
    idx_shards: Tuple[torch.Tensor, ...]

    dtype = property(lambda self: self.inner.dtype)
    device = property(lambda self: self.inner.device)
    n_rows = property(lambda self: self.inner.n_rows)
    n_cols = property(lambda self: self.inner.n_cols)
    n_devices = property(lambda self: self.mesh.size)


def unwrap(A):
    """The single-device operator under a mesh wrapper (A itself for a
    plain operator)."""
    if isinstance(A, (MeshStencil, MeshDIA, MeshLaneELL)):
        return A.inner
    return A


def wrap_stencil(St: DeviceStencil, mesh: Mesh, axis: str) -> MeshStencil:
    """Bind a stencil laid out for the mesh (St.shards == the mesh size)."""
    n_dev = mesh.size
    if St.shards != n_dev:
        raise ValueError(f"stencil shards={St.shards} != mesh size {n_dev}")
    R = stencil_shard_rows(St.dims, St.halo, n_dev)
    diag = (None if St.diag is None
            else tuple(_split(_pad(St.diag, R * n_dev), n_dev)))
    return MeshStencil(inner=St, mesh=mesh, axis=axis, rows=R,
                       diag_shards=diag)


def _shards(A, v: Optional[torch.Tensor], npad: int):
    return ([None] * A.n_devices if v is None
            else _split(_pad(v, npad), A.n_devices))


def mesh_stencil_spmv(A: MeshStencil, x: torch.Tensor, dots=(),
                      aux: Optional[torch.Tensor] = None):
    """y = A @ x, one shard-local kernel a shard after one halo exchange;
    `dots` as in stencil_spmv, each shard's partials summed by psum.
    Returns y, or (y, *dots)."""
    dots = tuple(dots)
    St = A.inner
    n_dev, R = A.n_devices, A.rows
    npad = n_dev * R
    windows = _halo_exchange(A.mesh, _shards(A, x, npad), *St.halo)
    auxs = _shards(A, aux if "aux" in dots else None, npad)
    diags = A.diag_shards or (None,) * n_dev
    y = torch.empty(npad, dtype=x.dtype, device=x.device)
    parts = []
    for k, yk in enumerate(_split(y, n_dev)):
        out = stencil_spmv_halo(St, windows[k], k * R, dots, auxs[k],
                                diags[k], out=yk)
        if dots:
            parts.append(torch.stack(out[1:]))
    y = y[:St.n_rows]
    if not dots:
        return y
    return (y,) + tuple(A.mesh.psum(parts).unbind())


def mesh_gs_color_step(A: MeshStencil, x: torch.Tensor, rhs: torch.Tensor,
                       dinv: torch.Tensor, spec, color) -> torch.Tensor:
    """The shard-local multicolour GS step after one halo exchange; a
    tuple of colours is a superstep (its colours couple only along x,
    inside each shard's lines), so it needs no further exchange."""
    St = A.inner
    n_dev, R = A.n_devices, A.rows
    npad = n_dev * R
    windows = _halo_exchange(A.mesh, _shards(A, x, npad), *St.halo)
    rhss, dinvs = _shards(A, rhs, npad), _shards(A, dinv, npad)
    diags = A.diag_shards or (None,) * n_dev
    y = torch.empty(npad, dtype=x.dtype, device=x.device)
    for k, yk in enumerate(_split(y, n_dev)):
        stencil_gs_color_step_halo(St, windows[k], k * R, rhss[k], dinvs[k],
                                   spec, color, diags[k], out=yk)
    return y[:St.n_rows]


def wrap_dia(D: DeviceDIA, mesh: Mesh, axis: str) -> MeshDIA:
    """Bind a DIA matrix to the mesh: rows padded to n_dev·R_local with
    inert (zero) rows, R_local ≥ the halo, each shard's data copied out."""
    n_dev = mesh.size
    R = max(-(-D.n_rows // n_dev), *_halo(D.offsets), 1)
    data = torch.nn.functional.pad(D.data, (0, R * n_dev - D.n_rows))
    return MeshDIA(inner=D, mesh=mesh, axis=axis, rows=R,
                   data_shards=tuple(d.contiguous()
                                     for d in _split(data, n_dev, 1)))


def mesh_dia_spmv(A: MeshDIA, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x: the shard-local DIA kernel on each shard's window."""
    D = A.inner
    if not D.offsets:
        return torch.zeros_like(x)
    n_dev, R = A.n_devices, A.rows
    hneg, hpos = _halo(D.offsets)
    windows = _halo_exchange(A.mesh, _shards(A, x, n_dev * R), hneg, hpos)
    y = torch.empty(n_dev * R, dtype=x.dtype, device=x.device)
    for k, yk in enumerate(_split(y, n_dev)):
        dia_spmv_halo(A.data_shards[k], D.offsets, windows[k], hneg, out=yk)
    return y[:D.n_rows]


def wrap_lane_ell(M: DeviceLaneELL, mesh: Mesh, axis: str) -> MeshLaneELL:
    """Pad the slot planes' x2-rows to the JAX package's row tile times
    n_dev (inert rows) and bind them to the mesh, each shard's planes
    copied out."""
    n_dev = mesh.size
    chunk = lane_ell_row_tile(M.n_rows, M.S) * n_dev
    M = lane_ell_extend_rows(M, -(-M.R // chunk) * chunk)
    R = M.R // n_dev
    return MeshLaneELL(
        inner=M, mesh=mesh, axis=axis, rows=R,
        vals_shards=tuple(v.contiguous() for v in _split(M.vals, n_dev, 1)),
        idx_shards=tuple(i.contiguous() for i in _split(
            M.idx if M.idx16 is None else M.idx16, n_dev, 1)))


def mesh_lane_ell_spmv(A: MeshLaneELL, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x: the shard-local lane-ELL kernel on each shard's window of
    S x2-rows a side."""
    M = A.inner
    n_dev, R = A.n_devices, A.rows
    npad = M.R * LANES
    h = M.S * LANES
    windows = _halo_exchange(A.mesh, _shards(A, x, npad), h, h)
    y = torch.empty(npad, dtype=x.dtype, device=x.device)
    for k, yk in enumerate(_split(y, n_dev)):
        lane_ell_spmv_halo(M, A.vals_shards[k], A.idx_shards[k], windows[k],
                           k * R, M.S, out=yk)
    return y[:M.n_rows]
