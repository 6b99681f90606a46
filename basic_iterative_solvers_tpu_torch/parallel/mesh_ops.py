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

The GSPMD mode's operators (`DistStencil`, `DistDIA`, `DistLaneELL`,
parallel/gspmd.py) run the same halo-form kernels once a process on a
torch.distributed DeviceMesh: x is a Shard(0) DTensor of n / world rows a
rank, the rank's window comes from `gspmd.halo_window` (point-to-point
with the neighbours that own its halo rows), each rank holds its slice of
the DIA data, of the lane-ELL planes and of a stencil's diagonal (a
stencil's coefficients whole), and y goes back as a Shard(0) DTensor; a
stencil's fused dots come back as one all-reduce of the stacked partials.
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
from .gspmd import (RowLayout, halo_window, row_layout, rows_like,
                    sum_partials)
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
    """The single-device operator under a mesh or DTensor wrapper (A
    itself for a plain operator)."""
    if isinstance(A, (MeshStencil, MeshDIA, MeshLaneELL, DistStencil,
                      DistDIA, DistLaneELL)):
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


# ---------------------------------------------------------------------------
# The GSPMD mode: DTensor operators on a torch.distributed DeviceMesh
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DistStencil:
    """A DeviceStencil on a DeviceMesh: the rank's rows are whole x-lines
    from a line start, its slice of the diagonal its own tensor."""

    inner: DeviceStencil
    layout: RowLayout
    diag_local: Optional[torch.Tensor] = None

    dtype = property(lambda self: self.inner.dtype)
    device = property(lambda self: self.inner.device)
    n_rows = property(lambda self: self.inner.n_rows)
    n_cols = property(lambda self: self.inner.n_cols)


@dataclasses.dataclass
class DistDIA:
    """A DeviceDIA on a DeviceMesh: the rank's (k, R) columns of the data
    its own tensor."""

    inner: DeviceDIA
    layout: RowLayout
    data_local: torch.Tensor

    dtype = property(lambda self: self.inner.dtype)
    device = property(lambda self: self.inner.device)
    n_rows = property(lambda self: self.inner.n_rows)
    n_cols = property(lambda self: self.inner.n_cols)


@dataclasses.dataclass
class DistLaneELL:
    """A DeviceLaneELL on a DeviceMesh.  Where every rank's rows are whole
    x2-rows (n / world a multiple of 128), the rank's (K, rows, 128)
    planes are its own tensors and x comes by halo exchange of S x2-rows a
    side; else (`gather`) x is gathered whole, as the JAX package's GSPMD
    mode gathers it for its flat-gather SpMV, and every rank runs the
    whole kernel and keeps its rows."""

    inner: DeviceLaneELL
    layout: RowLayout
    vals_local: Optional[torch.Tensor] = None
    idx_local: Optional[torch.Tensor] = None

    dtype = property(lambda self: self.inner.dtype)
    device = property(lambda self: self.inner.device)
    n_rows = property(lambda self: self.inner.n_rows)
    n_cols = property(lambda self: self.inner.n_cols)

    @property
    def gather(self) -> bool:
        return self.vals_local is None


DIST_TYPES = (DistStencil, DistDIA, DistLaneELL)


def _local(lay: RowLayout, v: torch.Tensor, dim: int = 0) -> torch.Tensor:
    return v.narrow(dim, lay.start, lay.rows).contiguous()


def dist_stencil(St: DeviceStencil, mesh) -> DistStencil:
    """Bind a stencil to the DeviceMesh; raises where a rank's rows are not
    whole x-lines (the halo kernels' windows start at a line start)."""
    lay = row_layout(mesh, St.n_rows)
    nx = St.dims[0]
    if lay.rows % nx:
        raise ValueError(f"stencil rows per rank {lay.rows} are not whole "
                         f"x-lines of {nx}")
    diag = None if St.diag is None else _local(lay, St.diag)
    return DistStencil(inner=St, layout=lay, diag_local=diag)


def dist_dia(D: DeviceDIA, mesh) -> DistDIA:
    """Bind a DIA matrix to the DeviceMesh: the rank's data columns."""
    lay = row_layout(mesh, D.n_rows)
    return DistDIA(inner=D, layout=lay,
                   data_local=_local(lay, D.data[:, :D.n_rows], 1))


def dist_lane_ell(M: DeviceLaneELL, mesh) -> DistLaneELL:
    """Bind a lane-ELL matrix to the DeviceMesh: the rank's x2-rows of the
    planes where its rows are whole x2-rows, else the gather form."""
    lay = row_layout(mesh, M.n_rows)
    if lay.rows % LANES:
        return DistLaneELL(inner=M, layout=lay)
    rx, r0 = lay.rows // LANES, lay.start // LANES
    idx = M.idx if M.idx16 is None else M.idx16
    return DistLaneELL(
        inner=M, layout=lay, vals_local=M.vals[:, r0:r0 + rx].contiguous(),
        idx_local=idx[:, r0:r0 + rx].contiguous())


def rewrap(A, inner):
    """A's wrapper of the same kind around another single-device operator
    of the same matrix (e.g. its float64 copy)."""
    wrap = {DistStencil: dist_stencil, DistDIA: dist_dia,
            DistLaneELL: dist_lane_ell}.get(type(A))
    if wrap is None:
        raise TypeError(f"not a DTensor operator: {type(A).__name__}")
    return wrap(inner, A.layout.mesh)


def _reduce_dots(lay: RowLayout, parts) -> tuple:
    """The ranks' partial dots summed by one all-reduce: Replicate 0-d
    DTensors."""
    from torch.distributed.tensor import DTensor, Replicate
    s = DTensor.from_local(torch.stack(sum_partials(parts, lay.mesh)),
                           lay.mesh, [Replicate()], run_check=False)
    return tuple(s[i] for i in range(len(parts)))


def dist_stencil_spmv(A: DistStencil, x, dots=(), aux=None):
    """y = A @ x on the rank's rows: the halo exchange, then the
    shard-local #1 on the window; `dots` as in stencil_spmv, the ranks'
    partials summed by one all-reduce.  Returns y, or (y, *dots)."""
    dots = tuple(dots)
    St, lay = A.inner, A.layout
    xw = halo_window(lay, x.to_local().contiguous(), *St.halo)
    aux_l = aux.to_local().contiguous() if "aux" in dots else None
    out = stencil_spmv_halo(St, xw, lay.start, dots, aux_l, A.diag_local)
    if not dots:
        return rows_like(out, x)
    return (rows_like(out[0], x),) + _reduce_dots(lay, list(out[1:]))


def dist_gs_color_step(A: DistStencil, x, rhs, dinv, spec, color):
    """The shard-local multicolour GS step (#3's halo form) after one halo
    exchange; a tuple of colours is a superstep, as on the mesh."""
    St, lay = A.inner, A.layout
    xw = halo_window(lay, x.to_local().contiguous(), *St.halo)
    y = stencil_gs_color_step_halo(
        St, xw, lay.start, rhs.to_local().contiguous(),
        dinv.to_local().contiguous(), spec, color, A.diag_local)
    return rows_like(y, x)


def dist_dia_spmv(A: DistDIA, x):
    """y = A @ x: the shard-local DIA kernel (#4's halo form) on the
    rank's window."""
    D = A.inner
    if not D.offsets:
        return torch.zeros_like(x)
    hneg, hpos = _halo(D.offsets)
    xw = halo_window(A.layout, x.to_local().contiguous(), hneg, hpos)
    return rows_like(dia_spmv_halo(A.data_local, D.offsets, xw, hneg), x)


def dist_lane_ell_spmv(A: DistLaneELL, x):
    """y = A @ x: the shard-local lane-ELL kernel (#5's halo form) on the
    rank's window of S x2-rows a side; in the gather form the whole
    kernel (#5) on x gathered whole, the rank keeping its rows."""
    M, lay = A.inner, A.layout
    if A.gather:
        from ..ops.lane_ell import lane_ell_spmv
        y = lane_ell_spmv(M, x.full_tensor())
        return rows_like(y[lay.start:lay.start + lay.rows].contiguous(), x)
    h = M.S * LANES
    xw = halo_window(lay, x.to_local().contiguous(), h, h)
    return rows_like(lane_ell_spmv_halo(M, A.vals_local, A.idx_local, xw,
                                        lay.start // LANES, M.S), x)
