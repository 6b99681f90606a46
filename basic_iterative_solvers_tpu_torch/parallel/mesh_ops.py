"""Mesh-wrapped device operators: the hand-written kernels per shard.

The JAX package's parallel/mesh_ops.py.  Each operator is wrapped with its
mesh, and its SpMV (and a stencil's GS colour step) runs as

    halo exchange (Mesh.ppermute)  →  the shard-local kernel, once a shard

with a stencil's fused dots summed by `Mesh.psum`.  Each shard's launch
reads only its own window (its left neighbour's last rows, its own rows,
its right neighbour's first rows, a tensor of its own), its own slice of
the matrix data and its global row offset, and writes only its own rows.

Layouts: shard k owns rows [k·R, (k+1)·R) of the vectors, R at least
the halo width (`row_block`; a setup's operators share one R,
parallel/sharded.setup_rows):
* stencil: whole z-planes (nx·ny rows) when nz ≥ n_dev, else whole
  x-lines (fdm:2048 has nz = 1); the kernels' grid then covers the
  shard's own lines, and masks and colours come from global coordinates;
  a window's halo is the operator's rounded up to whole x-lines
  (`DeviceStencil.window_halo`), so the shard's rows start on a line of
  it and the box routes read it in aligned 16-byte vectors; each shard
  holds its own copy of the coefficients and its slice of the diagonal;
* DIA: R ≥ ⌈n/n_dev⌉, each shard's data rows its own (k, R) tensor;
* lane-ELL: R a whole number of the JAX package's row tiles of 128-row
  x2-rows (ops/lane_ell.lane_ell_row_tile), the planes padded with inert
  x2-rows to n_dev·R (ops/lane_ell.lane_ell_extend_rows), each shard's
  planes and row counts its own tensors, a halo of S x2-rows (every
  slot's column lies within S x2-rows of its row's).
Every shard's data lies on its own device.  Vectors are MeshVectors
(parallel/mesh_vector.py) of n rows in that layout: the last shard holding
rows is short where R does not divide n, and the shards past n hold none;
an operator pads such a shard's window with the inert rows its layout
needs, launches on its R rows and keeps the shard's own.

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
from .mesh_vector import MeshVector
from .sharded import Mesh, _halo, _halo_exchange, _split


def _pad(v: torch.Tensor, npad: int) -> torch.Tensor:
    return (v if v.shape[0] == npad
            else torch.nn.functional.pad(v, (0, npad - v.shape[0])))


@dataclasses.dataclass
class MeshStencil:
    """A DeviceStencil bound to a 1-D row mesh (inner.shards == the mesh
    size): R_local rows a shard; `ops[k]` the stencil on shard k's device
    (its coefficients, and as diagonal its slice `diag_shards[k]`)."""

    inner: DeviceStencil
    mesh: Mesh
    axis: str
    rows: int
    ops: Tuple[DeviceStencil, ...]
    diag_shards: Optional[Tuple[torch.Tensor, ...]] = None

    dtype = property(lambda self: self.inner.dtype)
    device = property(lambda self: self.inner.device)
    n_rows = property(lambda self: self.inner.n_rows)
    n_cols = property(lambda self: self.inner.n_cols)
    n_devices = property(lambda self: self.mesh.size)
    blocks = property(lambda self: self.mesh.blocks(self.n_rows, self.rows))


@dataclasses.dataclass
class MeshDIA:
    """A DeviceDIA bound to a 1-D row mesh: R_local rows a shard, each
    shard's (k, R_local) data its own tensor on its device."""

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
    blocks = property(lambda self: self.mesh.blocks(self.n_rows, self.rows))


@dataclasses.dataclass
class MeshLaneELL:
    """A DeviceLaneELL bound to a 1-D row mesh: its planes' x2-rows padded
    to whole shards of `rows` x2-rows, each shard's (K, rows, 128) planes
    and its rows of inner.row_len its own tensors on its device (the index
    plane in 16 bits where the operator has that plane, else int32)."""

    inner: DeviceLaneELL
    mesh: Mesh
    axis: str
    rows: int
    vals_shards: Tuple[torch.Tensor, ...]
    idx_shards: Tuple[torch.Tensor, ...]
    len_shards: Tuple[torch.Tensor, ...]

    dtype = property(lambda self: self.inner.dtype)
    device = property(lambda self: self.inner.device)
    n_rows = property(lambda self: self.inner.n_rows)
    n_cols = property(lambda self: self.inner.n_cols)
    n_devices = property(lambda self: self.mesh.size)
    blocks = property(lambda self: self.mesh.blocks(self.n_rows,
                                                    self.rows * LANES))


MESH_TYPES = (MeshStencil, MeshDIA, MeshLaneELL)


def unwrap(A):
    """The single-device operator under a mesh or DTensor wrapper (A
    itself for a plain operator)."""
    if isinstance(A, MESH_TYPES + DIST_TYPES):
        return A.inner
    return A


def row_block(Mt, n_dev: int) -> Tuple[int, int]:
    """(the least rows a shard, the unit its rows come in) of an operator
    on n_dev shards."""
    if isinstance(Mt, DeviceStencil):
        nx, ny, nz = Mt.dims
        return (stencil_shard_rows(Mt.dims, Mt.halo, n_dev),
                nx * ny if nz >= n_dev else nx)
    if isinstance(Mt, DeviceDIA):
        return max(-(-Mt.n_rows // n_dev), *_halo(Mt.offsets), 1), 1
    if isinstance(Mt, DeviceLaneELL):
        tile = lane_ell_row_tile(Mt.n_rows, Mt.S)
        return -(-Mt.R // (tile * n_dev)) * tile * LANES, tile * LANES
    raise TypeError(f"no mesh layout for {type(Mt).__name__}")


def _rows_for(Mt, n_dev: int, rows: Optional[int]) -> int:
    """`rows` checked against the operator's row_block (its least count
    where None)."""
    least, unit = row_block(Mt, n_dev)
    if rows is None:
        return least
    if rows < least or rows % unit:
        raise ValueError(f"{rows} rows a shard do not serve this "
                         f"{type(Mt).__name__}: at least {least}, a "
                         f"multiple of {unit}")
    return rows


def _place(parts, mesh: Mesh) -> Tuple[torch.Tensor, ...]:
    """Each part copied out to its shard's device as its own tensor."""
    return tuple(p.to(dev, copy=True).contiguous()
                 for p, dev in zip(parts, mesh.devices))


def wrap_stencil(St: DeviceStencil, mesh: Mesh, axis: str,
                 rows: Optional[int] = None) -> MeshStencil:
    """Bind a stencil laid out for the mesh (St.shards == the mesh size),
    `rows` a shard (its least where None)."""
    n_dev = mesh.size
    if St.shards != n_dev:
        raise ValueError(f"stencil shards={St.shards} != mesh size {n_dev}")
    R = _rows_for(St, n_dev, rows)
    diag = (None if St.diag is None
            else _place(_split(_pad(St.diag, R * n_dev), n_dev), mesh))
    coeffs = {dev: St.coeffs.to(dev) for dev in set(mesh.devices)}
    ops = tuple(dataclasses.replace(
        St, coeffs=coeffs[dev], diag=None if diag is None else diag[k])
        for k, dev in enumerate(mesh.devices))
    return MeshStencil(inner=St, mesh=mesh, axis=axis, rows=R, ops=ops,
                       diag_shards=diag)


def _check_vector(A, v, what: str = "x"):
    """v's shards, checked to be a MeshVector in A's layout."""
    if not isinstance(v, MeshVector) or v.blocks != A.blocks:
        raise ValueError(
            f"a mesh operator takes {what} as a MeshVector of its layout "
            f"({A.blocks.rows} rows a shard; Mesh.scatter), not "
            f"{type(v).__name__}")
    return v.shards


def _padded(A, v, rows: int, what: str = "x"):
    """v's shards, each padded with inert rows to `rows`."""
    return [_pad(s, rows) for s in _check_vector(A, v, what)]


def _outs(A, x, rows: int):
    """An uninitialised `rows` buffer a shard, on its device."""
    return [torch.empty(rows, dtype=x.dtype, device=dev)
            for dev in A.mesh.devices]


def _own(A, ys):
    """The shards' buffers cut to their own rows, as a MeshVector."""
    blocks = A.blocks
    return MeshVector([y[:hi - lo] for y, (lo, hi) in zip(ys, blocks.bounds)],
                      blocks, check=False)


def mesh_stencil_spmv(A: MeshStencil, x, dots=(), aux=None):
    """y = A @ x, one shard-local kernel a shard after one halo exchange;
    `dots` as in stencil_spmv, each shard's partials (float64 for float32
    vectors) summed by psum and rounded once to y's dtype.  Returns y, or
    (y, *dots)."""
    dots = tuple(dots)
    R = A.rows
    windows = _halo_exchange(A.mesh, _padded(A, x, R), *A.inner.window_halo)
    auxs = (_padded(A, aux, R, "aux") if "aux" in dots
            else [None] * A.n_devices)
    diags = A.diag_shards or (None,) * A.n_devices
    ys = _outs(A, x, R)
    parts = []
    for k, yk in enumerate(ys):
        out = stencil_spmv_halo(A.ops[k], windows[k], k * R, dots, auxs[k],
                                diags[k], out=yk)
        if dots:
            parts.append(torch.stack(out[1:]))
    y = _own(A, ys)
    if not dots:
        return y
    return (y,) + tuple(A.mesh.psum(parts).to(ys[0].dtype).unbind())


def mesh_gs_color_step(A: MeshStencil, x, rhs, dinv, spec, color):
    """The shard-local multicolour GS step after one halo exchange; a
    tuple of colours is a superstep (its colours couple only along x,
    inside each shard's lines), so it needs no further exchange."""
    R = A.rows
    windows = _halo_exchange(A.mesh, _padded(A, x, R), *A.inner.window_halo)
    rhss, dinvs = _padded(A, rhs, R, "rhs"), _padded(A, dinv, R, "dinv")
    diags = A.diag_shards or (None,) * A.n_devices
    ys = _outs(A, x, R)
    for k, yk in enumerate(ys):
        stencil_gs_color_step_halo(A.ops[k], windows[k], k * R, rhss[k],
                                   dinvs[k], spec, color, diags[k], out=yk)
    return _own(A, ys)


def wrap_dia(D: DeviceDIA, mesh: Mesh, axis: str,
             rows: Optional[int] = None) -> MeshDIA:
    """Bind a DIA matrix to the mesh: rows padded to n_dev·R_local with
    inert (zero) rows, R_local ≥ the halo (`rows` where given), each
    shard's data copied out to its device."""
    n_dev = mesh.size
    R = _rows_for(D, n_dev, rows)
    data = torch.nn.functional.pad(D.data[:, :D.n_rows],
                                   (0, R * n_dev - D.n_rows))
    return MeshDIA(inner=D, mesh=mesh, axis=axis, rows=R,
                   data_shards=_place(_split(data, n_dev, 1), mesh))


def mesh_dia_spmv(A: MeshDIA, x):
    """y = A @ x: the shard-local DIA kernel on each shard's window."""
    D = A.inner
    if not D.offsets:
        return torch.zeros_like(x)
    R = A.rows
    hneg, hpos = _halo(D.offsets)
    windows = _halo_exchange(A.mesh, _padded(A, x, R), hneg, hpos)
    ys = _outs(A, x, R)
    for k, yk in enumerate(ys):
        dia_spmv_halo(A.data_shards[k], D.offsets, windows[k], hneg, out=yk)
    return _own(A, ys)


def wrap_lane_ell(M: DeviceLaneELL, mesh: Mesh, axis: str,
                  rows: Optional[int] = None) -> MeshLaneELL:
    """Pad the slot planes' x2-rows to n_dev shards of whole row tiles
    (inert rows; `rows` vector rows a shard where given) and bind them to
    the mesh, each shard's planes and row counts copied out to its
    device."""
    n_dev = mesh.size
    R = _rows_for(M, n_dev, rows) // LANES
    M = lane_ell_extend_rows(M, R * n_dev)
    return MeshLaneELL(
        inner=M, mesh=mesh, axis=axis, rows=R,
        vals_shards=_place(_split(M.vals, n_dev, 1), mesh),
        idx_shards=_place(_split(M.idx if M.idx16 is None else M.idx16,
                                 n_dev, 1), mesh),
        len_shards=_place(_split(M.row_len, n_dev), mesh))


def mesh_lane_ell_spmv(A: MeshLaneELL, x):
    """y = A @ x: the shard-local lane-ELL kernel on each shard's window of
    S x2-rows a side."""
    M = A.inner
    R = A.rows * LANES
    h = M.S * LANES
    windows = _halo_exchange(A.mesh, _padded(A, x, R), h, h)
    ys = _outs(A, x, R)
    for k, yk in enumerate(ys):
        lane_ell_spmv_halo(M, A.vals_shards[k], A.idx_shards[k], windows[k],
                           k * A.rows, M.S, out=yk, lens=A.len_shards[k])
    return _own(A, ys)


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
    """A's wrapper of the same kind, on the same mesh (a Mesh operator
    with its rows), around another single-device operator of the same
    matrix (e.g. its float64 copy)."""
    if isinstance(A, MeshStencil):
        return wrap_stencil(dataclasses.replace(inner, shards=A.n_devices),
                            A.mesh, A.axis, A.rows)
    if isinstance(A, MeshDIA):
        return wrap_dia(inner, A.mesh, A.axis, A.rows)
    if isinstance(A, MeshLaneELL):
        return wrap_lane_ell(inner, A.mesh, A.axis, A.rows * LANES)
    wrap = {DistStencil: dist_stencil, DistDIA: dist_dia,
            DistLaneELL: dist_lane_ell}.get(type(A))
    if wrap is None:
        raise TypeError(f"not a mesh or DTensor operator: "
                        f"{type(A).__name__}")
    return wrap(inner, A.layout.mesh)


def _reduce_dots(lay: RowLayout, parts, dtype) -> tuple:
    """The ranks' partial dots summed by one all-reduce and rounded once
    to `dtype`: Replicate 0-d DTensors."""
    from torch.distributed.tensor import DTensor, Replicate
    s = DTensor.from_local(
        torch.stack(sum_partials(parts, lay.mesh)).to(dtype), lay.mesh,
        [Replicate()], run_check=False)
    return tuple(s[i] for i in range(len(parts)))


def dist_stencil_spmv(A: DistStencil, x, dots=(), aux=None):
    """y = A @ x on the rank's rows: the halo exchange, then the
    shard-local #1 on the window; `dots` as in stencil_spmv, the ranks'
    partials (float64 for float32 vectors) summed by one all-reduce and
    rounded once.  Returns y, or (y, *dots)."""
    dots = tuple(dots)
    St, lay = A.inner, A.layout
    xw = halo_window(lay, x.to_local().contiguous(), *St.window_halo)
    aux_l = aux.to_local().contiguous() if "aux" in dots else None
    out = stencil_spmv_halo(St, xw, lay.start, dots, aux_l, A.diag_local)
    if not dots:
        return rows_like(out, x)
    return (rows_like(out[0], x),) + _reduce_dots(lay, list(out[1:]),
                                                  out[0].dtype)


def dist_gs_color_step(A: DistStencil, x, rhs, dinv, spec, color):
    """The shard-local multicolour GS step (#3's halo form) after one halo
    exchange; a tuple of colours is a superstep, as on the mesh."""
    St, lay = A.inner, A.layout
    xw = halo_window(lay, x.to_local().contiguous(), *St.window_halo)
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
