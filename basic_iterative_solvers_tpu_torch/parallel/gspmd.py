"""The GSPMD mode of `shard_setup`: a torch.distributed DeviceMesh, one
process a shard.

The JAX package's "gspmd" mode annotates shardings and lets XLA's SPMD
partitioner insert the collectives.  Its PyTorch counterpart is
torch.distributed.tensor:

* a 1-D `DeviceMesh` named "rows" over the default process group
  (`make_device_mesh`): one process a card under NCCL (torchrun), one a
  CPU rank under gloo;
* solver vectors are `DTensor`s with `Shard(0)`: rank r owns rows
  [r·R, (r+1)·R), R = n / world size.  Elementwise operations and BLAS-1
  run on them unchanged; a dot is a `Partial` sum reduced by one
  all-reduce (ops/blas1.py);
* what DTensor cannot partition, the port partitions itself.  A shifted-
  slice SpMV on a DTensor all-gathers x (the pattern parallel/census.py
  flags), so each operator's SpMV, and a stencil's GS colour step, is one
  function on the rank's own rows (parallel/mesh_ops.py `Dist*`): the halo
  exchange here (`halo_window`, point-to-point with the ⌈h/R⌉ neighbours a
  side), then the halo-form hand kernel the shard_map mode launches per
  shard, the result wrapped back as a `Shard(0)` DTensor;
* superblock and rank-space solves, level scans and the multigrid
  hierarchy run replicated, as the JAX mode places them replicated: the
  vector is gathered whole (`full_tensor()`), the whole apply runs with
  its kernels on every rank, and each rank keeps its rows
  (`whole`, called from precond.run_whole).

The kernels stay on in this mode: the JAX package turns Pallas off here
because Mosaic kernels are not auto-partitionable, a TPU limit.
"""
from __future__ import annotations

import dataclasses
import os

import torch

from ..ops.blas1 import full_value, is_dtensor
from .sharded import AXIS

#: what the halo exchanges of this process moved: one "collective-permute"
#: a direction with rows to fetch (the XLA op of one halo shift, issued by
#: every rank; none on a one-rank mesh), and the bytes this rank sent
HALO_COUNTS = {"collective-permute": 0, "bytes": 0}


def make_device_mesh(axis: str = AXIS):
    """A 1-D DeviceMesh named `axis` over the initialised default process
    group: on `cuda:{LOCAL_RANK}` (made the current card) under NCCL, on
    the CPU under any other backend.  Raises when no process group is
    initialised: it never makes a one-rank group behind the caller's
    back."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_device_mesh needs an initialised default process group: "
            "torch.distributed.init_process_group (torchrun sets its "
            "address, rank and world size)")
    from torch.distributed.device_mesh import DeviceMesh
    world = dist.get_world_size()
    if dist.get_backend() == "nccl":
        local = int(os.environ.get(
            "LOCAL_RANK", dist.get_rank() % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        kind = "cuda"
    else:
        kind = "cpu"
    return DeviceMesh(kind, list(range(world)), mesh_dim_names=(axis,))


def is_device_mesh(mesh) -> bool:
    try:
        from torch.distributed.device_mesh import DeviceMesh
    except ImportError:
        return False
    return isinstance(mesh, DeviceMesh)


@dataclasses.dataclass(frozen=True)
class RowLayout:
    """Rank `rank` of `size` owns rows [rank·rows, (rank+1)·rows) of n."""

    mesh: object
    n: int
    rows: int
    rank: int
    size: int

    @property
    def start(self) -> int:
        return self.rank * self.rows


def row_layout(mesh, n: int) -> RowLayout:
    size = mesh.size()
    if n % size:
        raise ValueError(f"vector length {n} not divisible by {size} "
                         "devices")
    return RowLayout(mesh=mesh, n=n, rows=n // size,
                     rank=mesh.get_local_rank(), size=size)


def from_rows(local: torch.Tensor, lay: RowLayout):
    """The Shard(0) DTensor whose rank-local rows are `local`."""
    from torch.distributed.tensor import DTensor, Shard
    return DTensor.from_local(local, lay.mesh, [Shard(0)], run_check=False,
                              shape=torch.Size([lay.n]), stride=(1,))


def shard_rows(v: torch.Tensor, mesh):
    """A whole vector, held by every rank, as a Shard(0) DTensor: each
    rank keeps a copy of its own rows (no communication)."""
    lay = row_layout(mesh, v.shape[0])
    return from_rows(v.narrow(0, lay.start, lay.rows).contiguous(), lay)


def rows_like(local: torch.Tensor, x):
    """`local` as the rank's rows of a DTensor sharded like x."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, x.device_mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def sum_partials(parts, mesh) -> tuple:
    """The ranks' partial results `parts` (plain tensors) summed across the
    mesh by one all-reduce: every rank's whole values, plain tensors."""
    import torch.distributed as dist
    flat = torch.cat([p.reshape(-1) for p in parts])
    dist.all_reduce(flat, group=mesh.get_group())
    out, at = [], 0
    for p in parts:
        out.append(flat[at:at + p.numel()].view(p.shape))
        at += p.numel()
    return tuple(out)


def whole(fn, *args, **kw):
    """`fn(*args, **kw)` run replicated (the JAX mode's place_rep): each
    DTensor argument gathered whole (`full_tensor()`), `fn` on every rank
    with its kernels, the result back as the rows of the first one's
    sharding.  Its callers (precond.run_whole, solvers/base.finalize_x)
    call it only where an argument is a DTensor."""
    like = next(a for a in args if is_dtensor(a))
    out = fn(*(full_value(a) for a in args), **kw)
    lay = row_layout(like.device_mesh, like.shape[0])
    return rows_like(out.narrow(0, lay.start, lay.rows).contiguous(), like)


def halo_window(lay: RowLayout, x_local: torch.Tensor, hneg: int,
                hpos: int) -> torch.Tensor:
    """The rank's window of x: the hneg rows below its own, its own, the
    hpos rows above, zeros past either end of the vector.  The halo rows
    come point-to-point from the ⌈h/R⌉ neighbours a side that own them
    (`batch_isend_irecv` on the mesh's group), received straight into the
    window; counted in HALO_COUNTS."""
    import torch.distributed as dist
    R, r, P = lay.rows, lay.rank, lay.size
    win = x_local.new_zeros(hneg + R + hpos)
    win[hneg:hneg + R] = x_local
    if P == 1 or not (hneg or hpos):
        return win
    group = lay.mesh.get_group()
    peer = lambda k: dist.get_global_rank(group, k)  # noqa: E731
    ops, sent = [], 0
    lo, hi = r * R - hneg, (r + 1) * R + hpos     # the rows the window holds
    for k in range(P):
        if k == r:
            continue
        # k's rows in my window: received
        a, b = max(k * R, lo), min((k + 1) * R, hi)
        if a < b:
            ops.append(dist.P2POp(dist.irecv, win[a - lo:b - lo], peer(k),
                                  group))
        # my rows in k's window: sent
        a = max(r * R, k * R - hneg)
        b = min((r + 1) * R, (k + 1) * R + hpos)
        if a < b:
            part = x_local[a - r * R:b - r * R]
            ops.append(dist.P2POp(dist.isend, part, peer(k), group))
            sent += part.numel() * part.element_size()
    for req in dist.batch_isend_irecv(ops) if ops else ():
        req.wait()
    HALO_COUNTS["collective-permute"] += (hneg > 0) + (hpos > 0)
    HALO_COUNTS["bytes"] += sent
    return win


def shard_setup_gspmd(setup, mesh):
    """The GSPMD mode (the JAX package's sharded.py:229-341): refusals in
    its order (a DIA, stencil or lane-ELL operator; a vector length the
    ranks divide; then a stencil whose rank rows are whole x-lines), the
    operators wrapped as DTensor operators, the length-n vectors of the
    setup and its preconditioner as Shard(0) DTensors; blocked and level
    solves and the multigrid hierarchy stay whole on every rank."""
    from ..device_matrix import DeviceDIA
    from ..ops.lane_ell import DeviceLaneELL
    from ..stencil_op import DeviceStencil
    from .mesh_ops import dist_dia, dist_lane_ell, dist_stencil

    A = setup.A
    if not isinstance(A, (DeviceStencil, DeviceDIA, DeviceLaneELL)):
        raise ValueError(
            "shard_setup supports DIA, stencil and lane-ELL matrices")
    n_dev = mesh.size()
    n = setup.b.shape[0]
    if n % n_dev:
        raise ValueError(
            f"vector length {n} not divisible by {n_dev} devices")
    if setup.b.device.type != mesh.device_type:
        raise ValueError(f"the setup lies on {setup.b.device}, the mesh on "
                         f"{mesh.device_type}")

    def place(Mt):
        if isinstance(Mt, DeviceStencil):
            return dist_stencil(Mt, mesh)
        if isinstance(Mt, DeviceLaneELL):
            return dist_lane_ell(Mt, mesh)
        if isinstance(Mt, DeviceDIA):
            return dist_dia(Mt, mesh)
        raise ValueError(f"no GSPMD operator for {type(Mt).__name__}")

    A_new = place(A)
    mat = lambda Mt: None if Mt is None else (  # noqa: E731
        A_new if Mt is A else place(Mt))
    vec = lambda v: None if v is None else shard_rows(v, mesh)  # noqa: E731
    M = setup.M
    M_sh = dataclasses.replace(
        M, A_D=vec(M.A_D), A_D_inv=vec(M.A_D_inv),
        L_strict_dev=mat(M.L_strict_dev), U_strict_dev=mat(M.U_strict_dev),
        A_full_dev=mat(M.A_full_dev), color_arr=vec(M.color_arr))
    return dataclasses.replace(
        setup, A=A_new, M=M_sh, b=vec(setup.b), x0=vec(setup.x0),
        A_D=vec(setup.A_D), color_arr=vec(setup.color_arr),
        L_strict_dev=mat(setup.L_strict_dev),
        U_strict_dev=mat(setup.U_strict_dev))
