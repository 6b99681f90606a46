"""Multi-device scale-out: row-partitioned solves over a 1-D device mesh.

The JAX package's parallel/sharded.py in PyTorch.  The reference's only
parallelism is a row-parallel loop; the mesh shards the same axis:

* matrix rows (DIA data, lane-ELL slot planes, a stencil's diagonal) are
  cut into contiguous row blocks, one per shard;
* SpMV's off-shard x entries come by a halo exchange: each shard receives
  the boundary rows of the neighbours that own its halo, then runs the
  same kernel on its window (its own rows and the halo rows);
* dots are per-shard partials summed across the shards.

Two modes, as in the JAX package's `shard_setup`:

* "shard_map" on the single-controller `Mesh`: one process drives every
  shard, as the JAX package's Mesh over jax.devices() does.  `make_mesh()`
  spans every CUDA card; `make_mesh(n, device=...)` binds n shards to one
  device, the counterpart of XLA's virtual host devices.  Every solver
  vector is a `MeshVector` (parallel/mesh_vector.py): shard k's rows on
  mesh.devices[k], on every Mesh, one card or several.  Elementwise
  operations run shard by shard, dots are shard partials summed by
  `Mesh.psum`, the SpMVs and GS steps run per shard on the shard's window
  (its rows and the halo slabs `Mesh.ppermute` copies from its
  neighbours, parallel/mesh_ops.py), and a superblock preconditioner's L
  and U solves are cut into the shards too
  (ops/block_trisolve.shard_superblock).  All the operators of a setup
  share one row block (`setup_rows`), so its vectors share one layout.
  `Mesh.gather` and `Mesh.scatter`, counted, are the only ways between a
  MeshVector and one tensor on one device: the GS methods' own superblock
  solves run whole through them, as the JAX package runs them replicated.
* "gspmd" on a torch.distributed `DeviceMesh` (`make_device_mesh`), one
  process a shard: solver vectors are DTensors sharded by rows, and the
  operators run their halo-form kernels per rank after a point-to-point
  halo exchange (parallel/gspmd.py).  The JAX package falls back to this
  mode on its one mesh; here it needs the DeviceMesh, so on a `Mesh`
  "gspmd", and "auto" where shard_map refuses, raise naming the refusal.

`make_sharded_cg` is the standalone distributed CG of the JAX package
(DIA, Jacobi or the symmetric two-stage preconditioner), plain torch per
shard, as it is plain jnp there, on MeshVectors of the padded rows.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from .mesh_vector import MeshVector, RowBlocks

AXIS = "rows"

#: the JAX package's minimum DIA row tile (ops/pallas_spmv.MIN_ROW_TILE);
#: with its halo rule it sets the padded row count shard_dia cuts, and so
#: shard_dia's refusals
_MIN_ROW_TILE = 8192


def _halo(offsets) -> Tuple[int, int]:
    """(hneg, hpos): the largest negative and positive offset."""
    if not offsets:
        return 0, 0
    return max(0, -min(offsets)), max(0, max(offsets))


class Mesh:
    """A 1-D row mesh: one torch device per shard, with the collectives
    the mesh operators use and a count of what they move."""

    def __init__(self, devices: Sequence, axis: str = AXIS):
        devices = tuple(torch.device(d) for d in devices)
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.devices = devices
        self.axis = axis
        self.reset_counts()

    @property
    def size(self) -> int:
        return len(self.devices)

    def reset_counts(self) -> None:
        """Zero `counts`: the calls of each collective and the bytes they
        move (ppermute: the slabs sent; psum: the partials summed;
        gather: the shards copied to the first device; scatter: the rows
        copied out to the shards)."""
        self.counts = {"ppermute": 0, "ppermute_bytes": 0, "psum": 0,
                       "psum_bytes": 0, "gather": 0, "gather_bytes": 0,
                       "scatter": 0, "scatter_bytes": 0}

    def ppermute(self, slabs: Sequence[torch.Tensor],
                 shift: int) -> List[torch.Tensor]:
        """Shard k receives a copy of slabs[k − shift] on its device, and
        zeros where k − shift is off the mesh (lax.ppermute over the pairs
        (i, i + shift): a shard no one sends to receives zeros).  Always a
        copy, also between shards of one device: no received slab aliases
        its sender's rows."""
        n = self.size
        if len(slabs) != n:
            raise ValueError(f"{len(slabs)} slabs for {n} shards")
        out = []
        for k in range(n):
            src = k - shift
            if 0 <= src < n:
                s = slabs[src]
                out.append(s.to(self.devices[k], copy=True))
                self.counts["ppermute_bytes"] += s.numel() * s.element_size()
            else:
                out.append(torch.zeros_like(slabs[k],
                                            device=self.devices[k]))
        self.counts["ppermute"] += 1
        return out

    def psum(self, partials: Sequence[torch.Tensor]) -> torch.Tensor:
        """The sum of the shards' partials, in one fixed order, so that
        results are reproducible; on the first shard's device (every shard
        of the JAX package's psum holds the same value)."""
        if len(partials) != self.size:
            raise ValueError(f"{len(partials)} partials for {self.size} "
                             "shards")
        self.counts["psum"] += 1
        self.counts["psum_bytes"] += sum(p.numel() * p.element_size()
                                         for p in partials)
        return torch.stack([p.to(self.devices[0]) for p in partials]).sum(0)

    def blocks(self, n: int, rows: int):
        """The row blocks of an n-row vector, `rows` a shard
        (parallel/mesh_vector.RowBlocks)."""
        return RowBlocks(self, n, rows)

    def scatter(self, v: torch.Tensor, rows: int):
        """v (one tensor, rows along its last dimension) as a MeshVector
        of `rows` rows a shard, each shard's rows copied to its device;
        counted.  The inverse of `gather`."""
        blocks = self.blocks(v.shape[-1], rows)
        shards = [v[..., lo:hi].to(dev, copy=True).contiguous()
                  for (lo, hi), dev in zip(blocks.bounds, self.devices)]
        self.counts["scatter"] += 1
        self.counts["scatter_bytes"] += v.numel() * v.element_size()
        return MeshVector(shards, blocks)

    def gather(self, v) -> torch.Tensor:
        """A MeshVector of this mesh as one tensor on the first device:
        its shards joined along the sharded dimension; counted."""
        if not isinstance(v, MeshVector) or v.mesh is not self:
            raise ValueError("gather takes a MeshVector of this mesh")
        self.counts["gather"] += 1
        self.counts["gather_bytes"] += v.numel() * v.element_size()
        return torch.cat([s.to(self.devices[0]) for s in v.shards],
                         dim=v.sdim)


def make_mesh(n_devices: Optional[int] = None, axis: str = AXIS,
              device=None) -> Mesh:
    """The first `n_devices` CUDA cards (all of them when None), raising
    when there are fewer; or, with `device` given, `n_devices` shards all
    bound to that one device ("cpu", or "cuda" for the current card), the
    counterpart of XLA's virtual host devices.  Nothing falls back to
    another device."""
    from ..stencil_op import resolve_device
    if device is not None:
        if n_devices is None or n_devices < 1:
            raise ValueError("a mesh on one device needs n_devices >= 1")
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return Mesh([dev] * n_devices, axis)
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    devs = [torch.device("cuda", i) for i in range(count)]
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(
                f"requested {n_devices} devices, only {len(devs)} available")
        devs = devs[:n_devices]
    return Mesh(devs, axis)


def shard_vector(v: torch.Tensor, npad: int, mesh: Mesh):
    """v zero-padded to the padded row count and cut into the mesh's
    shards, npad / size rows each on its device (`Mesh.scatter`)."""
    if v.shape[0] != npad:
        v = torch.nn.functional.pad(v, (0, npad - v.shape[0]))
    return mesh.scatter(v, npad // mesh.size)


def _split(v: torch.Tensor, n_dev: int, dim: int = 0) -> List[torch.Tensor]:
    """The shards' row blocks of v along `dim` (views)."""
    local = v.shape[dim] // n_dev
    return [v.narrow(dim, k * local, local) for k in range(n_dev)]


def _halo_exchange(mesh: Mesh, x_shards: Sequence[torch.Tensor], hneg: int,
                   hpos: int) -> List[torch.Tensor]:
    """Each shard's window: its left neighbour's last hneg entries, its
    own, its right neighbour's first hpos entries.  Open boundary: the
    edge shards receive zeros, the single-device path's zero padding."""
    left = (mesh.ppermute([x[x.shape[0] - hneg:] for x in x_shards], 1)
            if hneg else None)
    right = mesh.ppermute([x[:hpos] for x in x_shards], -1) if hpos else None
    windows = []
    for k, x in enumerate(x_shards):
        parts = ([left[k]] if hneg else []) + [x] + (
            [right[k]] if hpos else [])
        windows.append(torch.cat(parts) if len(parts) > 1 else x)
    return windows


# ---------------------------------------------------------------------------
# The standalone distributed CG (plain torch per shard)
# ---------------------------------------------------------------------------

def _dia_padded_rows(n: int, offsets) -> int:
    """The JAX package's padded DIA row count (device_matrix.csr_to_dia):
    a row tile of at least the halo width and MIN_ROW_TILE, n rounded up
    to whole tiles."""
    hneg, hpos = _halo(offsets)
    tile = max(_MIN_ROW_TILE,
               -(-(hneg + hpos) // _MIN_ROW_TILE) * _MIN_ROW_TILE)
    return max(tile, -(-n // tile) * tile)


@dataclasses.dataclass
class ShardedDIA:
    """A DIA matrix cut for the mesh: shard k's (k, npad / size) columns
    of the data, zero past n_rows, on mesh.devices[k]."""

    data_shards: Tuple[torch.Tensor, ...]
    offsets: Tuple[int, ...]
    n_rows: int
    n_cols: int

    @property
    def npad(self) -> int:
        return sum(d.shape[1] for d in self.data_shards)


def shard_dia(A, mesh: Mesh, axis: str = AXIS) -> ShardedDIA:
    """A DeviceDIA padded to the JAX package's row count and cut into the
    mesh's row blocks, each on its shard's device; raises where a halo
    exceeds a shard."""
    npad = _dia_padded_rows(A.n_rows, A.offsets)
    n_dev = mesh.size
    if npad % n_dev:
        raise ValueError(f"padded rows {npad} not divisible by {n_dev} "
                         "devices")
    local = npad // n_dev
    hneg, hpos = _halo(A.offsets)
    if hneg > local or hpos > local:
        raise ValueError(
            f"halo ({hneg},{hpos}) exceeds local shard length {local}; "
            "use fewer devices or a larger matrix")
    data = torch.nn.functional.pad(A.data, (0, npad - A.data.shape[1]))
    return ShardedDIA(
        data_shards=tuple(d.to(dev, copy=True).contiguous() for d, dev in
                          zip(_split(data, n_dev, 1), mesh.devices)),
        offsets=tuple(A.offsets), n_rows=A.n_rows, n_cols=A.n_cols)


def sharded_spmv_dia(mesh: Mesh, data_shards: Sequence[torch.Tensor],
                     offsets, x_shards: Sequence[torch.Tensor]
                     ) -> List[torch.Tensor]:
    """Each shard's block of y = A·x: the halo exchange, then the shifted-
    slice accumulation of the single-device plain SpMV on its window."""
    hneg, hpos = _halo(offsets)
    out = []
    for data_l, xp in zip(data_shards,
                          _halo_exchange(mesh, x_shards, hneg, hpos)):
        local = data_l.shape[1]
        y = torch.zeros(local, dtype=xp.dtype, device=xp.device)
        for d, off in enumerate(offsets):
            y = y + data_l[d].to(xp.dtype) * xp[hneg + off:hneg + off + local]
        out.append(y)
    return out


def sharded_two_stage(mesh: Mesh, T_shards, offsets, dinv_shards,
                      y_shards, inner_iters: int) -> List[torch.Tensor]:
    """The Jacobi-Richardson triangular-solve approximation per shard (the
    reference's two_stage_gauss_seidel, kernels.hpp:312-333): each inner
    sweep is one halo exchange and local work."""
    work = [d * y for d, y in zip(dinv_shards, y_shards)]
    out = list(work)
    for _ in range(inner_iters):
        t = sharded_spmv_dia(mesh, T_shards, offsets, work)
        work = [-d * ti for d, ti in zip(dinv_shards, t)]
        out = [o + w for o, w in zip(out, work)]
    return out


@dataclasses.dataclass
class ShardedCG:
    """Distributed PCG: solvers/cg.py's recurrence (the reference's
    cg.hpp:6-54) with per-shard dots summed by psum and the halo-exchanged
    SpMV.  Preconditioners: none, Jacobi (D_inv), or the symmetric
    two-stage form (L_strict, U_strict, D): each inner sweep one more
    exchange.  Vectors are MeshVectors of npad rows (`shard_vector`)."""

    mesh: Mesh
    A: ShardedDIA
    b: torch.Tensor
    D_inv: Optional[torch.Tensor]
    npad: int
    axis: str = AXIS
    L_strict: Optional[ShardedDIA] = None
    U_strict: Optional[ShardedDIA] = None
    D: Optional[torch.Tensor] = None
    inner_iters: int = 1

    def _like(self, shards):
        return MeshVector(shards, self.b.blocks)

    def _spmv(self, M: ShardedDIA, v) -> torch.Tensor:
        return self._like(sharded_spmv_dia(self.mesh, M.data_shards,
                                           M.offsets, v.shards))

    def _two_stage(self, T: ShardedDIA, y):
        return self._like(sharded_two_stage(
            self.mesh, T.data_shards, T.offsets, self.D_inv.shards,
            y.shards, self.inner_iters))

    def _apply_M(self, y):
        if self.L_strict is not None:
            z = self._two_stage(self.L_strict, y) * self.D
            return self._two_stage(self.U_strict, z)
        if self.D_inv is not None:
            return y * self.D_inv
        return y

    def init_state(self, x0) -> dict:
        """The state from x0: a MeshVector like b, or one tensor of npad
        rows, placed on the mesh (Mesh.scatter)."""
        if not isinstance(x0, MeshVector):
            x0 = shard_vector(x0, self.npad, self.mesh)
        r = self.b - self._spmv(self.A, x0)
        z = self._apply_M(r)
        rn = torch.sqrt(torch.dot(r, r))
        return {"x": x0, "r": r, "z": z, "p": z, "residual_norm": rn}

    def step_fn(self):
        """One CG iteration as a state → state function."""
        def step(state):
            x, r, z, p = state["x"], state["r"], state["z"], state["p"]
            t = self._spmv(self.A, p)
            rz = torch.dot(r, z)
            alpha = rz / torch.dot(t, p)
            x = x + alpha * p
            r_new = r - alpha * t
            z_new = self._apply_M(r_new)
            beta = torch.dot(r_new, z_new) / rz
            p_new = z_new + beta * p
            rn = torch.sqrt(torch.dot(r_new, r_new))
            return {"x": x, "r": r_new, "z": z_new, "p": p_new,
                    "residual_norm": rn}
        return step


def make_sharded_cg(A, b: torch.Tensor, mesh: Mesh,
                    D_inv: Optional[torch.Tensor] = None,
                    two_stage: bool = False, inner_iters: int = 1,
                    axis: str = AXIS) -> ShardedCG:
    """The distributed CG of a DeviceDIA; two_stage=True builds the
    symmetric two-stage preconditioner from the DIA split (dia.dia_split),
    which needs D_inv."""
    from ..dia import dia_split
    npad = _dia_padded_rows(A.n_rows, A.offsets)
    A_sh = shard_dia(A, mesh, axis)
    b_sh = shard_vector(b, npad, mesh)
    dinv_sh = shard_vector(D_inv, npad, mesh) if D_inv is not None else None
    L_sh = U_sh = D_sh = None
    if two_stage:
        if D_inv is None:
            raise ValueError("two_stage needs D_inv")
        L, U, D, _ = dia_split(A)
        L_sh = shard_dia(L, mesh, axis)
        U_sh = shard_dia(U, mesh, axis)
        D_sh = shard_vector(D.to(b.dtype), npad, mesh)
    return ShardedCG(mesh=mesh, A=A_sh, b=b_sh, D_inv=dinv_sh, npad=npad,
                     axis=axis, L_strict=L_sh, U_strict=U_sh, D=D_sh,
                     inner_iters=inner_iters)


# ---------------------------------------------------------------------------
# shard_setup
# ---------------------------------------------------------------------------

class _MeshIneligible(Exception):
    """This setup cannot take the shard_map (mesh-kernel) path."""


def shard_setup(setup, mesh, axis: str = AXIS, mode: str = "auto"):
    """Re-home a SolverSetup onto a device mesh; `solve` then takes the
    setup as it is.

    * On the single-controller `Mesh`: the shard_map mode of the JAX
      package, the operators wrapped as mesh operators whose kernels run
      per shard with halo exchange (parallel/mesh_ops.py), every row
      vector a MeshVector, shard k's rows on mesh.devices[k].  "gspmd",
      and "auto" where the shard_map mode refuses, raise naming the
      refusal: the GSPMD mode needs a DeviceMesh, one process a shard.
    * On a torch.distributed `DeviceMesh` (`make_device_mesh`): "gspmd"
      and "auto" give the GSPMD form (parallel/gspmd.py); "shard_map"
      raises, that mode being single-controller."""
    from .gspmd import is_device_mesh, shard_setup_gspmd
    if mode not in ("auto", "shard_map", "gspmd"):
        raise ValueError(f"unknown shard_setup mode: {mode}")
    if is_device_mesh(mesh):
        if mode == "shard_map":
            raise ValueError(
                "shard_map mode runs on the single-controller Mesh "
                "(make_mesh); a DeviceMesh takes mode 'gspmd' or 'auto'")
        return shard_setup_gspmd(setup, mesh)
    if mode == "gspmd":
        raise ValueError(
            "gspmd mode needs a torch.distributed DeviceMesh, one process "
            "a shard (make_device_mesh); the single-controller Mesh runs "
            "mode 'shard_map'")
    if setup.b.device not in mesh.devices:
        raise ValueError(f"the setup lies on {setup.b.device}, the mesh on "
                         f"{sorted(set(map(str, mesh.devices)))}")
    try:
        return _shard_setup_mesh(setup, mesh, axis)
    except _MeshIneligible as e:
        if mode == "shard_map":
            raise ValueError(f"shard_map mode unavailable: {e}") from e
        raise ValueError(
            f"shard_map mode unavailable: {e}; the JAX package's 'auto' "
            "falls back to its GSPMD mode here, which needs a "
            "torch.distributed DeviceMesh, one process a shard "
            "(make_device_mesh)") from e


def _shard_setup_mesh(setup, mesh: Mesh, axis: str = AXIS):
    """The shard_map mode: wrap every operator of the setup for the mesh,
    all on one row block (`setup_rows`), and place every row vector of
    the setup and its preconditioner as a MeshVector of that layout;
    raises _MeshIneligible, in the JAX package's order, for what cannot
    take the path."""
    from ..device_matrix import DeviceDIA
    from ..ops.block_trisolve import SuperBlockTriSolve, superblock_rows
    from ..ops.lane_ell import DeviceLaneELL
    from ..stencil_op import DeviceStencil
    from .mesh_ops import row_block, wrap_dia, wrap_lane_ell, wrap_stencil

    M = setup.M
    if not all(B is None or isinstance(B, SuperBlockTriSolve)
               for B in (M.L_block, M.U_block)):
        raise _MeshIneligible(
            "rank-space blocked trisolves are not mesh-sharded")
    if M.L_solve is not None or M.U_solve is not None:
        raise _MeshIneligible(
            "level-scan trisolves have cross-shard recurrences")
    if setup.L_solve is not None or setup.U_solve is not None:
        raise _MeshIneligible(
            "level-scan GS solver data has cross-shard recurrences")
    n_dev = mesh.size
    A = setup.A
    if isinstance(A, DeviceStencil):
        if M.mg_data is not None:
            raise _MeshIneligible(
                "multigrid hierarchy is not mesh-wrapped; use mode='gspmd' "
                "on a DeviceMesh")
        if setup.color_arr is not None or M.color_arr is not None:
            raise _MeshIneligible(
                "greedy color arrays don't shard with spec kernels")

        def wrap(Mt, rows):
            if not isinstance(Mt, DeviceStencil):
                raise _MeshIneligible("mixed matrix families in setup")
            return wrap_stencil(dataclasses.replace(Mt, shards=n_dev), mesh,
                                axis, rows)
    elif isinstance(A, DeviceDIA):
        def wrap(Mt, rows):
            if not isinstance(Mt, DeviceDIA):
                raise _MeshIneligible("mixed matrix families in setup")
            return wrap_dia(Mt, mesh, axis, rows)
    elif isinstance(A, DeviceLaneELL):
        # greedy colour arrays (exact coloured GS/SGS on general CSR) are
        # row vectors like any other: each sweep step is one mesh SpMV and
        # a masked update, so the masks partition with the rows
        def wrap(Mt, rows):
            if isinstance(Mt, DeviceLaneELL):
                return wrap_lane_ell(Mt, mesh, axis, rows)
            if isinstance(Mt, DeviceDIA):
                return wrap_dia(Mt, mesh, axis, rows)
            raise _MeshIneligible("mixed matrix families in setup")
    else:
        raise _MeshIneligible(f"no mesh kernels for {type(A).__name__}")
    n = setup.b.shape[0]
    if not isinstance(A, DeviceStencil) and n % n_dev:
        # the JAX package shards these vectors unpadded
        raise _MeshIneligible(f"vector length {n} not divisible by "
                              f"{n_dev} devices")
    mats = {id(Mt): Mt for Mt in (A, M.L_strict_dev, M.U_strict_dev,
                                  M.A_full_dev) if Mt is not None}
    blocks = [B for B in (M.L_block, M.U_block) if B is not None]
    try:
        rows = setup_rows([row_block(Mt, n_dev) for Mt in mats.values()]
                          + [superblock_rows(B, n_dev) for B in blocks])
    except TypeError as e:
        raise _MeshIneligible("mixed matrix families in setup") from e
    wrapped = {k: wrap(Mt, rows) for k, Mt in mats.items()}
    re_mat = lambda Mt: None if Mt is None else wrapped[id(Mt)]  # noqa: E731
    vec = lambda v: None if v is None else mesh.scatter(v, rows)  # noqa: E731
    M_sh = dataclasses.replace(
        M, A_D=vec(M.A_D), A_D_inv=vec(M.A_D_inv),
        color_arr=vec(M.color_arr),
        L_strict_dev=re_mat(M.L_strict_dev),
        U_strict_dev=re_mat(M.U_strict_dev),
        A_full_dev=re_mat(M.A_full_dev),
        L_block=_mesh_blocks(M.L_block, mesh, axis, rows),
        U_block=_mesh_blocks(M.U_block, mesh, axis, rows))
    # the GS methods' own superblock solves (setup.gs_L_block, gs_U_block)
    # stay whole, as the JAX package places them replicated: the solver
    # runs them through a counted gather and scatter (precond.run_whole)
    return dataclasses.replace(
        setup, A=wrapped[id(A)], M=M_sh, b=vec(setup.b), x0=vec(setup.x0),
        A_D=vec(setup.A_D), color_arr=vec(setup.color_arr))


def setup_rows(needs) -> int:
    """The rows a shard of a setup whose operators need (least rows, unit)
    each: the largest least row count, rounded up to a whole number of
    every unit, so that one row block serves them all."""
    import math
    least = max(r for r, _u in needs)
    unit = math.lcm(*(u for _r, u in needs))
    return -(-least // unit) * unit


def _mesh_blocks(B, mesh: Mesh, axis: str, rows: int):
    """A superblock solve cut into the mesh's shards of `rows` rows
    (ops/block_trisolve.shard_superblock); a layout it refuses makes the
    whole setup ineligible for the shard_map mode."""
    if B is None:
        return None
    from ..ops.block_trisolve import BlockIneligibleError, shard_superblock
    try:
        return shard_superblock(B, mesh, axis, rows)
    except BlockIneligibleError as e:
        raise _MeshIneligible(str(e)) from e
