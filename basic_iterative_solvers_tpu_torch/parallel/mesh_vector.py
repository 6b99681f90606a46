"""Row-sharded vectors of the single-controller Mesh (the shard_map mode).

The JAX package's `shard_setup` places every solver vector of its
shard_map mode with NamedSharding(mesh, P(axis)): each chip holds its own
rows (parallel/sharded.py:304-315,384-386 there).  Its PyTorch
counterpart is `MeshVector`, a torch.Tensor wrapper subclass: the logical
tensor, whose sharded dimension has n rows, held as the list of its
shards' row blocks, block k a plain tensor on `mesh.devices[k]`.

Layout (`RowBlocks`): shard k owns rows [k·R, (k+1)·R) clipped to n, so
the last shard is short where R does not divide n and shards past n hold
no rows.  The inert pad rows an operator's layout needs are added to such
a shard's window only, by the mesh operators (parallel/mesh_ops.py).  A
vector has one sharded dimension: the last for a row vector or a GMRES
basis (rows per shard, the GSPMD mode's Shard(1)), another after `stack`.

`__torch_dispatch__` runs
* pointwise ops, and clone, the `*_like` factories, dtype casts, copies,
  views along an unsharded dimension and `stack`, shard by shard, a 0-d
  tensor going to each shard's device;
* `dot` and a whole `sum` as the shards' partials summed by `Mesh.psum`
  in its fixed order; `max`, `min`, `all` and `any` of the shards'
  results;
and raises for any other op, naming it, and where a plain tensor of one
or more dimensions meets a MeshVector: splitting it would hide a
whole-vector copy an iteration.  `Mesh.gather` and `Mesh.scatter` are the
only ways between a MeshVector and one tensor on one device; both are
counted in `Mesh.counts`.

Shard-by-shard ops are a Python loop over the shards (one launch a shard
on a card).  On a one-card mesh the `torch._foreach_*` ops would take one
launch for the shards of a list-by-list op (x + y, x * y), but not for
the scaled sums whose scale is a 0-d tensor (addcmul), most of what the
solvers send; scripts/mesh_host_share.py measures where a mesh CG
iteration's host time goes.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

aten = torch.ops.aten


@dataclasses.dataclass(frozen=True)
class RowBlocks:
    """Shard k of `mesh` owns rows [k·rows, (k+1)·rows) of n, clipped to
    n.  Two vectors mix only where their RowBlocks are equal (the same
    mesh object, n and rows)."""

    mesh: object
    n: int
    rows: int

    def __post_init__(self):
        if self.rows < 1 or self.n < 0:
            raise ValueError(f"bad row blocks: n={self.n}, rows={self.rows}")
        if self.rows * self.mesh.size < self.n:
            raise ValueError(f"{self.mesh.size} shards of {self.rows} rows "
                             f"do not hold {self.n} rows")

    @functools.cached_property
    def bounds(self) -> tuple:
        """(lo, hi) of each shard's rows."""
        R, n = self.rows, self.n
        return tuple((min(k * R, n), min((k + 1) * R, n))
                     for k in range(self.mesh.size))

    def zeros(self, dtype, lead: tuple = ()) -> "MeshVector":
        """A zero MeshVector of shape lead + (n,), each shard on its
        device."""
        return MeshVector([
            torch.zeros(lead + (hi - lo,), dtype=dtype, device=dev)
            for (lo, hi), dev in zip(self.bounds, self.mesh.devices)], self)

    def from_rows(self, fn) -> "MeshVector":
        """The MeshVector whose shard k is fn(lo, hi, device) (a function
        of the shard's global rows [lo, hi), made on its device)."""
        return MeshVector([fn(lo, hi, dev) for (lo, hi), dev in
                           zip(self.bounds, self.mesh.devices)], self)


def _pos(sdim: int, ndim: int) -> int:
    return sdim + ndim


class MeshVector(torch.Tensor):
    """A row-sharded tensor of the single-controller Mesh (module
    docstring).  `shards[k]` is shard k's row block on mesh.devices[k];
    `blocks` the layout; `sdim` the sharded dimension, counted from the
    end (-1: the last)."""

    @staticmethod
    def __new__(cls, shards: Sequence[torch.Tensor], blocks: RowBlocks,
                sdim: int = -1, check: bool = True):
        shards = tuple(shards)
        if check:
            _check_shards(shards, blocks, sdim)
        s0 = shards[0]
        shape = list(s0.shape)
        shape[sdim] = blocks.n
        r = torch.Tensor._make_wrapper_subclass(
            cls, shape, dtype=s0.dtype, device=blocks.mesh.devices[0])
        r.shards = shards
        r.blocks = blocks
        r.sdim = sdim
        return r

    @property
    def mesh(self):
        return self.blocks.mesh

    def __repr__(self, *, tensor_contents=None):
        return (f"MeshVector(shape={tuple(self.shape)}, dtype={self.dtype}, "
                f"rows={self.blocks.rows}, devices="
                f"{[str(d) for d in self.mesh.devices]})")

    __torch_function__ = torch._C._disabled_torch_function_impl

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        special = _SPECIAL.get(func)
        if special is not None:
            return special(func, args, kwargs)
        if torch.Tag.pointwise in func.tags or func in _SHARDWISE:
            return _shardwise(func, args, kwargs)
        raise NotImplementedError(
            f"{func} does not run shard by shard on a MeshVector; gather "
            "it to one device first (Mesh.gather)")


def _check_shards(shards, blocks: RowBlocks, sdim: int) -> None:
    mesh = blocks.mesh
    if len(shards) != mesh.size:
        raise ValueError(f"{len(shards)} shards for a mesh of {mesh.size}")
    s0 = shards[0]
    for k, (s, (lo, hi), dev) in enumerate(zip(shards, blocks.bounds,
                                               mesh.devices)):
        if s.device != dev:
            raise ValueError(f"shard {k} lies on {s.device}, its device is "
                             f"{dev}")
        if (s.dim() != s0.dim() or s.dtype != s0.dtype
                or s.shape[sdim] != hi - lo):
            raise ValueError(f"shard {k} has shape {tuple(s.shape)} "
                             f"({s.dtype}); its rows are [{lo}, {hi})")


def _wrap(shards, blocks: RowBlocks, sdim: int):
    return MeshVector(shards, blocks, sdim, check=False)


def _split_args(func, args, kwargs):
    """(flat args, spec, the MeshVectors' common blocks and sdim, the
    positions of MeshVectors and of 0-d plain tensors); raises where
    layouts differ or a plain tensor of one or more dimensions comes in."""
    flat, spec = tree_flatten((args, kwargs))
    mv, scalars, head = [], [], None
    for i, a in enumerate(flat):
        if isinstance(a, MeshVector):
            if head is None:
                head = a
            elif a.blocks != head.blocks or a.sdim != head.sdim:
                raise ValueError(f"{func}: MeshVectors of different layouts "
                                 f"({a.blocks.rows} against "
                                 f"{head.blocks.rows} rows a shard, or "
                                 "another mesh)")
            mv.append(i)
        elif isinstance(a, torch.Tensor):
            if a.dim() > 0:
                raise ValueError(
                    f"{func}: a plain tensor of shape {tuple(a.shape)} on "
                    f"{a.device} mixed with a MeshVector; place it on the "
                    "mesh (Mesh.scatter) or gather the MeshVector "
                    "(Mesh.gather)")
            scalars.append(i)
    return flat, spec, head, mv, scalars


def _per_shard(func, args, kwargs):
    """func on each shard; 0-d tensors moved to the shard's device (a CPU
    scalar stays, as torch takes it with any device).  Returns (results,
    head MeshVector)."""
    flat, spec, head, mv, scalars = _split_args(func, args, kwargs)
    outs = []
    for k, dev in enumerate(head.mesh.devices):
        fk = list(flat)
        for i in mv:
            fk[i] = flat[i].shards[k]
        for i in scalars:
            t = flat[i]
            if t.device != dev and t.device.type != "cpu":
                fk[i] = t.to(dev)
        a, kw = tree_unflatten(fk, spec)
        outs.append(func(*a, **kw))
    return outs, head


def _shardwise(func, args, kwargs):
    outs, head = _per_shard(func, args, kwargs)
    if func._schema.name.endswith("_"):           # in place: a's shards
        return args[0]
    return _wrap(outs, head.blocks, head.sdim)


def _no_device(func, kwargs, head):
    """kwargs without `device`, raising where it names another device
    than the MeshVector's own: a MeshVector moves only by Mesh.gather."""
    dev = kwargs.get("device")
    if dev is not None and torch.device(dev) != head.device:
        raise ValueError(f"{func}: a MeshVector does not move to {dev}; "
                         "gather it (Mesh.gather)")
    return {k: v for k, v in kwargs.items() if k != "device"}


def _like(func, args, kwargs):
    """A `*_like` factory or a dtype cast, shard by shard."""
    return _shardwise(func, args, _no_device(func, kwargs, args[0]))


def _reduce(func, args, kwargs):
    """dot, or a whole sum: the shards' partials summed by Mesh.psum."""
    outs, head = _per_shard(func, args, kwargs)
    return head.mesh.psum(outs)


def _whole(func, args, kwargs):
    """max, min, all or any of the whole tensor: of the shards' results,
    the empty shards left out."""
    head = args[0]
    parts = [func(s) for s in head.shards if s.numel()]
    if not parts:
        return func(head.shards[0])          # raises as torch does
    dev = head.mesh.devices[0]
    return func(torch.stack([p.to(dev) for p in parts]))


def _check_dim(func, head, dim: int) -> int:
    """dim as a positive index, raising where it is the sharded one."""
    nd = head.dim()
    d = dim % nd
    if d == _pos(head.sdim, nd):
        raise ValueError(f"{func} along the sharded dimension of a "
                         "MeshVector; gather it first (Mesh.gather)")
    return d


def _select(func, args, kwargs):
    head, dim = args[0], args[1]
    d = _check_dim(func, head, dim)
    nd = head.dim()
    p = _pos(head.sdim, nd)
    outs = [func(s, *args[1:], **kwargs) for s in head.shards]
    p_new = p - (d < p)
    return _wrap(outs, head.blocks, p_new - (nd - 1))


def _slice(func, args, kwargs):
    head = args[0]
    dim = args[1] if len(args) > 1 else kwargs.get("dim", 0)
    nd = head.dim()
    if dim % nd == _pos(head.sdim, nd):
        start = args[2] if len(args) > 2 else kwargs.get("start")
        end = args[3] if len(args) > 3 else kwargs.get("end")
        step = args[4] if len(args) > 4 else kwargs.get("step", 1)
        if (start in (None, 0) and (end is None or end >= head.blocks.n)
                and step == 1):
            return head
        _check_dim(func, head, dim)
    outs = [func(s, *args[1:], **kwargs) for s in head.shards]
    return _wrap(outs, head.blocks, head.sdim)


def _stack(func, args, kwargs):
    dim = args[1] if len(args) > 1 else kwargs.get("dim", 0)
    outs, head = _per_shard(func, args, kwargs)
    nd = head.dim()
    d = dim % (nd + 1)
    p = _pos(head.sdim, nd)
    p_new = p + (d <= p)
    return _wrap(outs, head.blocks, p_new - (nd + 1))


def _same_size(func, args, kwargs):
    return tuple(args[0].shape) == tuple(args[1].shape)


_SHARDWISE = {
    aten.copy_.default, aten.fill_.Scalar, aten.fill_.Tensor,
    aten.zero_.default, aten.detach.default, aten.alias.default,
}

_SPECIAL = {
    aten.dot.default: _reduce,
    aten.sum.default: _reduce,
    aten.max.default: _whole,
    aten.min.default: _whole,
    aten.all.default: _whole,
    aten.any.default: _whole,
    aten.select.int: _select,
    aten.slice.Tensor: _slice,
    aten.stack.default: _stack,
    aten._to_copy.default: _like,
    aten.zeros_like.default: _like,
    aten.ones_like.default: _like,
    aten.empty_like.default: _like,
    aten.full_like.default: _like,
    aten.is_same_size.default: _same_size,
}
