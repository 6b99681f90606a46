"""Structural communication-layout checks for the GSPMD mode and the
single-controller Mesh (the JAX package's parallel/census.py).

Parity with the single-device solve cannot see a communication-layout
regression: a CG whose SpMV all-gathers the whole row-sharded vector every
iteration computes the same answer as one whose halos ride neighbour
exchanges; it just scales like a broadcast instead of a stencil.  The JAX
package compiles the partitioned loop and counts the collectives XLA
emitted in its HLO.  Here there is no HLO: the census runs the solve and
counts what it issues, per process:

* DTensor's collectives, seen by torch's `CommDebugMode` (the all-reduce
  of each dot, any all-gather DTensor inserts to partition an operation
  it cannot shard), with the size of each result;
* the port's halo exchanges (point-to-point ops, which CommDebugMode does
  not see), from parallel/gspmd.HALO_COUNTS: one "collective-permute" a
  direction, as XLA issues one op a halo shift.

The invariants the tests hold: the loop body carries scalar all-reduces
(the dots) and collective-permutes (the halos), and no all-gather or
all-to-all of a full-length vector; the pad-and-slice SpMV on a DTensor,
which DTensor partitions by gathering x, is the negative control.

`mesh_census` gives the same result for the shard_map mode on the
single-controller Mesh, read from the mesh's own counts (`Mesh.counts`)
around each iteration: `psum` an all-reduce, `ppermute` a
collective-permute, `Mesh.gather` an all-gather and `Mesh.scatter` a
"scatter" (the only ways between a MeshVector and one tensor), so a whole
vector gathered or scattered inside the loop is what it flags.
"""
from __future__ import annotations

import dataclasses

import torch

COLLECTIVES = ("all-reduce", "all-gather", "collective-permute",
               "reduce-scatter", "all-to-all")

#: torch's collective ops (functional, native functional and c10d) by kind
_KIND_NAMES = {
    "all-reduce": ("all_reduce", "all_reduce_coalesced", "allreduce_",
                   "allreduce_coalesced_"),
    "all-gather": ("all_gather_into_tensor",
                   "all_gather_into_tensor_coalesced", "_allgather_base_",
                   "allgather_", "allgather_coalesced_",
                   "allgather_into_tensor_coalesced_"),
    "reduce-scatter": ("reduce_scatter_tensor",
                       "reduce_scatter_tensor_coalesced",
                       "_reduce_scatter_base_", "reduce_scatter_",
                       "reduce_scatter_tensor_coalesced_"),
    "all-to-all": ("all_to_all_single", "alltoall_", "alltoall_base_"),
}
_KIND_OF = {name: kind for kind, names in _KIND_NAMES.items()
            for name in names}

#: calls of the loop body `collective_census` makes (the census is the last)
_BODY_CALLS = 2
#: iterations of the fused solve `fused_collective_census` runs (the census
#: is the one from the second-last `iterate` call to the last)
_SOLVE_ITERS = 3


def _elems(out) -> int:
    """Elements of every tensor in a collective's result."""
    if isinstance(out, torch.Tensor):
        return out.numel()
    if isinstance(out, (tuple, list)):
        return sum(_elems(o) for o in out)
    return 0


def _tracker():
    """A CommDebugMode that also records the kind and result size of each
    collective (`events`) and, on `start()` / `end()` around one loop
    iteration, the event count and the halo counter."""
    from torch.distributed.tensor.debug import CommDebugMode

    from .gspmd import HALO_COUNTS

    class Tracker(CommDebugMode):
        def __init__(self):
            super().__init__()
            self.events = []
            self.starts, self.ends = [], []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            packet = getattr(func, "_overloadpacket", None)
            if out is not NotImplemented and packet is not None:
                kind = _KIND_OF.get(packet.__name__)
                if kind is not None:
                    self.events.append((kind, _elems(out)))
            return out

        def _snap(self):
            return len(self.events), HALO_COUNTS["collective-permute"]

        def start(self):
            self.starts.append(self._snap())

        def end(self):
            self.ends.append(self._snap())

        def census(self, full_vector_len, body, begin) -> dict:
            """`body` = the (events, permutes) snapshots that bound one
            iteration; `begin` those of the run's start.  Events from the
            first iteration's start to the last one's end are the loop's
            ("while"), the rest "setup"."""
            (e0, p0), (e1, p1) = body
            now = self._snap()
            totals = _counts(self.events, now[1] - begin[1])
            totals["in_while"] = _counts(self.events[e0:e1], p1 - p0)
            lo, hi = self.starts[0][0], self.ends[-1][0]
            totals["full_gathers"] = [
                (kind, "while" if lo <= i < hi else "setup", elems)
                for i, (kind, elems) in enumerate(self.events)
                if kind in ("all-gather", "all-to-all")
                and elems >= full_vector_len]
            return totals

    return Tracker()


def _counts(events, permutes: int) -> dict:
    c = {k: 0 for k in COLLECTIVES}
    for kind, _ in events:
        c[kind] += 1
    c["collective-permute"] += permutes
    return c


def _hook_iterate(method, before, after):
    """Make method.iterate call before() and after() around each step;
    returns the function that undoes it."""
    step = method.iterate

    def hooked(state, active=None):
        before()
        out = step(state, active)
        after()
        return out

    method.iterate = hooked
    return lambda: delattr(method, "iterate")


def collective_census(fn, full_vector_len: int) -> dict:
    """Count the collectives `fn()` issues, `fn` being one iteration of a
    loop body: it runs _BODY_CALLS times.  Returns ``{kind: total}`` for
    every kind in COLLECTIVES plus

    * ``in_while`` — the same counts for one iteration (the last call);
    * ``full_gathers`` — ``(kind, where, elems)`` for every all-gather /
      all-to-all whose result holds ≥ ``full_vector_len`` elements
      (``where`` is ``"while"``: every call of fn is the loop's).

    This takes the place of the JAX package's hlo_collective_census (there
    is no HLO here); it is the negative control's entry point."""
    tr = _tracker()
    begin = tr._snap()
    with tr:
        for _ in range(_BODY_CALLS):
            tr.start()
            fn()
            tr.end()
    return tr.census(full_vector_len, (tr.starts[-1], tr.ends[-1]), begin)


def fused_collective_census(setup, method=None) -> dict:
    """The census of the fused solve of `setup` (already shard_setup'd in
    the GSPMD mode): _SOLVE_ITERS iterations at tolerance 0 in the fused
    harness under the tracker, the method's `iterate` hooked.
    ``in_while`` is one loop iteration, from the start of the second-last
    `iterate` call to the start of the last: the step, its sampled norm
    and the loop's bookkeeping, whole counts.  `method` replaces the
    method the factory makes for that census setup (it must run at least
    two iterations)."""
    from ..solvers.factory import make_method
    if method is None:
        cfg = dataclasses.replace(setup.config, tolerance=0.0,
                                  max_iters=_SOLVE_ITERS, harness="fused",
                                  refine_outer=0)
        method = make_method(dataclasses.replace(setup, config=cfg))
    tr = _tracker()
    unhook = _hook_iterate(method, tr.start, tr.end)
    begin = tr._snap()
    try:
        with tr:
            method.solve_fused()
    finally:
        unhook()
    if len(tr.starts) < 2:
        raise ValueError("the census needs at least two iterations")
    return tr.census(int(setup.b.shape[0]), (tr.starts[-2], tr.starts[-1]),
                     begin)


#: mesh_census's kinds: the census's name of each Mesh.counts entry
_MESH_KINDS = {"all-reduce": "psum", "collective-permute": "ppermute",
               "all-gather": "gather", "scatter": "scatter"}


def mesh_census(setup, method=None) -> dict:
    """The census of the fused solve of `setup` (shard_setup'd in the
    shard_map mode on a Mesh), in fused_collective_census's shape and over
    the same iterations: ``{kind: total}`` for every kind in COLLECTIVES
    and "scatter", ``in_while`` one loop iteration (from the start of the
    second-last `iterate` call to the start of the last), and
    ``full_gathers`` ``(kind, where, elems)`` ("all-gather" or "scatter")
    for every stretch of the run whose gathers, or scatters, moved at
    least one whole vector's bytes (the setup's rows at its dtype):
    each iteration (from the start of one `iterate` call to the next's,
    the last to its end), "while", and the set-up before and after the
    loop, "setup"; ``elems`` the elements they moved.  Read from the deltas of
    `Mesh.counts` at the start and end of each `iterate` call."""
    from ..solvers.factory import make_method
    mesh = setup.b.mesh
    if method is None:
        cfg = dataclasses.replace(setup.config, tolerance=0.0,
                                  max_iters=_SOLVE_ITERS, harness="fused",
                                  refine_outer=0)
        method = make_method(dataclasses.replace(setup, config=cfg))
    starts, ends = [], []
    unhook = _hook_iterate(method, lambda: starts.append(dict(mesh.counts)),
                           lambda: ends.append(dict(mesh.counts)))
    begin = dict(mesh.counts)
    try:
        method.solve_fused()
    finally:
        unhook()
    end = dict(mesh.counts)
    if len(starts) < 2:
        raise ValueError("the census needs at least two iterations")

    def counts(a, b):
        c = {k: 0 for k in COLLECTIVES}
        c.update({kind: b[key] - a[key] for kind, key in _MESH_KINDS.items()})
        return c

    totals = counts(begin, end)
    totals["in_while"] = counts(starts[-2], starts[-1])
    whole = int(setup.b.shape[0]) * setup.b.element_size()
    stretches = ([(begin, starts[0], "setup")]
                 + [(a, b, "while")
                    for a, b in zip(starts, starts[1:] + ends[-1:])]
                 + [(ends[-1], end, "setup")])
    totals["full_gathers"] = [
        (kind, where, moved // setup.b.element_size())
        for a, b, where in stretches
        for kind, key in (("all-gather", "gather"), ("scatter", "scatter"))
        for moved in [b[f"{key}_bytes"] - a[f"{key}_bytes"]]
        if b[key] > a[key] and moved >= whole]
    return totals
