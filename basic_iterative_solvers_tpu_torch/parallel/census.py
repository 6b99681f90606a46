"""Structural communication-layout checks for the GSPMD mode (the JAX
package's parallel/census.py).

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
    step = method.iterate

    def hooked(state, active=None):
        tr.start()
        out = step(state, active)
        tr.end()
        return out

    method.iterate = hooked
    begin = tr._snap()
    try:
        with tr:
            method.solve_fused()
    finally:
        del method.iterate
    if len(tr.starts) < 2:
        raise ValueError("the census needs at least two iterations")
    return tr.census(int(setup.b.shape[0]), (tr.starts[-2], tr.starts[-1]),
                     begin)
