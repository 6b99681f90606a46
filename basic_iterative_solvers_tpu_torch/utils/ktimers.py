"""Per-kernel stacked timers: the reference's TIME(timers->spmv, ...) layer.

The reference wraps every kernel call site in a named stopwatch
(methods/cg.hpp:16-52, common.hpp:249-254) and prints a solver-specific
hierarchical table with GMRES's orthog/least_sq/update_g sections
(utilities/utilities.hpp:154-324).  Here, as in the JAX package
(basic_iterative_solvers_tpu/utils/ktimers.py), kernel timing is a
host-harness analysis mode: with `SolverConfig.kernel_timers` the host
harness installs its `Timers` registry and every instrumented call site
synchronizes the device of its operands before the call and of its outputs
after it, charging the wall time in between to its name.  With no registry
installed (the default) `ktime` is a pass-through: no synchronization, no
extra launch, the loops unchanged.
"""
from __future__ import annotations

from typing import Optional

import torch

from .timers import Timers

_ACTIVE: Optional[Timers] = None


def activate(timers: Optional[Timers]) -> None:
    """Install (or clear, with None) the kernel-timer registry."""
    global _ACTIVE
    _ACTIVE = timers


def active() -> Optional[Timers]:
    return _ACTIVE


def _cuda_device(obj):
    """The device of the first CUDA tensor in obj (nested tuples, lists and
    dicts), or None."""
    if isinstance(obj, torch.Tensor):
        return obj.device if obj.is_cuda else None
    if isinstance(obj, dict):
        obj = tuple(obj.values())
    if isinstance(obj, (tuple, list)):
        for o in obj:
            d = _cuda_device(o)
            if d is not None:
                return d
    return None


def _sync(obj) -> None:
    device = _cuda_device(obj)
    if device is not None:
        torch.cuda.synchronize(device)


def ktime(name: str, fn, *args, **kwargs):
    """fn(*args, **kwargs); while a registry is active, with the device's
    queue drained before the call and after it, the wall time charged to
    `name`."""
    t = _ACTIVE
    if t is None:
        return fn(*args, **kwargs)
    _sync(args)
    sw = t[name]
    sw.start()
    try:
        out = fn(*args, **kwargs)
        _sync(out)
    finally:
        sw.stop()
    return out
