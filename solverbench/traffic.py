"""The general generator of the benchmark's traffic.

A traffic mix is a JSON file under `traffic/`: the method and
preconditioner each solve asks for, its tolerance and iteration limit,
and how right-hand sides are made.  Every solve of a run gets its own
right-hand side b = A·x_true, x_true = center + u with u uniform in
[−half_width, half_width), drawn on the device from (seed, solve index),
A applied in float64 by the plain reference operator, then b rounded to
the solve dtype.  The same (seed, index) gives the same x_true and b.
"""
from __future__ import annotations

import hashlib

import torch

#: the solve index of the set-up's warm-up solve (no window solve has it)
WARMUP = -1


def stream_seed(seed: int, index: int, stream: str = "rhs") -> int:
    """A 63-bit generator seed for one solve of one run."""
    h = hashlib.sha256(f"{stream}:{seed}:{index}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def x_true(n: int, traffic: dict, seed: int, index: int, device):
    """The exact solution of solve `index` (float32, on `device`)."""
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, index))
    spec = traffic["x_true"]
    u = torch.rand(n, generator=g, device=device, dtype=torch.float32)
    return (u - 0.5) * (2.0 * spec["half_width"]) + spec["center"]


def rhs(op, traffic: dict, seed: int, index: int, dtype, device):
    """(x_true, b) of solve `index`: b = A·x_true in float64 by the
    reference operator `op`, rounded to `dtype`."""
    xt = x_true(op.n, traffic, seed, index, device)
    return xt, op.apply(xt, torch.float64).to(dtype)
