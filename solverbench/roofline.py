"""Published peaks of the card and the bytes and operations the solves
need, from a configuration's shapes alone, whatever implements them.

Each input byte is counted read once and each output byte written once.
The shares built on these are lower bounds of the time the card could
take: no implementation can read above 100%.
"""
from __future__ import annotations

import torch

from .reference import stencil_legs

#: one H100 SXM's published peaks at 700 W (NVIDIA's data sheet): HBM
#: bytes/s, and float32 operations/s outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12


def rows(config: dict) -> int:
    nx, ny, nz = config["grid"]
    return nx * ny * nz


def points(config: dict) -> int:
    """Stored entries a row: the legs and the diagonal."""
    return len(stencil_legs(config["stencil"])[1]) + 1


def spmv_bytes(config: dict, itemsize: int) -> int:
    """y = A·x, x and y of `itemsize` bytes: x read and y written once; a
    DIA matrix also reads its stored diagonals, in the configuration's
    dtype, and their int64 offsets once.  A stencil's coefficients are
    constants of the launch."""
    n = rows(config)
    nbytes = 2 * n * itemsize
    if config["format"] == "dia":
        stored = getattr(torch, config["dtype"]).itemsize
        nbytes += points(config) * (n * stored + 8)
    return nbytes


def spmv_ops(config: dict) -> int:
    """A multiply and an add a stored entry."""
    return 2 * points(config) * rows(config)


def trisolve_apply_bytes(config: dict, itemsize: int) -> int:
    """One apply of a pair of triangular solves (L, then U): each reads
    its right-hand side once and writes its solution once.  The factors
    are left out: how they are stored is the program's choice."""
    return 2 * 2 * rows(config) * itemsize


def bound_seconds(nbytes: float, ops: float = 0.0) -> float:
    """The least time the card could take: bytes over its memory rate or
    operations over its float32 rate, the larger."""
    return max(nbytes / PEAK_BYTES_S, ops / PEAK_F32_OPS_S)
