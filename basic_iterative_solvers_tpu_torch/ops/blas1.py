"""BLAS-1 vector operations of the solver hot path.

Analogs of the reference's kernels.hpp:119-212, as plain torch ops on 1-D
tensors (the JAX package leaves them to XLA, outside any Pallas kernel).
`scale_` may be a Python number or a 0-d tensor on the vectors' device.
The scaled sums are one fused multiply-add per entry (`addcmul`, or `add`
with `alpha`), rounded once as XLA's fused loops round them, and one
launch each on a card.  Each is TIME'd in the host harness's
kernel-timing mode (utils/ktimers.py): "sum", "dot" and "norm".
"""
from __future__ import annotations

import torch

from ..utils.ktimers import ktime


def subtract_vectors(v1, v2, scale_=1.0):
    """r = v1 - scale*v2  (kernels.hpp:119-126)."""
    if isinstance(scale_, torch.Tensor):
        return ktime("sum", torch.addcmul, v1, v2, scale_, value=-1)
    return ktime("sum", torch.sub, v1, v2, alpha=scale_)


def sum_vectors(v1, v2, scale_=1.0):
    """r = v1 + scale*v2  (kernels.hpp:128-135)."""
    if isinstance(scale_, torch.Tensor):
        return ktime("sum", torch.addcmul, v1, v2, scale_)
    return ktime("sum", torch.add, v1, v2, alpha=scale_)


def dot(v1, v2):
    """(v1, v2)  (kernels.hpp:205-212)."""
    return ktime("dot", torch.dot, v1, v2)


def euclidean_vec_norm(v):
    """||v||_2  (kernels.hpp:194-203), as sqrt((v, v)) like the JAX package."""
    return ktime("norm", lambda a: torch.sqrt(torch.dot(a, a)), v)
