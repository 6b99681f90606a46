"""BLAS-1 vector operations of the solver hot path.

Analogs of the reference's kernels.hpp:119-220, as plain torch ops on 1-D
tensors (the JAX package leaves them to XLA, outside any Pallas kernel).
`scale_` may be a Python number or a 0-d tensor on the vectors' device.
On the GSPMD mode's row-sharded DTensors (parallel/gspmd.py) the same ops
run per rank; `dot` and `euclidean_vec_norm` return Replicate scalars
(one all-reduce of the ranks' partial sums).  On the shard_map mode's
MeshVectors (parallel/mesh_vector.py) they run shard by shard, a dot
being the shards' partials summed by Mesh.psum.  Float32 dots sum their
products in float64 (`whole_dot`), so that a dot's value does not hang on
how the rows are sharded.  `full_value` is the one way a solver reads a
device quantity on the host.
The scaled sums are one fused multiply-add per entry (`addcmul`, or `add`
with `alpha`), rounded once as XLA's fused loops round them, and one
launch each on a card.  Each is TIME'd in the host harness's
kernel-timing mode (utils/ktimers.py): "sum", "dot" and "norm".
"""
from __future__ import annotations

import dataclasses
import functools

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


def elemwise_mult_vectors(v1, v2, scale_=1.0):
    """r = v1 * (scale*v2)  (kernels.hpp:137-144)."""
    return v1 * (scale_ * v2)


def elemwise_div_vectors(v1, v2, scale_=1.0):
    """r = v1 / (scale*v2)  (kernels.hpp:146-153)."""
    return v1 / (scale_ * v2)


@functools.lru_cache(maxsize=None)
def _dtensor_type():
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:          # a torch built without torch.distributed
        return ()
    return DTensor


def is_dtensor(t) -> bool:
    """Is t a torch.distributed DTensor (a GSPMD-mode vector or scalar)?"""
    return isinstance(t, _dtensor_type())


def is_mesh_vector(t) -> bool:
    """Is t a MeshVector (a shard_map-mode vector of the single-controller
    Mesh)?"""
    from ..parallel.mesh_vector import MeshVector
    return isinstance(t, MeshVector)


def is_sharded(t) -> bool:
    """Is t a row-sharded vector of either mode (a DTensor or a
    MeshVector), for callers that do not care which?"""
    return is_dtensor(t) or is_mesh_vector(t)


def full_value(t):
    """t's global value as a plain tensor on its device: a DTensor's
    `full_tensor()` (an all-reduce of a Partial sum, an all-gather of a
    sharded vector, nothing for a Replicate one), a MeshVector gathered to
    its mesh's first device (`Mesh.gather`, counted), any other tensor
    itself.  Every host read of a solver quantity goes through it
    (`float(full_value(rn))`, `full_value(x).cpu()`): `.item()` of a
    Partial DTensor returns the rank's own partial sum."""
    if is_dtensor(t):
        return t.full_tensor()
    if is_mesh_vector(t):
        return t.mesh.gather(t)
    return t


def replicated(s):
    """A reduction's result as every rank's whole value: a Partial DTensor
    reduced to Replicate by one all-reduce of its local partials; anything
    else as it is."""
    if is_dtensor(s) and any(p.is_partial() for p in s.placements):
        import torch.distributed as dist
        from torch.distributed.tensor import DTensor, Replicate
        mesh = s.device_mesh
        t = s.to_local().clone()
        dist.all_reduce(t, group=mesh.get_group())
        return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False)
    return s


def whole_dot(a, b):
    """(a, b) as every rank's whole value.  Float32 vectors' products are
    summed in float64 and the sum rounded once to float32: the value then
    does not hang on how the rows are cut (one device, a Mesh's shards, the
    GSPMD mode's ranks), as a float32 sum's rounding does, so the f32
    histories of a sharded solve and of one device agree where the rest of
    the step does."""
    if a.dtype == torch.float32:
        return replicated(torch.sum(a * b, dtype=torch.float64)).to(a.dtype)
    return replicated(torch.dot(a, b))


def dot(v1, v2):
    """(v1, v2)  (kernels.hpp:205-212)."""
    return ktime("dot", whole_dot, v1, v2)


def euclidean_vec_norm(v):
    """||v||_2  (kernels.hpp:194-203), as sqrt((v, v)) like the JAX package."""
    return ktime("norm", lambda a: torch.sqrt(whole_dot(a, a)), v)


def infty_vec_norm(v):
    """max |v_i|  (kernels.hpp:164-177)."""
    return torch.max(torch.abs(v))


def infty_mat_norm(A):
    """max row sum of |A|  (kernels.hpp:179-192), for a DIA, ELL, lane-ELL
    or stencil operator; a stencil's |A| is applied to ones by the plain
    SpMV, its coefficients and diagonal sign-folded."""
    from ..device_matrix import DeviceDIA, DeviceELL
    from ..stencil_op import DeviceStencil, stencil_spmv_plain
    from .lane_ell import DeviceLaneELL
    if isinstance(A, DeviceDIA):
        return torch.max(torch.sum(torch.abs(A.data), dim=0))
    if isinstance(A, DeviceELL):
        return torch.max(torch.sum(torch.abs(A.data), dim=1))
    if isinstance(A, DeviceLaneELL):
        return torch.max(torch.sum(torch.abs(A.vals), dim=0))
    if isinstance(A, DeviceStencil):
        A_abs = dataclasses.replace(
            A, coeffs=torch.abs(A.coeffs),
            coeff_values=tuple(abs(c) for c in A.coeff_values),
            diag=None if A.diag is None else torch.abs(A.diag))
        dtype = torch.float32 if A.dtype == torch.bfloat16 else A.dtype
        ones = torch.ones(A.n_rows, dtype=dtype, device=A.device)
        return torch.max(stencil_spmv_plain(A_abs, ones))
    raise TypeError(f"unsupported matrix type: {type(A)}")


def scale(v, scalar):
    """r = scalar * v  (kernels.hpp:214-220)."""
    return v * scalar
