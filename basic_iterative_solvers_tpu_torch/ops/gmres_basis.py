"""The two basis passes of fused-mode GMRES (orthog_mode="fused").

Counterparts of the JAX package's ops/gmres_basis.py kernels, with their
contracts (gmres_basis.py:135-141, 203-212):

* `project_gram(V, w, vc, j)` -> (Pw, Pv): the raw products
  Pw[i] = <V_i, w> and Pv[i] = <V_i, vc> of basis rows 0..j in one stream
  of those rows, float32, zero beyond row j.
* `correct_write(V, w, ht, j)` -> (vnext, nrm2): wc = w − Σ_{i≤j} ht_i·V_i
  in float32, rounded to the basis dtype (round to nearest even) and
  stored in place as row j+1 of V; returns the float32 copy of that
  rounded row and ‖vnext‖² of the rounded values.

V is a contiguous (rows, n) tensor, one basis row per vector, in float32 or
bfloat16; the TPU kernels' (m_pad, R, L) tiles and 8-row buckets are Mosaic
layout and have no counterpart here.  `j` is a host int: the solver knows
each iteration's index within its restart cycle, so no launch reads the
device.

A CUDA tensor goes through the hand-written kernels (csrc/gmres_basis.cu),
which count their launches in `project_gram.launches` and
`correct_write.launches`; a CPU tensor takes the plain versions.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..config import torch_dtype

BASIS_DTYPES = (torch.float32, torch.bfloat16)
#: threads per block and vector entries per thread of both kernels
#: (csrc/gmres_basis.cu: BIS_GB_THREADS, BIS_GB_ELEMS)
_THREADS, _ELEMS = 256, 8
#: basis rows the kernels' shared-memory ht stage holds (48 KB of float)
MAX_ROWS = 12288


def plan_for(m: int, basis_dtype, w_dtype=torch.float32) -> Optional[int]:
    """The basis rows (m + 1) the kernels take for GMRES(m), or None where
    they do not apply: a vector dtype other than float32, a basis dtype
    other than float32 or bfloat16, or more rows than they stage."""
    if (torch_dtype(w_dtype) != torch.float32
            or torch_dtype(basis_dtype) not in BASIS_DTYPES
            or not 1 <= m < MAX_ROWS):
        return None
    return m + 1


def _check(V, last_row: int, vecs):
    """V a contiguous 2-D float32/bfloat16 basis holding row `last_row`;
    each (name, v, size) a contiguous float32 (size,) vector beside it."""
    if not isinstance(V, torch.Tensor) or V.dim() != 2:
        raise ValueError("V must be a 2-D (rows, n) tensor")
    if V.dtype not in BASIS_DTYPES:
        raise TypeError(f"the basis is {V.dtype}; float32 or bfloat16 only")
    if not V.is_contiguous():
        raise ValueError("V must be contiguous")
    rows = V.shape[0]
    if not 0 <= last_row < rows or rows > MAX_ROWS:
        raise ValueError(f"row {last_row} out of range for {rows} rows")
    for name, v, size in vecs:
        if not isinstance(v, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if v.dtype != torch.float32:
            raise TypeError(f"{name} is {v.dtype}, expected float32")
        if v.shape != (size,):
            raise ValueError(f"{name} has shape {tuple(v.shape)}, "
                             f"expected ({size},)")
        if v.device != V.device:
            raise ValueError(f"{name} is on {v.device}, V on {V.device}")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_project(V, w, vc, j: int):
    n = V.shape[-1]
    _check(V, j, (("w", w, n), ("vc", vc, n)))


def _check_correct(V, w, ht, j: int):
    """ht holds a weight for each row 0..j (and may hold more)."""
    n_ht = max(ht.numel(), j + 1)
    _check(V, j + 1, (("w", w, V.shape[-1]), ("ht", ht, n_ht)))


def _n_blocks(n: int) -> int:
    return -(-n // (_THREADS * _ELEMS))


def _fn(name: str, dtype: torch.dtype):
    from .._build import load_library
    suffix = "f32" if dtype == torch.float32 else "bf16"
    return getattr(load_library(), f"bis_gmres_{name}_{suffix}")


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error "
                           f"{err}")


# ---------------------------------------------------------------------------
# project_gram
# ---------------------------------------------------------------------------

def project_gram_plain(V, w, vc, j: int):
    """Plain PyTorch version of `project_gram`."""
    _check_project(V, w, vc, j)
    Vb = V[:j + 1].to(torch.float32)
    P = torch.zeros((V.shape[0], 2), dtype=torch.float32, device=V.device)
    P[:j + 1] = Vb @ torch.stack([w, vc], dim=1)
    return P[:, 0], P[:, 1]


def _project_gram_cuda(V, w, vc, j: int):
    rows, n = V.shape
    n_blocks = _n_blocks(n)
    partials = torch.empty((n_blocks, rows, 2), dtype=torch.float32,
                           device=V.device)
    err = _fn("project_gram", V.dtype)(
        V.device.index, V.data_ptr(), w.data_ptr(), vc.data_ptr(), n, rows,
        j, partials.data_ptr(), n_blocks,
        torch.cuda.current_stream(V.device).cuda_stream)
    _raise_on(err, "project_gram")
    project_gram.launches += 1
    P = partials.sum(dim=0)
    return P[:, 0], P[:, 1]


def project_gram(V, w, vc, j: int):
    """(Pw, Pv) = (<V_i, w>, <V_i, vc>) for rows i ≤ j, float32, each of
    length V.shape[0] and zero beyond row j."""
    _check_project(V, w, vc, j)
    if V.device.type == "cuda":
        return _project_gram_cuda(V, w, vc, j)
    if V.device.type == "cpu":
        return project_gram_plain(V, w, vc, j)
    raise ValueError(f"no project_gram for device {V.device}")


project_gram.launches = 0


# ---------------------------------------------------------------------------
# correct_write
# ---------------------------------------------------------------------------

def correct_write_plain(V, w, ht, j: int):
    """Plain PyTorch version of `correct_write`: the kernel's arithmetic,
    acc ← acc − ht_i·V_i for i = 0..j in order, each product and
    difference rounded to float32, so the two write the same bits."""
    _check_correct(V, w, ht, j)
    acc = w
    for i in range(j + 1):
        acc = acc - ht[i] * V[i].to(torch.float32)
    rounded = acc.to(V.dtype)
    V[j + 1] = rounded
    vnext = rounded.to(torch.float32)
    return vnext, torch.dot(vnext, vnext)


def _correct_write_cuda(V, w, ht, j: int):
    rows, n = V.shape
    n_blocks = _n_blocks(n)
    vnext = torch.empty(n, dtype=torch.float32, device=V.device)
    partials = torch.empty(n_blocks, dtype=torch.float32, device=V.device)
    err = _fn("correct_write", V.dtype)(
        V.device.index, V.data_ptr(), w.data_ptr(), ht.data_ptr(), n, j,
        vnext.data_ptr(), partials.data_ptr(), n_blocks,
        torch.cuda.current_stream(V.device).cuda_stream)
    _raise_on(err, "correct_write")
    correct_write.launches += 1
    return vnext, partials.sum()


def correct_write(V, w, ht, j: int):
    """Write round(w − Σ_{i≤j} ht_i·V_i) into V[j+1] in place; returns
    (vnext, ‖vnext‖²), vnext the float32 copy of the written row."""
    _check_correct(V, w, ht, j)
    if V.device.type == "cuda":
        return _correct_write_cuda(V, w, ht, j)
    if V.device.type == "cpu":
        return correct_write_plain(V, w, ht, j)
    raise ValueError(f"no correct_write for device {V.device}")


correct_write.launches = 0
