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

A CUDA tensor goes through the hand-written kernels (csrc/gmres_basis.cu)
on one of two routes, chosen by shape before the launch (`route_for`):
"ring" (a persistent grid fed by a ring of bulk copies, 16-byte vectors)
where every row and vector is 16-byte aligned, "strided" (scalar loads
strided by the block width) elsewhere.  Each wrapper counts its launches in
`launches` and each route's in `ring_launches` or `strided_launches`; a CPU
tensor takes the plain versions.  A failed build or launch raises: no route
gives way to another or to the plain version.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ..config import torch_dtype

BASIS_DTYPES = (torch.float32, torch.bfloat16)
#: threads per block and vector entries per thread of the strided route
#: (csrc/gmres_basis.cu: BIS_GB_THREADS, BIS_GB_ELEMS)
_THREADS, _ELEMS = 256, 8
#: basis rows the strided correct_write's shared-memory ht stage holds
#: (48 KB of float)
MAX_ROWS = 12288
ROUTES = ("ring", "strided")
#: the ring route (csrc/gmres_basis.cu: BIS_RING_*): consumer threads a
#: block, 16-byte vectors a stage holds, stages, the most blocks a launch,
#: blocks a group of the cross-block sums
RING_CONSUMERS, RING_STAGE_VECS, RING_STAGES = 256, 512, 6
RING_MAX_GRID, RING_GROUP_BLOCKS = 512, 16
#: the ring kernels by name and basis dtype, as
#: bis_gmres_ring_blocks_per_sm numbers them
_RING_KERNELS = {("project_gram", torch.float32): 0,
                 ("project_gram", torch.bfloat16): 1,
                 ("correct_write", torch.float32): 2,
                 ("correct_write", torch.bfloat16): 3}


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


def route_for(V, *vectors) -> str:
    """The kernel route for a basis V and the float32 vectors a launch
    reads or writes beside it: "ring" where the bulk copies and 16-byte
    vector accesses can take them (n > 0, each row a whole number of
    16-byte vectors, V's and every vector's first entry on a 16-byte
    boundary), else "strided".  A shape alone decides; a sliced V or
    vector whose first entry is off that boundary takes "strided"."""
    n = V.shape[-1]
    aligned = (n > 0 and n * V.element_size() % 16 == 0
               and all(t.data_ptr() % 16 == 0 for t in (V, *vectors)))
    return "ring" if aligned else "strided"


def ring_grid(n_vec: int, slots: int) -> int:
    """Blocks of a ring launch over rows of `n_vec` 16-byte vectors: the
    card's resident blocks (`slots`, one wave of a persistent grid), but no
    more than RING_MAX_GRID and no more than one block a stage of the
    row."""
    return max(1, min(slots, RING_MAX_GRID, -(-n_vec // RING_STAGE_VECS)))


def ring_ranges(n_vec: int, grid: int):
    """Each block's [lo, hi) of a row's 16-byte vectors, as the kernels
    compute them: contiguous, in block order, each starting on a 128-byte
    boundary (a multiple of 8 vectors), sizes within 8 vectors (the last
    also takes the n_vec % 8 left over)."""
    starts = [n_vec // 8 * b // grid * 8 for b in range(grid)] + [n_vec]
    return list(zip(starts[:-1], starts[1:]))


def _sum_layout(grid: int):
    """(gp, gq): a pair's row of block partials and of group partials, in
    floats: the blocks rounded up to whole groups, the groups to whole
    16-byte vectors (the kernels never add the pads)."""
    groups = -(-grid // RING_GROUP_BLOCKS)
    return groups * RING_GROUP_BLOCKS, -(-groups // 4) * 4


def ring_scratch(name: str, rows: int, n: int, j: int, grid: int) -> int:
    """Float32 entries of a ring launch's one buffer, each part 16-byte
    aligned: project_gram's pairs' block and group partials, then Pw and
    Pv (rows each); correct_write's vnext (n), then its block and group
    partials, then nrm2."""
    gp, gq = _sum_layout(grid)
    if name == "project_gram":
        return 2 * (j + 1) * (gp + gq) + 2 * rows
    return n + gp + gq + 1


def _n_blocks(n: int) -> int:
    return -(-n // (_THREADS * _ELEMS))


@functools.lru_cache(maxsize=None)
def _slots(device_index: int, name: str, dtype: torch.dtype) -> int:
    """The card's resident blocks of a ring kernel: its blocks an SM (the
    occupancy the compiled kernel reaches) times the SMs."""
    blocks = ctypes.c_int()
    from .._build import query
    _raise_on(query(_library().bis_gmres_ring_blocks_per_sm, device_index,
                    _RING_KERNELS[name, dtype], ctypes.byref(blocks)),
        f"{name} occupancy query")
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return blocks.value * sms


#: the ring kernels' ticket counters per (device, stream), one for each
#: group of blocks and one across the groups: the last block of each finds
#: itself by its ticket and sets it back to 0
_TICKETS = {}


def _tickets(device: torch.device, stream) -> torch.Tensor:
    key = (device.index, stream.cuda_stream)
    if key not in _TICKETS:
        _TICKETS[key] = torch.zeros(1 + RING_MAX_GRID // RING_GROUP_BLOCKS,
                                    dtype=torch.int32, device=device)
    return _TICKETS[key]


def _library():
    from .._build import load_library
    return load_library()


def _fn(name: str, route: str, dtype: torch.dtype):
    suffix = "f32" if dtype == torch.float32 else "bf16"
    return getattr(_library(), f"bis_gmres_{name}_{route}_{suffix}")


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


def _project_gram_ring(V, w, vc, j: int, grid: int, buf, stream):
    """The ring launch on `grid` blocks with `buf` (ring_scratch floats,
    any contents) as its scratch and output; returns (Pw, Pv), views of
    buf.  Each part's address is buf's plus an integer offset: no view is
    made for a part."""
    from .._build import launch
    rows, n = V.shape
    gp, gq = _sum_layout(grid)
    pairs = 2 * (j + 1)
    base, out = buf.data_ptr(), pairs * (gp + gq)
    err = launch(
        _fn("project_gram", "ring", V.dtype), V.device, V.data_ptr(),
        w.data_ptr(), vc.data_ptr(), n, rows, j, base, gp,
        base + 4 * pairs * gp, gq, base + 4 * out,
        _tickets(V.device, stream).data_ptr(), grid)
    _raise_on(err, "project_gram")
    project_gram.ring_launches += 1
    project_gram.launches += 1
    return buf.narrow(0, out, rows), buf.narrow(0, out + rows, rows)


def _project_gram_cuda(V, w, vc, j: int, route: str):
    from .._build import launch
    rows, n = V.shape
    stream = torch.cuda.current_stream(V.device)
    if route == "ring":
        grid = ring_grid(n * V.element_size() // 16,
                         _slots(V.device.index, "project_gram", V.dtype))
        buf = torch.empty(ring_scratch("project_gram", rows, n, j, grid),
                          dtype=torch.float32, device=V.device)
        return _project_gram_ring(V, w, vc, j, grid, buf, stream)
    n_blocks = _n_blocks(n)
    partials = torch.empty((n_blocks, rows, 2), dtype=torch.float32,
                           device=V.device)
    err = launch(_fn("project_gram", route, V.dtype), V.device,
                 V.data_ptr(), w.data_ptr(), vc.data_ptr(), n, rows, j,
                 partials.data_ptr(), n_blocks)
    _raise_on(err, "project_gram")
    project_gram.strided_launches += 1
    project_gram.launches += 1
    P = partials.sum(dim=0)
    return P[:, 0], P[:, 1]


def project_gram(V, w, vc, j: int):
    """(Pw, Pv) = (<V_i, w>, <V_i, vc>) for rows i ≤ j, float32, each of
    length V.shape[0] and zero beyond row j."""
    _check_project(V, w, vc, j)
    if V.device.type == "cuda":
        return _project_gram_cuda(V, w, vc, j, route_for(V, w, vc))
    if V.device.type == "cpu":
        return project_gram_plain(V, w, vc, j)
    raise ValueError(f"no project_gram for device {V.device}")


project_gram.launches = 0
project_gram.ring_launches = 0
project_gram.strided_launches = 0


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


def _correct_write_ring(V, w, ht, j: int, grid: int, buf, stream):
    """The ring launch on `grid` blocks with `buf` (ring_scratch floats,
    any contents) as its scratch and output; returns (vnext, nrm2), views
    of buf."""
    from .._build import launch
    n = V.shape[1]
    gp, gq = _sum_layout(grid)
    base, last = buf.data_ptr(), n + gp + gq
    err = launch(
        _fn("correct_write", "ring", V.dtype), V.device, V.data_ptr(),
        w.data_ptr(), ht.data_ptr(), n, j, base, base + 4 * n, gp,
        base + 4 * (n + gp), gq, base + 4 * last,
        _tickets(V.device, stream).data_ptr(), grid)
    _raise_on(err, "correct_write")
    correct_write.ring_launches += 1
    correct_write.launches += 1
    return buf.narrow(0, 0, n), buf.select(0, last)


def _correct_write_cuda(V, w, ht, j: int, route: str):
    from .._build import launch
    rows, n = V.shape
    stream = torch.cuda.current_stream(V.device)
    if route == "ring":
        grid = ring_grid(n * V.element_size() // 16,
                         _slots(V.device.index, "correct_write", V.dtype))
        buf = torch.empty(ring_scratch("correct_write", rows, n, j, grid),
                          dtype=torch.float32, device=V.device)
        return _correct_write_ring(V, w, ht, j, grid, buf, stream)
    n_blocks = _n_blocks(n)
    vnext = torch.empty(n, dtype=torch.float32, device=V.device)
    partials = torch.empty(n_blocks, dtype=torch.float32, device=V.device)
    err = launch(_fn("correct_write", route, V.dtype), V.device,
                 V.data_ptr(), w.data_ptr(), ht.data_ptr(), n, j,
                 vnext.data_ptr(), partials.data_ptr(), n_blocks)
    _raise_on(err, "correct_write")
    correct_write.strided_launches += 1
    correct_write.launches += 1
    return vnext, partials.sum()


def correct_write(V, w, ht, j: int):
    """Write round(w − Σ_{i≤j} ht_i·V_i) into V[j+1] in place; returns
    (vnext, ‖vnext‖²), vnext the float32 copy of the written row."""
    _check_correct(V, w, ht, j)
    if V.device.type == "cuda":
        return _correct_write_cuda(V, w, ht, j, route_for(V, w))
    if V.device.type == "cpu":
        return correct_write_plain(V, w, ht, j)
    raise ValueError(f"no correct_write for device {V.device}")


correct_write.launches = 0
correct_write.ring_launches = 0
correct_write.strided_launches = 0
