"""Lane-ELL: the general-sparsity SpMV format.

The JAX package's layout (ops/lane_ell.py), kept so both packages build
the same planes: matrix row i maps to slot (r, l) = (i // 128, i % 128) of
an (R, 128) plane; each nonzero A[i, j] sits in one of K slot planes as
`vals[k, r, l]` and a packed index `idx[k, r, l] = (rowoff + S)·128 +
lane`, rowoff = j//128 − i//128 and lane = j % 128; S = max |rowoff|.  Pad
slots hold val 0 and an in-range index.  R is padded to a multiple of the
JAX package's row tile (a TPU tile, kept so the planes match; the kernel
never reads the pad rows).  The slot planes are column-major ELL:
neighbouring rows are neighbouring addresses in every plane.

Beside the planes, set-up stores what the kernel reads instead of the pad
slots (`DeviceLaneELL.__post_init__`): `row_len`, each row's count of
real slots (one plus its last nonzero-valued slot; uint8 where K ≤ 255,
else int32), and `idx16`, the packed index plane in 16 bits (the bits of
an unsigned 16-bit index, stored as int16) where (2S + 1)·128 ≤ 65,535,
else None.  Both derive from the planes alone, so planes converted from
the JAX package's (convert.lane_ell_from_numpy) and shard windows carry
them too.

`lane_ell_spmv` is the entry point: on a CUDA tensor it launches the
hand-written kernel (csrc/sparse_spmv.cu, the port of the JAX package's
Pallas `_lane_ell_kernel_call`) or raises, counting launches in
`lane_ell_spmv.launches`; on a CPU tensor it runs `lane_ell_spmv_plain`,
the JAX package's XLA form (slot by slot, ascending), which the kernel
follows bit for bit for finite x.  The kernel stops each row at its count,
on one of two routes (`route_for`, chosen by shape before the launch and
counted apart in `.idx16_launches` and `.idx32_launches`): "idx16" reads
the 16-bit indices, "idx32" (spans too wide for 16 bits) the int32 ones.
Skipping a pad slot adds nothing a finite x could change; a NaN or ±Inf
of x at a skipped slot's column, which the plain version carries into y
(0·Inf), does not reach y (a departure by design).
The values may be stored in bfloat16 beside float32 or float64 vectors
(matrix_dtype), widened before each product; that form's launches are
counted in `lane_ell_spmv.bf16_launches`.

`lane_ell_spmv_halo` is one mesh shard's SpMV (the JAX package's
lane_ell_spmv_halo, parallel/mesh_ops.mesh_lane_ell_spmv): the shard's own
planes (its index plane in 16 bits or int32) and an x window of S x2-rows
a side, with its plain version `lane_ell_spmv_halo_plain`.  Its route
(`halo_route_for`, by the launch's shape, counted in `.counted_launches`
and `.padded_launches`) stops each row at the shard's rows of `row_len`
where the launch fills the card, and else reads every slot.
`lane_ell_extend_rows` pads the planes with inert rows (count 0) so that
they cut into whole shards.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import kernel_suffix, serves_vectors, torch_dtype
from ..matrix import MatrixCSR
from ..stencil_op import resolve_device, sm_count

#: lanes per plane row
LANES = 128
#: the JAX package's default row tile, which sets the plane padding
_TB = 256
#: the largest packed index the 16-bit plane holds (unsigned 16 bits)
IDX16_MAX = 65535
#: the single-device kernel's routes (`route_for`)
ROUTES = ("idx16", "idx32")
#: the shard-local kernel's routes (`halo_route_for`)
HALO_ROUTES = ("counted", "padded")
#: blocks of 256 threads an SM holds at once (2048 threads)
_BLOCKS_PER_SM = 8


def lane_ell_row_len(vals: torch.Tensor) -> torch.Tensor:
    """(R, 128) count of each row's real slots: one plus its last slot
    whose value is nonzero (0 for a row of pads), uint8 where K ≤ 255,
    else int32."""
    K = vals.shape[0]
    n = torch.zeros(vals.shape[1:], dtype=torch.int32, device=vals.device)
    for k in range(K):
        n = torch.where(vals[k] != 0, k + 1, n)
    return n.to(torch.uint8) if K <= 255 else n


def lane_ell_idx16(idx: torch.Tensor, S: int) -> Optional[torch.Tensor]:
    """The packed index plane in 16 bits (int16 holding an unsigned
    16-bit index's bits) where every packed index (< (2S + 1)·128) fits,
    else None."""
    if (2 * S + 1) * LANES > IDX16_MAX:
        return None
    return torch.where(idx > 32767, idx - 65536, idx).to(torch.int16)


@dataclasses.dataclass
class DeviceLaneELL:
    """Lane-ELL storage (see the module docstring); `row_len` and
    `idx16` are derived from the planes at construction."""

    vals: torch.Tensor            # (K, R, 128)
    idx: torch.Tensor             # (K, R, 128) int32, packed (rowoff, lane)
    n_rows: int
    n_cols: int
    K: int
    S: int
    R: int
    row_len: torch.Tensor = dataclasses.field(init=False, repr=False)
    idx16: Optional[torch.Tensor] = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        self.row_len = lane_ell_row_len(self.vals)
        self.idx16 = lane_ell_idx16(self.idx, self.S)

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def nnz_stored(self) -> int:
        return self.vals.numel()


def lane_ell_row_tile(n: int, S: int) -> int:
    """The JAX package's row tile of an n-row matrix of span S: the planes'
    x2-rows are a multiple of it, and a mesh's shards whole tiles."""
    R = max(1, -(-n // LANES))
    return max(8 * -(-S // 8), min(_TB, 8 * -(-R // 8)), 8)


def lane_ell_span(A: MatrixCSR) -> int:
    """Max |j//128 − i//128| over the nonzeros: the shift radius S."""
    if A.nnz == 0:
        return 0
    from .. import _native
    stats = _native.csr_pattern_stats(A, cap=1)     # only the span
    if stats is not None:
        return stats[1]
    return int(np.abs(A.col.astype(np.int64) // LANES
                      - A.rows() // LANES).max())


def csr_to_lane_ell(A: MatrixCSR, dtype=torch.float32, *,
                    device="cuda") -> DeviceLaneELL:
    """The lane-ELL planes of A on `device`: each row's entries sorted by
    (rowoff, lane), pad slots pointing at their slot's lowest rowoff.  Two
    sweeps of the native host library where A's columns ascend strictly
    (the CSR order is then the slot order) unless BIS_TPU_NO_NATIVE is set,
    else the NumPy branch (a global lexsort and scatters), bit for bit."""
    if A.n_rows != A.n_cols:
        raise ValueError("lane-ELL requires a square matrix")
    device = resolve_device(device)
    n = A.n_rows
    R = max(1, -(-n // LANES))
    S = lane_ell_span(A)
    TB = lane_ell_row_tile(n, S)
    R_pad = -(-R // TB) * TB
    row_nnz = A.row_nnz()
    K = max(1, int(row_nnz.max()) if n else 1)
    from .. import _native
    from ..device_matrix import pack_dtype
    dtype = torch_dtype(dtype)
    built = _native.lane_ell_build(A, K, S, R_pad, pack_dtype(dtype))
    if built is not None:
        vals_np, idx, ranges = built
        vals = torch.from_numpy(vals_np).to(dtype)
        # the pad test reads the values rounded to the storage dtype, as
        # the NumPy branch's does; the pack tested the float64 value
        zero_idx = idx == 0
        if zero_idx.any():
            lo = np.array([r[0] for r in ranges], dtype=np.int64)
            idx = np.where((vals == 0).numpy() & zero_idx,
                           ((lo + S) * LANES).astype(np.int32)[:, None, None],
                           idx)
        return DeviceLaneELL(vals=vals.to(device),
                             idx=torch.from_numpy(idx).to(device), n_rows=n,
                             n_cols=n, K=K, S=S, R=R_pad)
    rows = A.rows()
    cols = A.col.astype(np.int64)
    rowoff = cols // LANES - rows // LANES
    lane = cols % LANES
    order = np.lexsort((lane, rowoff, rows))
    rows, rowoff, lane = rows[order], rowoff[order], lane[order]
    val_sorted = A.val[order]
    slot = np.arange(A.nnz, dtype=np.int64) - A.row_ptr[:-1][rows]
    vals64 = np.zeros((K, R_pad, LANES), dtype=np.float64)
    idx = np.zeros((K, R_pad, LANES), dtype=np.int32)
    r2, l2 = rows // LANES, rows % LANES
    vals64[slot, r2, l2] = val_sorted
    idx[slot, r2, l2] = ((rowoff + S) * LANES + lane).astype(np.int32)
    # rounded to the storage dtype (round to nearest even, as numpy's cast
    # in the JAX package) before the pad test reads it
    vals = torch.from_numpy(vals64).to(dtype)
    del vals64
    # pad slots point at their slot's lowest rowoff (0 for an empty slot)
    none = np.iinfo(np.int64).max
    lo = np.full(K, none, dtype=np.int64)
    np.minimum.at(lo, slot, rowoff)
    lo[lo == none] = 0
    idx = np.where((vals == 0).numpy() & (idx == 0),
                   ((lo + S) * LANES).astype(np.int32)[:, None, None], idx)
    return DeviceLaneELL(vals=vals.to(device),
                         idx=torch.from_numpy(idx).to(device), n_rows=n,
                         n_cols=n, K=K, S=S, R=R_pad)


# ---------------------------------------------------------------------------
# SpMV
# ---------------------------------------------------------------------------

def _check(M: DeviceLaneELL, x: torch.Tensor):
    if not isinstance(x, torch.Tensor):
        raise TypeError("x must be a torch.Tensor")
    if x.shape != (M.n_rows,):
        raise ValueError(f"x has shape {tuple(x.shape)}, expected "
                         f"({M.n_rows},)")
    if not serves_vectors(M.dtype, x.dtype):
        raise TypeError(f"x is {x.dtype}, the operator {M.dtype}")
    if x.device != M.device:
        raise ValueError(f"x is on {x.device}, the operator on {M.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")


def lane_ell_spmv_plain(M: DeviceLaneELL, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel (the JAX package's
    lane_ell_spmv_xla): per slot plane, in ascending order, the gathered x
    times the values, added to y."""
    _check(M, x)
    plane = M.R * LANES
    xf = torch.nn.functional.pad(x, (0, plane - M.n_rows))
    r = torch.arange(M.R, device=x.device).view(M.R, 1)
    y = torch.zeros((M.R, LANES), dtype=x.dtype, device=x.device)
    for k in range(M.K):
        p = M.idx[k].long()
        flat = ((r + p // LANES - M.S) * LANES + p % LANES).clamp(0,
                                                                  plane - 1)
        y = y + M.vals[k].to(x.dtype) * xf[flat]
    return y.reshape(-1)[:M.n_rows]


def route_for(M: DeviceLaneELL) -> str:
    """The kernel route for M: "idx16" where its packed indices fit 16
    bits (M.idx16 built), else "idx32"; both stop each row at its count.
    The planes' shape alone decides."""
    return "idx16" if M.idx16 is not None else "idx32"


def halo_route_for(entries: int, sms: int) -> str:
    """The route of a shard launch over `entries` rows (x2-rows·128) on a
    card of `sms` multiprocessors: "counted" (each row stopped at its
    count, as `lane_ell_spmv`) where its blocks of 256 threads fill every
    SM (8 resident blocks an SM), else "padded" (every slot).  A launch of
    a few blocks an SM is bound by latency, and there the padded loop,
    whose loads do not wait on the count's, ran faster on the H100 (an
    8-shard sband:500000,8,400: 256 blocks a launch).  The launch's shape
    and the card alone decide."""
    blocks = -(-entries // 256)
    return "counted" if blocks >= _BLOCKS_PER_SM * sms else "padded"


def _count(fn, route: str, bf16: bool):
    if bf16:
        fn.bf16_launches += 1
    else:
        fn.launches += 1
    setattr(fn, f"{route}_launches", getattr(fn, f"{route}_launches") + 1)


def _contiguous(*tensors):
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("the lane-ELL planes and counts must be "
                             "contiguous")


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error "
                           f"{err}")


def _lane_ell_spmv_cuda(M: DeviceLaneELL, x: torch.Tensor,
                        route: str) -> torch.Tensor:
    from .._build import launch, load_library
    if route == "idx16":
        if M.idx16 is None:
            raise ValueError("the idx16 route needs the 16-bit index plane")
        idx = M.idx16
    elif route == "idx32":
        idx = M.idx
    else:
        raise ValueError(f"unknown lane-ELL route {route!r}")
    _contiguous(M.vals, idx, M.row_len)
    y = torch.empty_like(x)
    fn = getattr(load_library(),
                 f"bis_lane_ell_spmv_{kernel_suffix(x.dtype, M.dtype)}")
    err = launch(fn, x.device, M.vals.data_ptr(), idx.data_ptr(),
                 M.row_len.data_ptr(), x.data_ptr(), y.data_ptr(), M.n_rows,
                 M.R * LANES, M.S, idx.element_size(),
                 M.row_len.element_size())
    _raise_on(err, "lane_ell_spmv")
    _count(lane_ell_spmv, route, M.dtype == torch.bfloat16)
    return y


def lane_ell_spmv(M: DeviceLaneELL, x: torch.Tensor) -> torch.Tensor:
    """y = M @ x.  A CUDA tensor goes through the hand-written kernel on
    `route_for(M)` (`lane_ell_spmv.launches` counts its launches,
    `lane_ell_spmv.bf16_launches` those of its bfloat16-data form, and
    `.idx16_launches`, `.idx32_launches` each route's); a CPU tensor takes
    the plain version."""
    _check(M, x)
    if x.device.type == "cuda":
        return _lane_ell_spmv_cuda(M, x, route_for(M))
    if x.device.type == "cpu":
        return lane_ell_spmv_plain(M, x)
    raise ValueError(f"no lane-ELL SpMV for device {x.device}")


lane_ell_spmv.launches = 0
lane_ell_spmv.bf16_launches = 0
lane_ell_spmv.idx16_launches = 0
lane_ell_spmv.idx32_launches = 0


# ---------------------------------------------------------------------------
# Shard-local form (a row-sharded mesh, parallel/mesh_ops.py)
# ---------------------------------------------------------------------------

def lane_ell_extend_rows(M: DeviceLaneELL, R_new: int) -> DeviceLaneELL:
    """M with its planes padded to R_new x2-rows of inert rows (value 0,
    each slot's index in range: rowoff 0, lane 0; count 0), so that they
    cut into a mesh's shards; y is 0 on those rows."""
    if R_new == M.R:
        return M
    if R_new < M.R or R_new % lane_ell_row_tile(M.n_rows, M.S):
        raise ValueError(f"bad extension {M.R} -> {R_new}")
    pad = R_new - M.R
    vals = torch.cat([M.vals, M.vals.new_zeros((M.K, pad, LANES))], dim=1)
    idx = torch.cat([M.idx, M.idx.new_full((M.K, pad, LANES),
                                           M.S * LANES)], dim=1)
    return dataclasses.replace(M, vals=vals, idx=idx, R=R_new)


def _check_halo(M: DeviceLaneELL, vals, idx, xw, r0: int, halo: int,
                out) -> int:
    """Check a shard's operands; returns its entry count rows·128."""
    if vals.dim() != 3 or vals.shape[0] != M.K or vals.shape[2] != LANES \
            or idx.shape != vals.shape \
            or idx.dtype not in (torch.int32, torch.int16):
        raise ValueError("the shard's planes must be (K, rows, 128), the "
                         "indices int32 or 16-bit (int16)")
    rows = vals.shape[1]
    if halo < M.S or r0 < 0 or r0 + rows > M.R:
        raise ValueError(f"shard rows [{r0}, {r0 + rows}) with halo {halo} "
                         f"(span {M.S}) do not fit {M.R} x2-rows")
    if not isinstance(xw, torch.Tensor) or xw.shape != (
            (rows + 2 * halo) * LANES,):
        raise ValueError(f"the window must be ({(rows + 2 * halo) * LANES},)")
    if not serves_vectors(vals.dtype, xw.dtype):
        raise TypeError(f"xw is {xw.dtype}, the values {vals.dtype}")
    for t in (vals, idx, xw):
        if t.device != xw.device or not t.is_contiguous():
            raise ValueError("the planes and the window must be contiguous, "
                             "on one device")
    if out is not None and (out.shape != (rows * LANES,)
                            or out.dtype != xw.dtype
                            or out.device != xw.device
                            or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous ({rows * LANES},) "
                         f"{xw.dtype} tensor on {xw.device}")
    return rows * LANES


def lane_ell_spmv_halo_plain(M: DeviceLaneELL, vals: torch.Tensor,
                             idx: torch.Tensor, xw: torch.Tensor, r0: int,
                             halo: int) -> torch.Tensor:
    """Plain PyTorch version of the shard-local kernel: the shard's x2-rows
    [r0, r0 + rows) of M·x from its window xw (halo x2-rows a side), each
    slot's global column clipped into the planes and read as 0 past n as
    in the single-device plain version, then found in the window."""
    _check_halo(M, vals, idx, xw, r0, halo, None)
    rows = vals.shape[1]
    plane = M.R * LANES
    r = (r0 + torch.arange(rows, device=xw.device)).view(rows, 1)
    # a 16-bit plane holds an unsigned index's bits
    p = idx.long() & 0xFFFF if idx.dtype == torch.int16 else idx.long()
    flat = ((r + p // LANES - M.S) * LANES + p % LANES).clamp(0, plane - 1)
    xv = torch.where(flat < M.n_rows, xw[flat - (r0 - halo) * LANES], 0.0)
    prods = vals.to(xw.dtype) * xv            # every slot's product at once
    y = torch.zeros((rows, LANES), dtype=xw.dtype, device=xw.device)
    for k in range(M.K):                      # summed slot by slot
        y = y + prods[k]
    return y.reshape(-1)


def lane_ell_spmv_halo(M: DeviceLaneELL, vals: torch.Tensor,
                       idx: torch.Tensor, xw: torch.Tensor, r0: int,
                       halo: int, out: torch.Tensor = None,
                       lens: torch.Tensor = None) -> torch.Tensor:
    """One mesh shard's lane-ELL SpMV: `lane_ell_spmv_halo_plain`'s
    contract (M the whole, row-extended operator; vals/idx the shard's
    (K, rows, 128) planes starting at x2-row r0, idx int32 or M's 16-bit
    plane's rows), y written to `out` when given.  A CUDA tensor launches
    the shard-local kernel (csrc/sparse_spmv.cu) on `halo_route_for`'s
    route, reading the indices at idx's width and, on the counted route,
    the shard's rows of M.row_len (`lens`, a copy on the shard's device,
    where given), counted in `lane_ell_spmv_halo.launches`
    (`.bf16_launches` for bfloat16 values; each route's in
    `.counted_launches`, `.padded_launches`): every slot reads the value
    the single-device kernel reads, so y is bit-equal to its rows; a CPU
    tensor takes the plain version (a meta tensor its shapes)."""
    if isinstance(xw, torch.Tensor) and xw.device.type == "cuda":
        return _lane_ell_spmv_halo_cuda(M, vals, idx, xw, r0, halo, out,
                                        lens=lens)
    _check_halo(M, vals, idx, xw, r0, halo, out)
    if xw.device.type not in ("cpu", "meta"):
        raise ValueError(f"no lane-ELL SpMV for device {xw.device}")
    y = lane_ell_spmv_halo_plain(M, vals, idx, xw, r0, halo)
    return y if out is None else out.copy_(y)


def _lane_ell_spmv_halo_cuda(M, vals, idx, xw, r0, halo, out, route=None,
                             lens=None):
    """The kernel on `route` (`halo_route_for`'s where None)."""
    from .._build import launch, load_library
    n = _check_halo(M, vals, idx, xw, r0, halo, out)
    if route is None:
        route = halo_route_for(n, sm_count(xw.device.index))
    y = torch.empty(n, dtype=xw.dtype, device=xw.device) \
        if out is None else out
    name = "bis_lane_ell_spmv_halo_" + kernel_suffix(xw.dtype, vals.dtype)
    if route == "padded":
        err = launch(
            getattr(load_library(), name + "_padded"), xw.device,
            vals.data_ptr(), idx.data_ptr(), xw.data_ptr(), y.data_ptr(), n,
            r0, halo, M.n_rows, M.R * LANES, M.K, M.S, xw.numel(),
            idx.element_size())
    elif route == "counted":
        if lens is None:
            lens = M.row_len[r0:r0 + vals.shape[1]]
        if lens.device != xw.device:
            raise ValueError("the counts must be on the window's device")
        _contiguous(lens)
        err = launch(
            getattr(load_library(), name), xw.device, vals.data_ptr(),
            idx.data_ptr(), lens.data_ptr(), xw.data_ptr(), y.data_ptr(), n,
            r0, halo, M.n_rows, M.R * LANES, M.S, xw.numel(),
            idx.element_size(), lens.element_size())
    else:
        raise ValueError(f"unknown lane-ELL halo route {route!r}")
    _raise_on(err, "lane_ell_spmv_halo")
    _count(lane_ell_spmv_halo, route, vals.dtype == torch.bfloat16)
    return y


lane_ell_spmv_halo.launches = 0
lane_ell_spmv_halo.bf16_launches = 0
lane_ell_spmv_halo.counted_launches = 0
lane_ell_spmv_halo.padded_launches = 0
