"""Geometric multigrid preconditioner for matrix-free stencil operators
(`-p mg`), the JAX package's mg.py.

* Hierarchy: each coarse level is another constant-coefficient
  `DeviceStencil` on the vertex-centred (d + 1) // 2 grid, so every level's
  SpMV is the stencil kernel (#1, or #2 with `stencil_op.STREAM`).
* Transfers: coarse point c sits on fine point 2c.  "linear": trilinear
  prolongation and its exact transpose, full-weighting restriction
  (R = Pᵀ); "injection": scatter/sample only (HPCG's scheme).  Both are
  three small dense contractions per direction (one per axis), which the
  JAX package leaves to XLA's einsum outside any Pallas kernel; here they
  are `torch.matmul`s with the same matrices.
* Coarse operator: "galerkin" reads the interior stencil of PᵀAP off a
  NumPy probe; "rediscretize" reuses the fine coefficients.
* Smoother: the Chebyshev semi-iteration of `-p cheby` from a nonzero
  initial iterate; the coarsest level runs it over a wide interval as its
  solve.  Symmetric, so the V-cycle is a valid CG preconditioner.

The port has no planar layout: every level's vectors are flat, so the JAX
package's `_between` is the flat transfer itself.  The Chebyshev scalars
(θ, and per step ρ'ρ and 2ρ'/δ) are 0-d tensors of the vector dtype,
computed as the JAX recurrence computes them, once per level and
(degree, ratio), and kept on the vectors' device.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from .ops.spmv import spmv
from .stencil_op import DeviceStencil, make_stencil, stencil_diag_vec


@dataclasses.dataclass
class MGLevel:
    """One grid level: operator, Jacobi scaling, Chebyshev interval top."""

    A: DeviceStencil
    D_inv: torch.Tensor       # (n,), vector dtype
    lmax: torch.Tensor        # 0-d: an upper bound on λmax(D⁻¹A)
    _schedules: dict = dataclasses.field(default_factory=dict, repr=False,
                                         compare=False)


# ---------------------------------------------------------------------------
# Transfers (flat (n,) <-> flat (n_c,) on the x-fastest grid ordering)
# ---------------------------------------------------------------------------

def coarse_dims(dims) -> Tuple[int, int, int]:
    """Vertex-centred coarsening: a d-point axis keeps ceil(d/2) points
    (size-1 axes stay 1)."""
    return tuple(1 if d == 1 else (d + 1) // 2 for d in dims)


def _axis_transfer_matrix(nf: int, nc: int, transfer: str) -> np.ndarray:
    """(nf, nc) one-axis restriction matrix: R[2c, c] = 1 and, for
    "linear", R[2c±1, c] = 1/2 (conv([1/2, 1, 1/2]) then even sampling).
    Prolongation along the axis is its transpose."""
    R = np.zeros((nf, nc), dtype=np.float64)
    for c in range(nc):
        R[2 * c, c] = 1.0
        if transfer == "linear":
            if 2 * c - 1 >= 0:
                R[2 * c - 1, c] = 0.5
            if 2 * c + 1 < nf:
                R[2 * c + 1, c] = 0.5
    return R


@functools.lru_cache(maxsize=64)
def _transfer_mats(fdims, cdims, transfer, dtype, device):
    """(Rx, Ry, Rz) on `device` in `dtype`, each (nf, nc)."""
    return tuple(torch.from_numpy(_axis_transfer_matrix(nf, nc, transfer))
                 .to(dtype=dtype, device=device)
                 for nf, nc in zip(fdims, cdims))


def _tensor_transfer(v: torch.Tensor, fdims, cdims, transfer: str,
                     up: bool) -> torch.Tensor:
    nxf, nyf, nzf = fdims
    nxc, nyc, nzc = cdims
    Rx, Ry, Rz = _transfer_mats(tuple(fdims), tuple(cdims), transfer,
                                v.dtype, v.device)
    if up:
        z3 = v.reshape(nzc, nyc, nxc) @ Rx.T             # (nzc, nyc, nxf)
        z3 = Ry @ z3                                     # (nzc, nyf, nxf)
        return (Rz @ z3.reshape(nzc, nyf * nxf)).reshape(nxf * nyf * nzf)
    r3 = v.reshape(nzf, nyf, nxf) @ Rx                   # (nzf, nyf, nxc)
    r3 = Ry.T @ r3                                       # (nzf, nyc, nxc)
    return (Rz.T @ r3.reshape(nzf, nyc * nxc)).reshape(nxc * nyc * nzc)


def restrict_flat(rf: torch.Tensor, fdims, cdims, transfer: str
                  ) -> torch.Tensor:
    """r_c = R r_f (flat vectors, fdims/cdims = (nx, ny, nz))."""
    return _tensor_transfer(rf, fdims, cdims, transfer, False)


def prolong_flat(zc: torch.Tensor, fdims, cdims, transfer: str
                 ) -> torch.Tensor:
    """z_f = P z_c = Rᵀ z_c (flat vectors)."""
    return _tensor_transfer(zc, fdims, cdims, transfer, True)


# ---------------------------------------------------------------------------
# Galerkin coarse stencil via a NumPy probe (the JAX package's, copied)
# ---------------------------------------------------------------------------

def _np_apply(legs_coeffs, x3):
    """y = A x for a constant stencil on an open-boundary grid (numpy)."""
    nz, ny, nx = x3.shape
    y = np.zeros_like(x3)

    def sl(d, n):
        return (slice(max(0, -d), n - max(0, d)),
                slice(max(0, d), n - max(0, -d)))

    for (dx, dy, dz), c in legs_coeffs:
        if abs(dx) >= nx or abs(dy) >= ny or abs(dz) >= nz:
            continue
        (zd, zs), (yd, ys), (xd, xs) = sl(dz, nz), sl(dy, ny), sl(dx, nx)
        y[zd, yd, xd] += c * x3[zs, ys, xs]
    return y


def _np_conv_axis(a, axis):
    if a.shape[axis] == 1:
        return a
    pad = [(0, 0)] * a.ndim
    pad[axis] = (1, 1)
    p = np.pad(a, pad)
    n = a.shape[axis]
    lo = p.take(range(0, n), axis=axis)
    hi = p.take(range(2, n + 2), axis=axis)
    return a + 0.5 * (lo + hi)


def _np_restrict(r3, transfer):
    if transfer == "linear":
        for ax in range(3):
            r3 = _np_conv_axis(r3, ax)
    return r3[::2, ::2, ::2]


def _np_prolong(z3, fshape, transfer):
    f = np.zeros(fshape, dtype=z3.dtype)
    f[::2, ::2, ::2] = z3
    if transfer == "linear":
        for ax in range(3):
            f = _np_conv_axis(f, ax)
    return f


def galerkin_coarse_coeffs(legs_coeffs, dims, transfer: str):
    """Interior stencil of PᵀAP as [((dx, dy, dz), c), ...], read off a
    probe grid sized from the stencil's reach so that no boundary mask is
    touched; `dims` only marks the degenerate (size-1) axes.  Entries
    below 1e-12 of the largest are dropped, as in the JAX package, so the
    coarse leg sets match."""
    p = 1 if transfer == "linear" else 0
    reach = [0, 0, 0]
    for (dx, dy, dz), _ in legs_coeffs:
        reach = [max(reach[0], abs(dx)), max(reach[1], abs(dy)),
                 max(reach[2], abs(dz))]
    m = [r + 2 * p for r in reach]
    nf = [1 if d == 1 else 4 * mm + 5 for mm, d in zip(m, dims)]
    nc = [1 if d == 1 else 2 * mm + 3 for mm, d in zip(m, dims)]
    c0 = [0 if d == 1 else mm + 1 for mm, d in zip(m, dims)]
    ec = np.zeros((nc[2], nc[1], nc[0]))
    ec[c0[2], c0[1], c0[0]] = 1.0
    zf = _np_prolong(ec, (nf[2], nf[1], nf[0]), transfer)
    yf = _np_apply(legs_coeffs, zf)
    wc = _np_restrict(yf, transfer)
    tol = 1e-12 * max(1.0, np.abs(wc).max())
    out = []
    for dz in range(-(nc[2] // 2), nc[2] // 2 + 1):
        for dy in range(-(nc[1] // 2), nc[1] // 2 + 1):
            for dx in range(-(nc[0] // 2), nc[0] // 2 + 1):
                v = wc[c0[2] + dz, c0[1] + dy, c0[0] + dx]
                if abs(v) > tol:
                    out.append(((dx, dy, dz), float(v)))
    return out


# ---------------------------------------------------------------------------
# Hierarchy set-up
# ---------------------------------------------------------------------------

def gershgorin_lmax(legs_coeffs, dtype, device="cpu") -> torch.Tensor:
    """Gershgorin upper bound on λmax(D⁻¹A) for a constant stencil,
    1 + Σ|off-diagonal|/|diagonal|, as a 0-d tensor of `dtype`."""
    diag = 0.0
    off = 0.0
    for (dx, dy, dz), c in legs_coeffs:
        if dx == 0 and dy == 0 and dz == 0:
            diag += c
        else:
            off += abs(c)
    if diag == 0:
        raise ValueError("zero diagonal coefficient in the coarse stencil")
    return torch.tensor(1.0 + off / abs(diag), dtype=dtype, device=device)


def _auto_n_levels(dims) -> int:
    n = 1
    d = dims
    while min(x for x in coarse_dims(d) if x > 1) >= 8 and n < 8:
        d = coarse_dims(d)
        n += 1
    return n


def build_mg_hierarchy(A_dev, config) -> Tuple[MGLevel, ...]:
    """The level tuple of `-p mg`, refusing in the JAX package's order and
    with its exception types what multigrid cannot serve (another operator
    type, a dense diagonal, unknown options, Galerkin with injection)."""
    if not isinstance(A_dev, DeviceStencil):
        raise ValueError(
            "multigrid requires the matrix-free stencil operator "
            "(matrix_format='stencil', generator sources hpcg:/fdm:); "
            f"got {type(A_dev).__name__}")
    if A_dev.diag is not None:
        raise ValueError(
            "multigrid needs constant coefficients to build coarse "
            "operators; this stencil carries a dense diagonal (Anderson "
            "random potential) — use '-p cheby' instead")
    if A_dev.shards != 1:
        raise ValueError("multigrid is not yet mesh-shardable; build the "
                         "hierarchy before shard_setup or use '-p cheby'")
    transfer = config.mg_transfer
    if transfer not in ("linear", "injection"):
        raise ValueError(f"unknown mg_transfer: {transfer!r}")
    coarse_op = config.mg_coarse_op
    if coarse_op == "auto":
        coarse_op = "galerkin" if transfer == "linear" else "rediscretize"
    if coarse_op not in ("galerkin", "rediscretize"):
        raise ValueError(f"unknown mg_coarse_op: {coarse_op!r}")
    if coarse_op == "galerkin" and transfer == "injection":
        raise ValueError("Galerkin with injection transfers degenerates to "
                         "a diagonal coarse operator; use "
                         "mg_transfer='linear' or mg_coarse_op="
                         "'rediscretize'")
    n_levels = config.mg_levels or _auto_n_levels(A_dev.dims)
    if n_levels < 1:
        raise ValueError("mg_levels must be >= 1")

    dtype = config.spec_dtype()
    levels = []
    A_l = A_dev
    legs_coeffs = list(zip(A_dev.legs, A_dev.coeff_values))
    dims = A_dev.dims
    for l in range(n_levels):
        D = stencil_diag_vec(A_l)
        if bool((D == 0).any()):
            raise ValueError("zero on the matrix diagonal")
        D_inv = (1.0 / D).to(dtype)
        # Gershgorin's upper bound, never a power-iteration under-estimate:
        # the high-degree coarse polynomial explodes above its interval
        lmax = gershgorin_lmax(legs_coeffs, dtype, A_dev.device)
        levels.append(MGLevel(A=A_l, D_inv=D_inv, lmax=lmax))
        if l + 1 == n_levels:
            break
        cdims = coarse_dims(dims)
        if max(cdims) < 2:
            break   # nothing left to coarsen
        if coarse_op == "galerkin":
            legs_coeffs = galerkin_coarse_coeffs(legs_coeffs, dims, transfer)
        dims = cdims
        A_l = make_stencil(legs_coeffs, *dims, dtype=A_dev.dtype,
                           device=A_dev.device)
    return tuple(levels)


# ---------------------------------------------------------------------------
# Apply: V(ν, ν) cycle with Chebyshev smoothing
# ---------------------------------------------------------------------------

def cheby_schedule(lmax: torch.Tensor, ratio: float, degree: int, dtype,
                   device):
    """(θ, ((ρ'ρ, 2ρ'/δ), ...)) of a degree-`degree` Chebyshev
    semi-iteration over [lmax/ratio, lmax]: 0-d tensors of `dtype` on
    `device`, computed in the JAX recurrence's order and dtype (on the
    host, where dividing by a Python scalar is a true division)."""
    lmax = lmax.detach().to(device="cpu", dtype=dtype)
    lmin = lmax / ratio
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta
    rho = 1.0 / sigma
    steps = []
    for _ in range(max(1, degree) - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        steps.append((rho_new * rho, 2.0 * rho_new / delta))
        rho = rho_new
    to = lambda t: t.to(device)  # noqa: E731
    return to(theta), tuple((to(a), to(b)) for a, b in steps)


def cheby_steps(A, dinv: torch.Tensor, y: torch.Tensor, z0, schedule):
    """The Chebyshev recurrence toward A z = y from z0 (None = zero):
    z − z0 = p(D⁻¹A) D⁻¹ (y − A z0)."""
    theta, steps = schedule
    if z0 is None:
        resid, z = y, None
    else:
        z = z0
        resid = y - spmv(A, z)
    d = (dinv * resid) / theta
    z = d if z is None else z + d
    for c_d, c_r in steps:
        resid = y - spmv(A, z)
        d = torch.addcmul(c_d * d, c_r, dinv * resid)
        z = z + d
    return z


def cached_schedule(cache: dict, lmax, ratio: float, degree: int, y):
    """cheby_schedule for y's dtype and device, kept in `cache` (the
    owner's: a level or a preconditioner) after the first call."""
    key = (float(ratio), int(degree), y.dtype, y.device)
    if key not in cache:
        cache[key] = cheby_schedule(lmax, ratio, degree, y.dtype, y.device)
    return cache[key]


def _cheby_smooth(lev: MGLevel, y, z0, degree: int, ratio: float):
    """`degree` Chebyshev steps toward A z = y from z0 (None = zero)."""
    return cheby_steps(lev.A, lev.D_inv, y, z0, cached_schedule(
        lev._schedules, lev.lmax, ratio, degree, y))


def mg_vcycle(levels: Tuple[MGLevel, ...], y: torch.Tensor,
              smooth_degree: int, coarse_degree: int, ratio: float,
              coarse_ratio: float, transfer: str, _l: int = 0
              ) -> torch.Tensor:
    """z = M⁻¹ y: one V(ν, ν) cycle.  `ratio` bounds the smoothing
    interval [lmax/ratio, lmax]; the coarsest level's Chebyshev solve
    covers the wide `coarse_ratio` interval instead."""
    lev = levels[_l]
    if _l == len(levels) - 1:
        return _cheby_smooth(lev, y, None, coarse_degree, coarse_ratio)
    z = _cheby_smooth(lev, y, None, smooth_degree, ratio)
    resid = y - spmv(lev.A, z)
    nxt = levels[_l + 1].A
    rc = restrict_flat(resid, lev.A.dims, nxt.dims, transfer)
    zc = mg_vcycle(levels, rc, smooth_degree, coarse_degree, ratio,
                   coarse_ratio, transfer, _l=_l + 1)
    z = z + prolong_flat(zc, lev.A.dims, nxt.dims, transfer)
    return _cheby_smooth(lev, y, z, smooth_degree, ratio)


def estimated_vcycle_passes(levels, smooth_degree: int,
                            coarse_degree: int) -> float:
    """Vector passes per apply, summed over levels with their size ratios
    (the JAX package's roofline estimate: ~4 passes at the finer level's
    size for a restrict + prolong pair)."""
    n0 = max(1, levels[0].A.n_rows)
    total = 0.0
    for l, lev in enumerate(levels):
        ratio = lev.A.n_rows / n0
        last = l == len(levels) - 1
        if last:
            smooth = 3.0 + 6.0 * max(0, coarse_degree - 1)
        else:
            smooth = 2.0 * (3.0 + 6.0 * max(0, smooth_degree - 1))
            smooth += 3.0 + 4.0          # residual + transfer pair
        total += ratio * smooth
    return total
