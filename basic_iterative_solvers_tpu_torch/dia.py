"""DIA set-up on the device: the structural factorization and the
generators.

In DIA form the diagonal peel is the offset-0 data row, the L/U split two
slices of the data rows (offsets are sorted), and symmetric diagonal
scaling a product with shifted scale vectors: no host pass at all.  The
generator matrices (HPCG 27-point, FDM, Anderson, banded) are built
straight on the device with torch, each diagonal a closed-form function of
the row index; the random values (Anderson's on-site energies, the band's
entries) come from numpy's generator, as in the host generators, so both
builders give the same matrix.  The JAX package's dia.py, with its TPU
row-tile padding left out.
"""
from __future__ import annotations

import re
from typing import Dict, List, Tuple

import numpy as np
import torch

from .config import torch_dtype
from .device_matrix import DeviceDIA
from .stencil_op import resolve_device


def dia_diag(A: DeviceDIA) -> torch.Tensor:
    """The matrix diagonal (n,); a missing offset-0 diagonal raises."""
    if 0 not in A.offsets:
        raise ValueError("matrix has no stored main diagonal")
    return A.data[A.offsets.index(0)]


def dia_split(A: DeviceDIA) -> Tuple[DeviceDIA, DeviceDIA, torch.Tensor,
                                     torch.Tensor]:
    """(L_strict, U_strict, D, D_inv) by slicing the data rows; a zero on
    the diagonal raises."""
    offs = A.offsets
    if 0 not in offs:
        raise ValueError("matrix has no stored main diagonal")
    k0 = offs.index(0)
    D = A.data[k0]
    if bool((D == 0).any()):
        raise ValueError("zero on the matrix diagonal")
    L = DeviceDIA(data=A.data[:k0], offsets=offs[:k0], n_rows=A.n_rows,
                  n_cols=A.n_cols)
    U = DeviceDIA(data=A.data[k0 + 1:], offsets=offs[k0 + 1:],
                  n_rows=A.n_rows, n_cols=A.n_cols)
    return L, U, D, 1.0 / D


def dia_extract_scale(A: DeviceDIA) -> torch.Tensor:
    """scale[i] = 1/sqrt(|a_ii|)."""
    return 1.0 / torch.sqrt(torch.abs(dia_diag(A)))


def dia_scale(A: DeviceDIA, s: torch.Tensor) -> DeviceDIA:
    """A' = diag(s)·A·diag(s): data'[d, i] = data[d, i]·s[i]·s[i + off_d]
    (s read as 0 out of range)."""
    n = A.n_rows
    s = s.to(A.dtype)
    hneg = max(0, -min(A.offsets)) if A.offsets else 0
    hpos = max(0, max(A.offsets)) if A.offsets else 0
    sp = torch.nn.functional.pad(s, (hneg, hpos))
    rows = [A.data[d] * s * sp[hneg + off:hneg + off + n]
            for d, off in enumerate(A.offsets)]
    data = torch.stack(rows) if rows else A.data.clone()
    return DeviceDIA(data=data, offsets=A.offsets, n_rows=n, n_cols=A.n_cols)


# ---------------------------------------------------------------------------
# Device-side generators
# ---------------------------------------------------------------------------

def _axis_count(d: int, L: int, kind) -> int:
    if kind == "wrap":
        return min(abs(d), L)
    if kind == "all":
        return L
    return L - abs(d)


def _stencil_dia(nx: int, ny: int, nz: int, entries, dtype, device,
                 periodic: bool = False) -> DeviceDIA:
    """A 3-D stencil `entries` = [((dx, dy, dz), value)] as DIA, built on
    `device`.  Legs are grouped by linear offset (wrap-corrected when
    periodic) and their masked contributions summed in leg order; legs that
    reach no row are dropped, so the offsets are those the host CSR
    pipeline finds."""
    n = nx * ny * nz
    groups: Dict[int, List] = {}
    for (dx, dy, dz), v in entries:
        if periodic:
            parts = []
            for d, L in zip((dx, dy, dz), (nx, ny, nz)):
                parts.append([(0, "all")] if d == 0 else
                             [(d, "in"), (d - int(np.sign(d)) * L, "wrap")])
            for px, kx in parts[0]:
                for py, ky in parts[1]:
                    for pz, kz in parts[2]:
                        if (_axis_count(dx, nx, kx) * _axis_count(dy, ny, ky)
                                * _axis_count(dz, nz, kz)) <= 0:
                            continue
                        groups.setdefault(px + nx * (py + ny * pz), []).append(
                            ((dx, dy, dz), (kx, ky, kz), v))
        elif (nx - abs(dx)) * (ny - abs(dy)) * (nz - abs(dz)) > 0:
            groups.setdefault(dx + nx * (dy + ny * dz), []).append(
                ((dx, dy, dz), None, v))
    offsets = tuple(sorted(groups))
    i = torch.arange(n, dtype=torch.int64, device=device)
    x, y, z = i % nx, (i // nx) % ny, i // (nx * ny)
    del i
    data = torch.empty((len(offsets), n), dtype=dtype, device=device)
    zero = torch.zeros((), dtype=dtype, device=device)
    for k, off in enumerate(offsets):
        acc = torch.zeros(n, dtype=dtype, device=device)
        for (dx, dy, dz), kinds, v in groups[off]:
            m = torch.ones(n, dtype=torch.bool, device=device)
            for c, d, L, kind in ((x, dx, nx, kinds and kinds[0]),
                                  (y, dy, ny, kinds and kinds[1]),
                                  (z, dz, nz, kinds and kinds[2])):
                if kind == "all" or (kind is None and d == 0):
                    continue
                if kind == "wrap":
                    m &= (c + d < 0) | (c + d >= L)
                else:
                    m &= (c + d >= 0) & (c + d < L)
            acc = acc + torch.where(m, torch.tensor(v, dtype=dtype,
                                                    device=device), zero)
        data[k] = acc
    return DeviceDIA(data=data, offsets=offsets, n_rows=n, n_cols=n)


def stencil_27pt_device(nx: int, ny: int = None, nz: int = None,
                        diag: float = 26.0, off: float = -1.0,
                        dtype=torch.float32, *, device="cuda") -> DeviceDIA:
    """HPCG 27-point stencil (generators.stencil_27pt) on `device`."""
    ny = nx if ny is None else ny
    nz = nx if nz is None else nz
    entries = [((dx, dy, dz), diag if (dx, dy, dz) == (0, 0, 0) else off)
               for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    return _stencil_dia(nx, ny, nz, entries, torch_dtype(dtype),
                        resolve_device(device))


def fdm_2d_device(nx: int, diag: float = -4.0, off: float = 1.0,
                  dtype=torch.float32, *, device="cuda") -> DeviceDIA:
    """2-D 5-point FDM Laplacian (generators.fdm_2d) on `device`."""
    entries = [((0, 0, 0), diag)] + [
        ((dx, dy, 0), off) for (dx, dy) in ((-1, 0), (1, 0), (0, -1),
                                            (0, 1))]
    return _stencil_dia(nx, nx, 1, entries, torch_dtype(dtype),
                        resolve_device(device))


def anderson_device(Lx: int, Ly: int = None, Lz: int = None, t: float = 1.0,
                    ranpot: float = 0.0, seed: int = 1,
                    boundary: str = "open", dtype=torch.float32, *,
                    device="cuda") -> DeviceDIA:
    """3-D Anderson model (generators.anderson): hopping built on `device`,
    the on-site energies from numpy's default_rng(seed) as the host
    generator draws them."""
    Ly = Lx if Ly is None else Ly
    Lz = Lx if Lz is None else Lz
    n = Lx * Ly * Lz
    device = resolve_device(device)
    dtype = torch_dtype(dtype)
    entries = [((dx, dy, dz), -t)
               for (dx, dy, dz) in ((-1, 0, 0), (1, 0, 0), (0, -1, 0),
                                    (0, 1, 0), (0, 0, -1), (0, 0, 1))]
    A = _stencil_dia(Lx, Ly, Lz, entries + [((0, 0, 0), 0.0)], dtype, device,
                     periodic=(boundary == "periodic"))
    eps = np.random.default_rng(seed).uniform(-ranpot / 2.0, ranpot / 2.0,
                                              size=n)
    A.data[A.offsets.index(0)] = torch.from_numpy(eps).to(dtype=dtype,
                                                           device=device)
    return A


def banded_device(n: int, bandwidth: int = 2, seed: int = 0,
                  diag_boost: float = None, dtype=torch.float32, *,
                  device="cuda") -> DeviceDIA:
    """Random banded matrix (generators.banded), the same numpy draws."""
    rng = np.random.default_rng(seed)
    offsets = tuple(range(-bandwidth, bandwidth + 1))
    data = np.zeros((len(offsets), n), dtype=np.float64)
    for d, off in enumerate(offsets):
        m = n - abs(off)
        vals = rng.uniform(-1.0, 1.0, size=m)
        if off == 0:
            boost = (diag_boost if diag_boost is not None
                     else 2.0 * bandwidth + 1.0)
            vals = vals + np.sign(vals + (vals == 0)) * boost
        data[d, max(0, -off):max(0, -off) + m] = vals
    return DeviceDIA(data=torch.from_numpy(data).to(
        dtype=torch_dtype(dtype), device=resolve_device(device)),
        offsets=offsets, n_rows=n, n_cols=n)


_GEN_RE = re.compile(r"^(scamac|hpcg|fdm|band|anderson):(.*)$",
                     re.IGNORECASE)


def from_source_device(source: str, dtype=torch.float32, *,
                       device="cuda") -> DeviceDIA:
    """The DIA operator of a generator spec (hpcg:, fdm:, band:, scamac:
    Anderson, anderson:) built on `device`, the card unless the caller asks
    for the CPU.  .mtx files go through the host CSR pipeline."""
    from .generators import _dims, _parse_anderson_kwargs
    m = _GEN_RE.match(source)
    if not m:
        raise ValueError(f"not a generator spec: {source}")
    kind, spec = m.group(1).lower(), m.group(2)
    if kind in ("scamac", "anderson"):
        return anderson_device(dtype=dtype, device=device,
                               **_parse_anderson_kwargs(spec))
    if kind == "hpcg":
        return stencil_27pt_device(*_dims(spec), dtype=dtype, device=device)
    if kind == "fdm":
        return fdm_2d_device(int(spec), dtype=dtype, device=device)
    return banded_device(*_dims(spec), dtype=dtype, device=device)
