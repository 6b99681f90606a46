"""Matrix generators and matrix sources, on the host.

The NumPy branches of the JAX package's generators.py (the JAX package's
native fast paths are bit-equal to them): `stencil_27pt` (HPCG), `anderson`,
`fdm_2d`, `banded`, `scattered_band` and the SCAMAC models
`free_fermion_chain`, `hubbard` and `spin_chain_xxz`, each as a
column-sorted `MatrixCSR`.  `from_source` resolves a generator spec or a
.mtx path; `color_spec_for_source` gives a spec's structural colouring and
`device_buildable` says whether a spec has an on-device builder
(dia.from_source_device, stencil_op.from_source_operator).
"""
from __future__ import annotations

import re

import numpy as np

from .matrix import MatrixCOO, MatrixCSR, convert_coo_to_csr


def stencil_27pt(nx: int, ny: int = None, nz: int = None,
                 diag: float = 26.0, off: float = -1.0) -> MatrixCSR:
    """HPCG 27-point stencil on an nx×ny×nz grid (open boundary), built
    column-sorted: the linear offsets in (dz, dy, dx)-ascending order are
    ascending."""
    ny = nx if ny is None else ny
    nz = nx if nz is None else nz
    n = nx * ny * nz
    Zg, Yg, Xg = np.meshgrid(np.arange(nz, dtype=np.int32),
                             np.arange(ny, dtype=np.int32),
                             np.arange(nx, dtype=np.int32), indexing="ij")
    Xr, Yr, Zr = Xg.ravel(), Yg.ravel(), Zg.ravel()
    stencil = [(dx, dy, dz)
               for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    masks = [((Xr + dx >= 0) & (Xr + dx < nx) & (Yr + dy >= 0)
              & (Yr + dy < ny) & (Zr + dz >= 0) & (Zr + dz < nz))
             for (dx, dy, dz) in stencil]
    counts = np.zeros(n, dtype=np.int64)
    for m in masks:
        counts += m
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    nnz = int(row_ptr[-1])
    col = np.empty(nnz, dtype=np.int32)
    val = np.empty(nnz, dtype=np.float64)
    acc = np.zeros(n, dtype=np.int64)
    rows_all = np.arange(n, dtype=np.int64)
    for (dx, dy, dz), m in zip(stencil, masks):
        rows = rows_all[m]
        pos = row_ptr[rows] + acc[rows]
        col[pos] = (rows + dx + nx * (dy + ny * dz)).astype(np.int32)
        val[pos] = diag if (dx, dy, dz) == (0, 0, 0) else off
        acc[rows] += 1
    return MatrixCSR(n, n, nnz, row_ptr, col, val)


def anderson(Lx: int, Ly: int = None, Lz: int = None, t: float = 1.0,
             ranpot: float = 0.0, seed: int = 1,
             boundary: str = "open") -> MatrixCSR:
    """3-D Anderson model: H[i,i] = eps_i ~ U[-ranpot/2, ranpot/2] (numpy's
    default_rng(seed)), H[i,j] = -t for the 6 nearest neighbours;
    `boundary` is "open" or "periodic"."""
    Ly = Lx if Ly is None else Ly
    Lz = Lx if Lz is None else Lz
    n = Lx * Ly * Lz
    eps = np.random.default_rng(seed).uniform(-ranpot / 2.0, ranpot / 2.0,
                                              size=n)
    X, Y, Z = np.meshgrid(np.arange(Lx), np.arange(Ly), np.arange(Lz),
                          indexing="ij")
    idx = (X + Lx * (Y + Ly * Z)).ravel()
    I_all, J_all, V_all = [idx], [idx], [eps[idx]]
    for (dx, dy, dz) in [(-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0),
                         (0, 0, -1), (0, 0, 1)]:
        Xn, Yn, Zn = X + dx, Y + dy, Z + dz
        if boundary == "periodic":
            valid = np.ones(n, dtype=bool)
            Xn, Yn, Zn = Xn % Lx, Yn % Ly, Zn % Lz
        else:
            valid = ((Xn >= 0) & (Xn < Lx) & (Yn >= 0) & (Yn < Ly)
                     & (Zn >= 0) & (Zn < Lz)).ravel()
            Xn, Yn, Zn = (np.clip(Xn, 0, Lx - 1), np.clip(Yn, 0, Ly - 1),
                          np.clip(Zn, 0, Lz - 1))
        jdx = (Xn + Lx * (Yn + Ly * Zn)).ravel()
        I_all.append(idx[valid])
        J_all.append(jdx[valid])
        V_all.append(np.full(int(valid.sum()), -t, dtype=np.float64))
    return convert_coo_to_csr(MatrixCOO.from_arrays(
        np.concatenate(I_all), np.concatenate(J_all), np.concatenate(V_all),
        n_rows=n, n_cols=n, is_symmetric=True))


def fdm_2d(nx: int, diag: float = -4.0, off: float = 1.0) -> MatrixCSR:
    """2-D 5-point FDM Laplacian on an nx×nx grid (the FDM-2d-16 fixture:
    diagonal -4, neighbours +1)."""
    n = nx * nx
    X, Y = np.meshgrid(np.arange(nx), np.arange(nx), indexing="ij")
    idx = (X + nx * Y).ravel()
    I_all, J_all, V_all = [idx], [idx], [np.full(n, diag)]
    for (dx, dy) in [(-1, 0), (1, 0), (0, -1), (0, 1)]:
        Xn, Yn = X + dx, Y + dy
        valid = ((Xn >= 0) & (Xn < nx) & (Yn >= 0) & (Yn < nx)).ravel()
        jdx = (np.clip(Xn, 0, nx - 1) + nx * np.clip(Yn, 0, nx - 1)).ravel()
        I_all.append(idx[valid])
        J_all.append(jdx[valid])
        V_all.append(np.full(int(valid.sum()), off, dtype=np.float64))
    return convert_coo_to_csr(MatrixCOO.from_arrays(
        np.concatenate(I_all), np.concatenate(J_all), np.concatenate(V_all),
        n_rows=n, n_cols=n, is_symmetric=True))


def banded(n: int, bandwidth: int = 2, seed: int = 0,
           diag_boost: float = None) -> MatrixCSR:
    """Random banded matrix, diagonally dominant by default (values
    U[-1, 1] per diagonal from numpy's default_rng(seed), the diagonal
    pushed away from 0 by `diag_boost`)."""
    rng = np.random.default_rng(seed)
    I_all, J_all, V_all = [], [], []
    for off in range(-bandwidth, bandwidth + 1):
        m = n - abs(off)
        rows = np.arange(max(0, -off), max(0, -off) + m)
        vals = rng.uniform(-1.0, 1.0, size=m)
        if off == 0:
            boost = (diag_boost if diag_boost is not None
                     else 2.0 * bandwidth + 1.0)
            vals = vals + np.sign(vals + (vals == 0)) * boost
        I_all.append(rows)
        J_all.append(rows + off)
        V_all.append(vals)
    return convert_coo_to_csr(MatrixCOO.from_arrays(
        np.concatenate(I_all), np.concatenate(J_all), np.concatenate(V_all),
        n_rows=n, n_cols=n))


def scattered_band(n: int, nnz_per_row: int = 8, spread: int = 400,
                   seed: int = 0) -> MatrixCSR:
    """Symmetric diagonally dominant matrix with its nonzeros at random
    offsets within ±spread of the diagonal (reflected at the boundary),
    duplicates summed: general sparsity with ~2·spread distinct
    diagonals."""
    if spread >= n:
        raise ValueError(
            f"sband spread {spread} must be < n ({n}): boundary-reflected "
            "columns would fall outside the matrix")
    rng = np.random.default_rng(seed)
    k = max(1, nnz_per_row - 1)
    rows = np.repeat(np.arange(n, dtype=np.int64), k)
    offs = (rng.integers(1, spread + 1, size=rows.size)
            * rng.choice(np.array([-1, 1]), size=rows.size))
    cols = rows + offs
    out = (cols < 0) | (cols >= n)
    cols = np.where(out, rows - offs, cols)
    vals = rng.uniform(-1.0, 1.0, size=rows.size)
    I = np.concatenate([rows, cols, np.arange(n, dtype=np.int64)])
    J = np.concatenate([cols, rows, np.arange(n, dtype=np.int64)])
    V = np.concatenate([vals, vals, np.full(n, 4.0 * nnz_per_row)])
    key = I * n + J
    order = np.argsort(key, kind="stable")
    key, I, J, V = key[order], I[order], J[order], V[order]
    first = np.concatenate([[True], key[1:] != key[:-1]])
    group = np.cumsum(first) - 1
    Vsum = np.zeros(int(group[-1]) + 1 if group.size else 0)
    np.add.at(Vsum, group, V)
    return convert_coo_to_csr(MatrixCOO.from_arrays(
        I[first], J[first], Vsum, n_rows=n, n_cols=n))


# ---------------------------------------------------------------------------
# SCAMAC quantum models (fixed-quantum-number sector bases)
# ---------------------------------------------------------------------------

def _fermion_sector_masks(n_sites: int, n_fermions: int) -> np.ndarray:
    """Sorted occupation bitmasks of the fixed-particle-number sector."""
    import itertools
    from math import comb
    if not 0 < n_fermions <= n_sites:
        raise ValueError("need 0 < n_fermions <= n_sites")
    masks = np.fromiter(
        (sum(1 << i for i in c)
         for c in itertools.combinations(range(n_sites), n_fermions)),
        dtype=np.int64, count=comb(n_sites, n_fermions))
    masks.sort()
    return masks


def _chain_hop_table(masks: np.ndarray, n_sites: int, n_fermions: int,
                     t: float, boundary: str):
    """One-directional hops (src, tgt, amp) of -t nearest-neighbour hopping
    on a chain; the periodic wrap bond carries (-1)^(n_fermions-1)."""
    bonds = [(i, i + 1, 1.0) for i in range(n_sites - 1)]
    if boundary == "periodic" and n_sites > 2:
        bonds.append((n_sites - 1, 0, (-1.0) ** (n_fermions - 1)))
    elif boundary not in ("open", "periodic"):
        raise ValueError(f"unknown boundary: {boundary}")
    rows_all = np.arange(masks.size, dtype=np.int64)
    src_l, tgt_l, amp_l = [], [], []
    for (i, j, sign) in bonds:
        bi, bj = np.int64(1 << i), np.int64(1 << j)
        movers = ((masks & bi) != 0) & ((masks & bj) == 0)
        src_l.append(rows_all[movers])
        tgt_l.append(np.searchsorted(masks, masks[movers] ^ (bi | bj)))
        amp_l.append(np.full(int(movers.sum()), -t * sign))
    return (np.concatenate(src_l), np.concatenate(tgt_l),
            np.concatenate(amp_l))


def _popcount64(x: np.ndarray) -> np.ndarray:
    x = x - ((x >> 1) & 0x5555555555555555)
    x = (x & 0x3333333333333333) + ((x >> 2) & 0x3333333333333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F0F0F0F0F
    return (x * 0x0101010101010101) >> 56


def free_fermion_chain(n_sites: int, n_fermions: int, t: float = 1.0,
                       boundary: str = "open") -> MatrixCSR:
    """Free fermions hopping on a chain, fixed particle number, with an
    explicit zero diagonal."""
    from math import comb
    if not 0 < n_fermions <= n_sites:
        raise ValueError("need 0 < n_fermions <= n_sites")
    dim = comb(n_sites, n_fermions)
    if dim > (1 << 22):
        raise ValueError(
            f"FreeFermionChain basis dimension {dim} too large (> 2^22)")
    masks = _fermion_sector_masks(n_sites, n_fermions)
    src, tgt, amp = _chain_hop_table(masks, n_sites, n_fermions, t,
                                     boundary)
    rows_all = np.arange(dim, dtype=np.int64)
    return convert_coo_to_csr(MatrixCOO.from_arrays(
        np.concatenate([src, tgt, rows_all]),
        np.concatenate([tgt, src, rows_all]),
        np.concatenate([amp, amp, np.zeros(dim)]),
        n_rows=dim, n_cols=dim, is_symmetric=True))


def hubbard(n_sites: int = 10, n_fermions: int = 5, t: float = 1.0,
            U: float = 1.0, ranpot: float = 0.0, seed: int = 1,
            boundary: str = "open") -> MatrixCSR:
    """1-D Hubbard chain with `n_fermions` particles per spin species; row
    = a·D + b for up configuration a and down configuration b."""
    from math import comb
    dim_s = comb(n_sites, n_fermions)
    dim = dim_s * dim_s
    if dim > (1 << 22):
        raise ValueError(f"Hubbard basis dimension {dim} too large (> 2^22)")
    masks = _fermion_sector_masks(n_sites, n_fermions)
    src, tgt, amp = _chain_hop_table(masks, n_sites, n_fermions, t,
                                     boundary)
    D = np.int64(dim_s)
    rows_all = np.arange(dim, dtype=np.int64)
    other = np.arange(dim_s, dtype=np.int64)
    I_up = (src[:, None] * D + other[None, :]).ravel()
    J_up = (tgt[:, None] * D + other[None, :]).ravel()
    V_up = np.broadcast_to(amp[:, None], (amp.size, dim_s)).ravel()
    I_dn = (other[:, None] * D + src[None, :]).ravel()
    J_dn = (other[:, None] * D + tgt[None, :]).ravel()
    V_dn = np.broadcast_to(amp[None, :], (dim_s, amp.size)).ravel()
    eps = np.random.default_rng(seed).uniform(-ranpot / 2.0, ranpot / 2.0,
                                              size=n_sites)
    occ = ((masks[:, None] >> np.arange(n_sites)[None, :]) & 1)
    pot = occ.astype(np.float64) @ eps
    doublons = _popcount64(masks[:, None] & masks[None, :]).astype(
        np.float64)
    diag = (U * doublons + pot[:, None] + pot[None, :]).ravel()
    return convert_coo_to_csr(MatrixCOO.from_arrays(
        np.concatenate([I_up, J_up, I_dn, J_dn, rows_all]),
        np.concatenate([J_up, I_up, J_dn, I_dn, rows_all]),
        np.concatenate([V_up, V_up, V_dn, V_dn, diag]),
        n_rows=dim, n_cols=dim, is_symmetric=True))


def spin_chain_xxz(n_sites: int = 16, n_up: int = 8, Jxy: float = 1.0,
                   Jz: float = 1.0, Bz: float = 0.0,
                   boundary: str = "open") -> MatrixCSR:
    """Spin-½ XXZ chain in the fixed-magnetisation sector (no fermionic
    signs)."""
    from math import comb
    dim = comb(n_sites, n_up)
    if dim > (1 << 22):
        raise ValueError(
            f"SpinChainXXZ basis dimension {dim} too large (> 2^22)")
    masks = _fermion_sector_masks(n_sites, n_up)
    bonds = [(i, i + 1) for i in range(n_sites - 1)]
    if boundary == "periodic" and n_sites > 2:
        bonds.append((n_sites - 1, 0))
    elif boundary not in ("open", "periodic"):
        raise ValueError(f"unknown boundary: {boundary}")
    rows_all = np.arange(dim, dtype=np.int64)
    src_l, tgt_l = [], []
    for (i, j) in bonds:
        bi, bj = np.int64(1 << i), np.int64(1 << j)
        movers = ((masks & bi) != 0) & ((masks & bj) == 0)
        src_l.append(rows_all[movers])
        tgt_l.append(np.searchsorted(masks, masks[movers] ^ (bi | bj)))
    src, tgt = np.concatenate(src_l), np.concatenate(tgt_l)
    amp = np.full(src.size, Jxy / 2.0)
    occ = ((masks[:, None] >> np.arange(n_sites)[None, :]) & 1
           ).astype(np.float64) - 0.5
    diag = -Bz * occ.sum(axis=1)
    for (i, j) in bonds:
        diag = diag + Jz * occ[:, i] * occ[:, j]
    return convert_coo_to_csr(MatrixCOO.from_arrays(
        np.concatenate([src, tgt, rows_all]),
        np.concatenate([tgt, src, rows_all]),
        np.concatenate([amp, amp, diag]),
        n_rows=dim, n_cols=dim, is_symmetric=True))


# ---------------------------------------------------------------------------
# Spec parsing and source resolution
# ---------------------------------------------------------------------------

_GEN_RE = re.compile(r"^(scamac|hpcg|fdm|band|sband|anderson):(.*)$",
                     re.IGNORECASE)

SCAMAC_MODELS = ("Anderson", "FreeFermionChain", "Hubbard", "SpinChainXXZ")

#: keyword parsers of the SCAMAC models: name → (int keys, float keys)
_SCAMAC_KEYS = {
    "anderson": (("Lx", "Ly", "Lz", "seed"), ("t", "ranpot")),
    "freefermionchain": (("n_sites", "n_fermions"), ("t",)),
    "hubbard": (("n_sites", "n_fermions", "seed"), ("t", "U", "ranpot")),
    "spinchainxxz": (("n_sites", "n_up"), ("Jxy", "Jz", "Bz")),
}
_SCAMAC_NAMES = {"anderson": "Anderson",
                 "freefermionchain": "FreeFermionChain",
                 "hubbard": "Hubbard", "spinchainxxz": "SpinChainXXZ"}


def _split_scamac_spec(spec: str):
    """'Model,k=v,...' → (model name in lower case, [k=v parts]); a bare
    parameter list means Anderson."""
    parts = [p for p in spec.split(",") if p]
    if parts and "=" not in parts[0]:
        return parts[0].strip().lower(), parts[1:]
    return "anderson", parts


def _parse_model_kwargs(model: str, parts) -> dict:
    ints, floats = _SCAMAC_KEYS[model]
    kwargs = {}
    for p in parts:
        k, v = p.split("=", 1)
        k = k.strip()
        if k in ints:
            kwargs[k] = int(v)
        elif k in floats:
            kwargs[k] = float(v)
        elif k == "boundary":
            kwargs[k] = v.strip()
        else:
            raise ValueError(
                f"unknown {_SCAMAC_NAMES[model]} parameter: {k}")
    return kwargs


def _parse_anderson_kwargs(spec: str) -> dict:
    """Parse 'Anderson,Lx=20,...,seed=3,boundary=open' into anderson()
    keyword arguments."""
    for p in (p for p in spec.split(",") if p):
        if "=" not in p and p.lower() != "anderson":
            raise ValueError(f"unsupported scamac generator: {p}")
    return _parse_model_kwargs(
        "anderson", [p for p in spec.split(",") if p and "=" in p])


def scamac_matrix(spec: str) -> MatrixCSR:
    """A 'scamac:<Model>,k=v,...' argstring to its model's matrix."""
    model, parts = _split_scamac_spec(spec)
    if model == "anderson":
        return anderson(**_parse_anderson_kwargs(spec))
    builders = {"freefermionchain": free_fermion_chain, "hubbard": hubbard,
                "spinchainxxz": spin_chain_xxz}
    if model not in builders:
        raise ValueError(f"unknown SCAMAC model {model!r}; supported "
                         "models: " + ", ".join(SCAMAC_MODELS))
    return builders[model](**_parse_model_kwargs(model, parts))


def _dims(spec: str):
    return [int(d) for d in re.split(r"[x,]", spec) if d]


def _grid_spec_separable(dims, max_leg: int = 1, max_colors: int = 32):
    """Separable grid ColorSpec: per-axis strides ≥ max_leg+1 that divide
    the dims; None when the smallest admissible divisors give more than
    `max_colors` colours."""
    from .coloring import ColorSpec

    def stride(n):
        if n == 1:
            return 1
        for s in range(max_leg + 1, n):
            if n % s == 0:
                return s
        return n

    strides = tuple(stride(int(d)) for d in dims)
    n_colors = strides[0] * strides[1] * strides[2]
    if n_colors > max_colors:
        return None
    nx, ny, nz = (int(d) for d in dims)
    return ColorSpec("grid", n_colors, (nx, ny, nz) + strides)


def color_spec_for_source(source: str):
    """Structural ColorSpec of a generator source whose row numbering this
    module controls (x-fastest grids, plain bands); None otherwise (.mtx
    files, scattered patterns: greedy colouring applies there)."""
    from .coloring import mod_color_spec
    m = _GEN_RE.match(source)
    if not m:
        return None
    kind, spec = m.group(1).lower(), m.group(2)
    try:
        if kind == "hpcg":
            dims = _dims(spec)
            nx = dims[0]
            ny = dims[1] if len(dims) > 1 else nx
            nz = dims[2] if len(dims) > 2 else nx
            return _grid_spec_separable((nx, ny, nz))
        if kind in ("scamac", "anderson"):
            kw = _parse_anderson_kwargs(spec)
            Lx = kw["Lx"]
            return _grid_spec_separable((Lx, kw.get("Ly", Lx),
                                         kw.get("Lz", Lx)))
        if kind == "fdm":
            n = int(spec)
            return _grid_spec_separable((n, n, 1))
        if kind == "band":
            dims = _dims(spec)
            bw = dims[1] if len(dims) > 1 else 2
            return mod_color_spec(list(range(1, bw + 1)), dims[0])
    except (KeyError, ValueError):
        return None
    return None


def device_buildable(source: str) -> bool:
    """True when the spec has an on-device builder: the grid and band
    generators and the Anderson SCAMAC model (the other SCAMAC models and
    .mtx files build on the host)."""
    from .dia import _GEN_RE as _DEVICE_RE
    m = _DEVICE_RE.match(source)
    if not m:
        return False
    kind, spec = m.group(1).lower(), m.group(2)
    if kind == "scamac":
        return _split_scamac_spec(spec)[0] == "anderson"
    return True


def from_source(source: str) -> MatrixCSR:
    """A matrix source as host CSR: a generator spec or a .mtx path."""
    m = _GEN_RE.match(source)
    if not m:
        import os
        if ":" in source and not os.path.exists(source):
            raise ValueError(f"unknown matrix generator: "
                             f"{source.split(':', 1)[0]!r} (in {source!r})")
        from .io import read_mtx
        return read_mtx(source)
    kind, spec = m.group(1).lower(), m.group(2)
    if kind == "anderson":
        return anderson(**_parse_anderson_kwargs(spec))
    if kind == "scamac":
        return scamac_matrix(spec)
    if kind == "hpcg":
        return stencil_27pt(*_dims(spec))
    if kind == "sband":
        return scattered_band(*_dims(spec))
    if kind == "fdm":
        return fdm_2d(int(spec))
    return banded(*_dims(spec))
