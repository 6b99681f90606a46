"""Matrix-free constant-coefficient stencil operator.

Every matrix family the reference benchmarks (HPCG 27-point, FDM
Laplacian, Anderson hopping) is a constant-coefficient stencil on a
regular grid.  The SpMV then needs no matrix traffic at all:
y[i] = Σ_leg c · x[i + off], with the open-boundary masks computed from
the grid coordinates of i.  It reads x (and a dense diagonal, if any) and
writes y.

`DeviceStencil` keeps its vectors in natural x-fastest flat order
(i = x + nx·(y + ny·z)), with no halo: Hopper's kernel computes the masks
from coordinates, so the TPU package's planar halo layout has no
counterpart here.

`stencil_spmv` is the SpMV's one entry point, and `stencil_gs_color_step`
the multicolour Gauss-Seidel step's: on a CUDA tensor each launches its
hand-written kernel (csrc/stencil_spmv.cu) or raises; on a CPU tensor each
runs its plain version (`stencil_spmv_plain`,
`stencil_gs_color_step_plain`).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import re
from typing import Optional, Tuple

import numpy as np
import torch

from .config import torch_dtype

DOT_KINDS = ("x", "self", "aux")
#: threads per kernel block (csrc/stencil_spmv.cu: __launch_bounds__)
_BLOCK_THREADS = 256


@dataclasses.dataclass
class DeviceStencil:
    """Constant-coefficient stencil on an open-boundary nx×ny×nz grid.

    coeffs[l] multiplies x at grid offset legs[l] = (dx, dy, dz); when
    `diag` (n,) is given it overrides the (0,0,0) leg with a dense vector.
    `coeff_values` are the coefficients as Python floats, equal to `coeffs`
    (rounded to its dtype), so launches need no device read.
    """

    coeffs: torch.Tensor                   # (n_legs,)
    diag: Optional[torch.Tensor]           # (n,) or None
    legs: Tuple[Tuple[int, int, int], ...]
    coeff_values: Tuple[float, ...]
    dims: Tuple[int, int, int]
    n_rows: int
    n_cols: int

    @property
    def dtype(self) -> torch.dtype:
        return self.coeffs.dtype

    @property
    def device(self) -> torch.device:
        return self.coeffs.device

    @property
    def offsets(self) -> Tuple[int, ...]:
        nx, ny, _ = self.dims
        return tuple(sorted({dx + nx * (dy + ny * dz)
                             for (dx, dy, dz) in self.legs}))


def _legs_sorted(legs_coeffs):
    return tuple(sorted(legs_coeffs,
                        key=lambda lc: (lc[0][2], lc[0][1], lc[0][0])))


def _rounded(values, dtype: torch.dtype) -> Tuple[float, ...]:
    """Python floats equal to `values` stored in `dtype`."""
    return tuple(torch.tensor(values, dtype=torch.float64).to(dtype)
                 .to(torch.float64).tolist())


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device with no card raises,
    naming it (the entry points never fall back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was asked for, but no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    return device


def make_stencil(legs_coeffs, nx: int, ny: int, nz: int,
                 dtype=torch.float32, diag=None, *,
                 device="cuda") -> DeviceStencil:
    """legs_coeffs: iterable of ((dx, dy, dz), coefficient).  Legs that
    cannot reach inside the grid are dropped; legs are sorted z, y, x.
    The operator lives on `device`, the card unless the caller asks for
    the CPU."""
    dtype = torch_dtype(dtype)
    device = resolve_device(device)
    legs_coeffs = [(tuple(l), float(c)) for (l, c) in legs_coeffs
                   if (nx - abs(l[0])) > 0 and (ny - abs(l[1])) > 0
                   and (nz - abs(l[2])) > 0]
    legs_coeffs = _legs_sorted(legs_coeffs)
    legs = tuple(l for (l, _) in legs_coeffs)
    if len(set(legs)) != len(legs):
        raise ValueError("duplicate stencil legs")
    values = _rounded([c for (_, c) in legs_coeffs], dtype)
    coeffs = torch.tensor(values, dtype=dtype, device=device)
    n = nx * ny * nz
    d = None
    if diag is not None:
        d = torch.as_tensor(diag, dtype=dtype, device=device).reshape(-1)
        if d.numel() != n:
            raise ValueError(f"diag has {d.numel()} entries, grid has {n}")
        d = d.contiguous()
    return DeviceStencil(coeffs=coeffs, diag=d, legs=legs,
                         coeff_values=values, dims=(nx, ny, nz), n_rows=n,
                         n_cols=n)


def stencil_astype(A: DeviceStencil, dtype) -> DeviceStencil:
    """A with its coefficients and diagonal stored in `dtype` (the rounded
    coefficients of A's own dtype, as a cast of the tensors gives them)."""
    dtype = torch_dtype(dtype)
    if A.dtype == dtype:
        return A
    return dataclasses.replace(
        A, coeffs=A.coeffs.to(dtype),
        diag=None if A.diag is None else A.diag.to(dtype),
        coeff_values=_rounded(A.coeff_values, dtype))


# ---------------------------------------------------------------------------
# SpMV
# ---------------------------------------------------------------------------

def _check_operands(A: DeviceStencil, x: torch.Tensor, dots, aux):
    for kind in dots:
        if kind not in DOT_KINDS:
            raise ValueError(f"unknown fused-dot kind: {kind!r}")
    if "aux" in dots and aux is None:
        raise ValueError("dots containing 'aux' require the aux vector")
    vecs = [("x", x)] + [("diag", A.diag)] * (A.diag is not None)
    if "aux" in dots:
        vecs.append(("aux", aux))
    for name, v in vecs:
        if not isinstance(v, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if v.shape != (A.n_rows,):
            raise ValueError(f"{name} has shape {tuple(v.shape)}, "
                             f"expected ({A.n_rows},)")
        if v.dtype != A.dtype:
            raise TypeError(f"{name} is {v.dtype}, the operator {A.dtype}")
        if v.device != A.device:
            raise ValueError(f"{name} is on {v.device}, the operator on "
                             f"{A.device}")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _leg_masks(g, legs, nx, ny, nz, n):
    """Boundary-validity mask per leg from the flat row index vector g."""
    xc = g % nx
    yc = (g // nx) % ny
    zc = g // (nx * ny)
    in_n = g < n
    masks = []
    for leg in legs:
        m = in_n
        for c, d, size in zip((xc, yc, zc), leg, (nx, ny, nz)):
            if d != 0:
                m = m & (c + d >= 0) & (c + d < size)
        masks.append(m)
    return masks


def stencil_spmv_plain(A: DeviceStencil, x: torch.Tensor, dots=(),
                       aux: torch.Tensor = None):
    """Plain PyTorch version of the kernel: one masked, shifted
    multiply-add per leg in leg order, then one `torch.dot` per requested
    dot.  Returns y, or (y, *dots) when dots are requested."""
    _check_operands(A, x, dots, aux)
    n = A.n_rows
    nx, ny, nz = A.dims
    offs = A.offsets
    hneg = max(0, -min(offs)) if offs else 0
    hpos = max(0, max(offs)) if offs else 0
    xp = torch.nn.functional.pad(x, (hneg, hpos))
    g = torch.arange(n, device=x.device)
    masks = _leg_masks(g, A.legs, nx, ny, nz, n)
    y = torch.zeros_like(x)
    for l, (dx, dy, dz) in enumerate(A.legs):
        lin = dx + nx * (dy + ny * dz)
        contrib = torch.where(masks[l], xp[hneg + lin:hneg + lin + n], 0.0)
        coeff = (A.diag if ((dx, dy, dz) == (0, 0, 0) and A.diag is not None)
                 else A.coeffs[l])
        y = torch.addcmul(y, coeff, contrib)
    if not dots:
        return y
    partner = {"x": x, "self": y, "aux": aux}
    return (y,) + tuple(torch.dot(y, partner[k]) for k in dots)


@functools.lru_cache(maxsize=64)
def _launch_table(legs, coeff_values, dims, use_diag: bool, dots):
    """(StencilArgs, n_blocks) for one operator and dot request.

    Legs sharing a coefficient value form one group (one multiply per
    group, groups in ascending value); with `use_diag` the (0,0,0) leg is
    left out, since the kernel adds diag[i]·x[i] itself."""
    from ._build import MAX_DOTS, MAX_LEGS, StencilArgs
    if len(legs) > MAX_LEGS or len(dots) > MAX_DOTS:
        raise ValueError(f"the kernel takes at most {MAX_LEGS} legs and "
                         f"{MAX_DOTS} dots")
    nx, ny, nz = dims
    groups = {}
    for l, leg in enumerate(legs):
        if use_diag and leg == (0, 0, 0):
            continue
        groups.setdefault(coeff_values[l], []).append(leg)
    a = StencilArgs()
    j = 0
    for gi, (c, group) in enumerate(sorted(groups.items())):
        a.group_begin[gi] = j
        a.group_coeff[gi] = c
        for (dx, dy, dz) in group:
            a.off[j] = dx + nx * (dy + ny * dz)
            a.dx[j], a.dy[j], a.dz[j] = dx, dy, dz
            j += 1
    a.n_groups = len(groups)
    a.group_begin[a.n_groups] = j
    a.nx, a.ny, a.nz = nx, ny, nz
    a.block_x = min(128, -(-nx // 32) * 32)
    a.block_y = _BLOCK_THREADS // a.block_x
    a.grid_x = -(-ny // a.block_y)
    a.grid_y = nz
    if a.grid_y > 65535 or nx * ny * nz >= 2 ** 62:
        raise ValueError(f"grid {dims} exceeds the kernel's launch limits")
    a.n_dots = len(dots)
    for k, kind in enumerate(dots):
        a.dot_kind[k] = DOT_KINDS.index(kind)
    return a, a.grid_x * a.grid_y


def _stencil_spmv_cuda(A: DeviceStencil, x: torch.Tensor, dots, aux):
    from ._build import load_library
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the stencil kernel takes float32 or float64, "
                        f"not {x.dtype}")
    use_diag = A.diag is not None and (0, 0, 0) in A.legs
    args, n_blocks = _launch_table(A.legs, A.coeff_values, A.dims, use_diag,
                                   tuple(dots))
    lib = load_library()
    fn = (lib.bis_stencil_spmv_f32 if x.dtype == torch.float32
          else lib.bis_stencil_spmv_f64)
    y = torch.empty_like(x)
    partials = (torch.empty((n_blocks, len(dots)), dtype=x.dtype,
                            device=x.device) if dots else None)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = fn(x.device.index, ctypes.byref(args), ptr(x),
             ptr(A.diag if use_diag else None),
             ptr(aux if "aux" in dots else None), ptr(y), ptr(partials),
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"stencil_spmv kernel launch failed with CUDA "
                           f"error {err}")
    stencil_spmv.launches += 1
    if not dots:
        return y
    return (y,) + tuple(partials.sum(dim=0).unbind())


def stencil_spmv(A: DeviceStencil, x: torch.Tensor, dots=(),
                 aux: torch.Tensor = None):
    """y = A @ x, with optional fused dots drawn from {"x", "self", "aux"}:
    dot(y, x), dot(y, y), dot(y, aux).  Returns y, or (y, *dots).

    A CUDA tensor goes through the hand-written kernel, which counts its
    launches in `stencil_spmv.launches`; a CPU tensor takes the plain
    version."""
    dots = tuple(dots)
    _check_operands(A, x, dots, aux)
    if x.device.type == "cuda":
        return _stencil_spmv_cuda(A, x, dots, aux)
    if x.device.type == "cpu":
        return stencil_spmv_plain(A, x, dots, aux)
    raise ValueError(f"no stencil SpMV for device {x.device}")


stencil_spmv.launches = 0


# ---------------------------------------------------------------------------
# Multicolour Gauss-Seidel step
# ---------------------------------------------------------------------------

def _colors(color) -> Tuple[int, ...]:
    return tuple(int(c) for c in color) if isinstance(color, (tuple, list)) \
        else (int(color),)


def _check_gs_operands(A: DeviceStencil, x, rhs, dinv, spec):
    _check_operands(A, x, (), None)
    for name, v in (("rhs", rhs), ("dinv", dinv)):
        if not isinstance(v, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if (v.shape != x.shape or v.dtype != x.dtype
                or v.device != x.device):
            raise ValueError(f"{name} must match x in shape, dtype and "
                             "device")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if spec.kind in ("grid", "parity") and tuple(spec.params[:3]) != A.dims:
        raise ValueError(f"colour spec dims {spec.params[:3]} do not match "
                         f"the operator's {A.dims}")


def stencil_gs_color_step_plain(A: DeviceStencil, x: torch.Tensor,
                                rhs: torch.Tensor, dinv: torch.Tensor, spec,
                                color) -> torch.Tensor:
    """Plain PyTorch version of the kernel: per colour c (in the given
    order), the full plain SpMV then
    x = where(colour == c, x + (rhs − A·x)·dinv, x)."""
    from .coloring import color_ids
    _check_gs_operands(A, x, rhs, dinv, spec)
    ids = color_ids(spec, A)
    for c in _colors(color):
        Ax = stencil_spmv_plain(A, x)
        x = torch.where(ids == c, x + (rhs - Ax) * dinv, x)
    return x


_COLOR_KINDS = {"parity": 0, "grid": 1, "mod": 2}


def _stencil_gs_color_step_cuda(A: DeviceStencil, x, rhs, dinv, spec, color):
    from ._build import load_library
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the GS colour-step kernel takes float32 or "
                        f"float64, not {x.dtype}")
    use_diag = A.diag is not None and (0, 0, 0) in A.legs
    args, _ = _launch_table(A.legs, A.coeff_values, A.dims, use_diag, ())
    kind = _COLOR_KINDS[spec.kind]
    p = (tuple(spec.params[3:6]) if spec.kind == "grid"
         else (spec.params[0], 1, 1) if spec.kind == "mod" else (1, 1, 1))
    lib = load_library()
    fn = (lib.bis_stencil_gs_color_step_f32 if x.dtype == torch.float32
          else lib.bis_stencil_gs_color_step_f64)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    diag = A.diag.data_ptr() if use_diag else None
    for c in _colors(color):
        out = torch.empty_like(x)
        err = fn(x.device.index, ctypes.byref(args), kind, *p, c,
                 x.data_ptr(), diag, rhs.data_ptr(), dinv.data_ptr(),
                 out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"stencil_gs_color_step kernel launch failed "
                               f"with CUDA error {err}")
        stencil_gs_color_step.launches += 1
        x = out
    return x


def stencil_gs_color_step(A: DeviceStencil, x: torch.Tensor,
                          rhs: torch.Tensor, dinv: torch.Tensor, spec,
                          color) -> torch.Tensor:
    """One multicolour Gauss-Seidel step, out of place:
    x' = where(colour == c, x + (rhs − A·x)·D⁻¹, x), the colour ids from
    the ColorSpec `spec` (coloring.py).  `color` may be a tuple of colours,
    run in order (the JAX package's superstep).

    A CUDA tensor goes through the hand-written kernel, one launch per
    colour, counted in `stencil_gs_color_step.launches`; a CPU tensor takes
    the plain version."""
    _check_gs_operands(A, x, rhs, dinv, spec)
    if x.device.type == "cuda":
        return _stencil_gs_color_step_cuda(A, x, rhs, dinv, spec, color)
    if x.device.type == "cpu":
        return stencil_gs_color_step_plain(A, x, rhs, dinv, spec, color)
    raise ValueError(f"no GS colour step for device {x.device}")


stencil_gs_color_step.launches = 0


def stencil_diag(A: DeviceStencil) -> torch.Tensor:
    """Dense main diagonal (n,)."""
    if A.diag is not None:
        return A.diag
    for l, leg in enumerate(A.legs):
        if leg == (0, 0, 0):
            return torch.full((A.n_rows,), 1.0, dtype=A.dtype,
                              device=A.device) * A.coeffs[l]
    raise ValueError("stencil has no (0,0,0) leg")


def stencil_diag_vec(A: DeviceStencil) -> torch.Tensor:
    """The diagonal in A's vector layout, which here is always flat."""
    return stencil_diag(A)


def stencil_split(A: DeviceStencil):
    """(L_strict, U_strict, D, D_inv) by the linear-offset sign of each
    leg; D and D_inv are flat vectors in A's dtype."""
    nx, ny, nz = A.dims
    if A.diag is None and (0, 0, 0) not in A.legs:
        raise ValueError("matrix has no stored main diagonal")
    lower, upper = [], []
    for leg, c in zip(A.legs, A.coeff_values):
        lin = leg[0] + nx * (leg[1] + ny * leg[2])
        if lin < 0:
            lower.append((leg, c))
        elif lin > 0:
            upper.append((leg, c))
    L = make_stencil(lower, nx, ny, nz, dtype=A.dtype, device=A.device)
    U = make_stencil(upper, nx, ny, nz, dtype=A.dtype, device=A.device)
    D = stencil_diag_vec(A)
    if bool((D == 0).any()):
        raise ValueError("zero on the matrix diagonal")
    return L, U, D, 1.0 / D


# ---------------------------------------------------------------------------
# Builders / source dispatch
# ---------------------------------------------------------------------------

def stencil_27pt_operator(nx: int, ny: int = None, nz: int = None,
                          diag: float = 26.0, off: float = -1.0,
                          dtype=torch.float32, *,
                          device="cuda") -> DeviceStencil:
    ny = nx if ny is None else ny
    nz = nx if nz is None else nz
    legs = [((dx, dy, dz), diag if (dx, dy, dz) == (0, 0, 0) else off)
            for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    return make_stencil(legs, nx, ny, nz, dtype=dtype, device=device)


def fdm_2d_operator(nx: int, diag: float = -4.0, off: float = 1.0,
                    dtype=torch.float32, *, device="cuda") -> DeviceStencil:
    legs = [((0, 0, 0), diag)]
    legs += [((dx, dy, 0), off)
             for (dx, dy) in ((-1, 0), (1, 0), (0, -1), (0, 1))]
    return make_stencil(legs, nx, nx, 1, dtype=dtype, device=device)


def anderson_operator(Lx: int, Ly: int = None, Lz: int = None,
                      t: float = 1.0, ranpot: float = 0.0, seed: int = 1,
                      boundary: str = "open", dtype=torch.float32, *,
                      device="cuda") -> DeviceStencil:
    if boundary != "open":
        raise ValueError("stencil operator supports open boundary only")
    Ly = Lx if Ly is None else Ly
    Lz = Lx if Lz is None else Lz
    n = Lx * Ly * Lz
    # numpy's generator, as the JAX package draws it: both build one operator
    eps = np.random.default_rng(seed).uniform(-ranpot / 2.0, ranpot / 2.0,
                                              size=n)
    legs = [((dx, dy, dz), -t)
            for (dx, dy, dz) in ((-1, 0, 0), (1, 0, 0), (0, -1, 0),
                                 (0, 1, 0), (0, 0, -1), (0, 0, 1))]
    legs.append(((0, 0, 0), 0.0))
    return make_stencil(legs, Lx, Ly, Lz, dtype=dtype, diag=eps,
                        device=device)


_GEN_RE = re.compile(r"^(scamac|hpcg|fdm|anderson):(.*)$", re.IGNORECASE)


def stencil_buildable(source: str) -> bool:
    """True when from_source_operator can build this spec."""
    m = _GEN_RE.match(source)
    if not m:
        return False
    kind = m.group(1).lower()
    if kind == "scamac":
        from .generators import _split_scamac_spec
        return _split_scamac_spec(m.group(2))[0] == "anderson"
    return True


def from_source_operator(source: str, dtype=torch.float32, *,
                         device="cuda") -> DeviceStencil:
    """Matrix-free operator for a generator spec: `hpcg:NXxNYxNZ`,
    `fdm:N`, `anderson:Lx=..,...` or `scamac:Anderson,...`."""
    m = _GEN_RE.match(source)
    if not m:
        raise ValueError(f"not a stencil-operator source: {source}")
    kind, spec = m.group(1).lower(), m.group(2)
    if kind in ("scamac", "anderson"):
        from .generators import _parse_anderson_kwargs
        return anderson_operator(dtype=dtype, device=device,
                                 **_parse_anderson_kwargs(spec))
    if kind == "hpcg":
        dims = [int(d) for d in re.split(r"[x,]", spec) if d]
        return stencil_27pt_operator(*dims, dtype=dtype, device=device)
    return fdm_2d_operator(int(spec), dtype=dtype, device=device)
