"""Plain reference of the benchmark: the configurations' operators and CG.

Everything here is plain PyTorch, built from a configuration file alone.
It imports nothing of the program under test and takes nothing the
program made; the benchmark hands it the same inputs (x_true, b) and the
program's answers to judge.

Rows are numbered as HPCG's GenerateProblem numbers them: x fastest, then
y, then z (row = x + nx·(y + ny·z)).  A stencil's legs are constant
coefficients; a leg that leaves the grid is dropped (Dirichlet boundary).
"""
from __future__ import annotations

import itertools

import torch


def stencil_legs(stencil: dict):
    """(diagonal, legs) of a configuration's "stencil": legs are
    (dz, dy, dx, coefficient).  Shape "box" takes every offset within
    `radius` on each axis with `off_diagonal`."""
    if stencil.get("shape") != "box":
        raise ValueError(f"unknown stencil description: {stencil}")
    r, c = int(stencil["radius"]), float(stencil["off_diagonal"])
    legs = [(dz, dy, dx, c) for dz, dy, dx
            in itertools.product(range(-r, r + 1), repeat=3)
            if (dz, dy, dx) != (0, 0, 0)]
    return float(stencil["diagonal"]), legs


def _span(lo: int, hi: int, d: int, size: int):
    """Targets t in [lo, hi) whose source t + d lies in [0, size)."""
    return max(lo, -d), min(hi, size - d)


class StencilOp:
    """y = A·x of a constant-coefficient stencil on an (nx, ny, nz) grid,
    computed by slicing, z-planes in blocks so that the work space stays
    small beside the program's."""

    def __init__(self, grid, stencil: dict, planes: int = 32):
        self.nx, self.ny, self.nz = (int(g) for g in grid)
        self.n = self.nx * self.ny * self.nz
        self.diag, self.legs = stencil_legs(stencil)
        self.radius = max(abs(leg[0]) for leg in self.legs)
        self.planes = planes

    def apply(self, x: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
        """A·x, every product and sum in `dtype`."""
        nx, ny, nz = self.nx, self.ny, self.nz
        X = x.reshape(nz, ny, nx)
        y = torch.empty((nz, ny, nx), dtype=dtype, device=x.device)
        for z0 in range(0, nz, self.planes):
            z1 = min(nz, z0 + self.planes)
            lo, hi = max(0, z0 - self.radius), min(nz, z1 + self.radius)
            xb = X[lo:hi].to(dtype)
            acc = y[z0:z1]
            torch.mul(xb[z0 - lo:z1 - lo], self.diag, out=acc)
            for dz, dy, dx, c in self.legs:
                tz0, tz1 = _span(z0, z1, dz, nz)
                ty0, ty1 = _span(0, ny, dy, ny)
                tx0, tx1 = _span(0, nx, dx, nx)
                if tz0 >= tz1 or ty0 >= ty1 or tx0 >= tx1:
                    continue
                acc[tz0 - z0:tz1 - z0, ty0:ty1, tx0:tx1].add_(
                    xb[tz0 + dz - lo:tz1 + dz - lo, ty0 + dy:ty1 + dy,
                       tx0 + dx:tx1 + dx], alpha=c)
        return y.reshape(-1)


class DiaOp:
    """The same operator as stored diagonals: y[i] = Σ_d data[d, i] ·
    x[i + offset[d]], data[d, i] the coefficient where row i's leg d stays
    on the grid, else 0; the main diagonal is one of them."""

    def __init__(self, stencil_op: StencilOp, dtype=torch.float64,
                 device="cpu"):
        s = stencil_op
        self.n = s.n
        nx, ny, nz = s.nx, s.ny, s.nz
        z = torch.arange(nz, device=device).view(nz, 1, 1)
        y = torch.arange(ny, device=device).view(1, ny, 1)
        x = torch.arange(nx, device=device).view(1, 1, nx)
        legs = [(0, 0, 0, s.diag)] + list(s.legs)
        self.offsets = [dz * nx * ny + dy * nx + dx for dz, dy, dx, _ in legs]
        self.data = torch.empty((len(legs), self.n), dtype=dtype,
                                device=device)
        for d, (dz, dy, dx, c) in enumerate(legs):
            inside = (((z + dz >= 0) & (z + dz < nz))
                      & ((y + dy >= 0) & (y + dy < ny))
                      & ((x + dx >= 0) & (x + dx < nx)))
            self.data[d] = (inside.to(dtype) * c).reshape(-1)

    def apply(self, x: torch.Tensor, dtype=None) -> torch.Tensor:
        """A·x in `dtype` (the stored data's by default)."""
        dtype = dtype or self.data.dtype
        x = x.to(dtype)
        y = torch.zeros(self.n, dtype=dtype, device=x.device)
        for d, off in enumerate(self.offsets):
            lo, hi = max(0, -off), min(self.n, self.n - off)
            y[lo:hi].addcmul_(self.data[d, lo:hi].to(dtype),
                              x[lo + off:hi + off])
        return y


def operator(config: dict, dtype=torch.float64, device="cpu"):
    """The configuration's operator in its stated storage: a StencilOp
    for "stencil", a DiaOp (data in `dtype`) for "dia"."""
    op = StencilOp(config["grid"], config["stencil"])
    if config["format"] == "dia":
        return DiaOp(op, dtype=dtype, device=device)
    if config["format"] != "stencil":
        raise ValueError(f"unknown format {config['format']!r}")
    return op


def cg(op, b: torch.Tensor, x0: torch.Tensor, tol: float, max_iters: int,
       dtype=torch.float64):
    """Plain conjugate gradients, every vector and scalar in `dtype`:
    stops once ‖r‖ ≤ tol·‖b − A·x0‖ (the recursive residual) or after
    max_iters.  Returns (x, iterations, converged)."""
    x = x0.to(dtype).clone()
    r = b.to(dtype) - op.apply(x, dtype)
    p = r.clone()
    rr = torch.dot(r, r)
    stop = tol * float(torch.sqrt(rr.double()))
    for k in range(max_iters):
        if float(torch.sqrt(rr.double())) <= stop:
            return x, k, True
        Ap = op.apply(p, dtype)
        alpha = rr / torch.dot(p, Ap)
        x.add_(alpha * p)
        r.sub_(alpha * Ap)
        rr_new = torch.dot(r, r)
        p.mul_(rr_new / rr).add_(r)
        rr = rr_new
    return x, max_iters, float(torch.sqrt(rr.double())) <= stop


def relative_residual(op, b: torch.Tensor, x: torch.Tensor) -> float:
    """‖b − A·x‖₂ / ‖b‖₂ in float64."""
    b64 = b.to(torch.float64)
    r = b64 - op.apply(x.to(torch.float64), torch.float64)
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b64))


def relative_error(x: torch.Tensor, x_true: torch.Tensor) -> float:
    """‖x − x_true‖₂ / ‖x_true‖₂ in float64."""
    t = x_true.to(torch.float64)
    return float(torch.linalg.vector_norm(x.to(torch.float64) - t)
                 / torch.linalg.vector_norm(t))
