"""Generator-spec parsing for the matrix-free operators.

This slice builds only stencil operators (stencil_op.from_source_operator):
`hpcg:NXxNYxNZ`, `fdm:N`, `anderson:...` and `scamac:Anderson,...`.  The
Anderson parameters are parsed as the JAX package parses them
(basic_iterative_solvers_tpu/generators.py:497).
"""
from __future__ import annotations


def _parse_anderson_kwargs(spec: str) -> dict:
    """Parse 'Anderson,Lx=20,...,seed=3,boundary=open' into
    stencil_op.anderson_operator keyword arguments."""
    kwargs = {}
    for p in (p for p in spec.split(",") if p):
        if "=" not in p:
            if p.lower() != "anderson":
                raise ValueError(f"unsupported scamac generator: {p}")
            continue
        k, v = p.split("=", 1)
        k = k.strip()
        if k in ("Lx", "Ly", "Lz", "seed"):
            kwargs[k] = int(v)
        elif k in ("t", "ranpot"):
            kwargs[k] = float(v)
        elif k == "boundary":
            kwargs[k] = v.strip()
        else:
            raise ValueError(f"unknown Anderson parameter: {k}")
    return kwargs
