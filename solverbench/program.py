"""The system under test, as the benchmark drives it: the one module of the
benchmark that imports the port.

A cell builds the port's operator and solver set-up once (`Program`), the
preconditioner with it, and then solves right-hand side after right-hand
side through the port's public entry, `solve`, each b swapped into the
one `SolverSetup` with `dataclasses.replace`, as the port's own
refinement loop does.  Nothing else of the port is called in the window.
"""
from __future__ import annotations

import dataclasses
import sys

import torch

PORT = "basic_iterative_solvers_tpu_torch"


class Program:
    """The port's operator and set-up for one configuration and traffic
    mix, on `device`."""

    def __init__(self, config: dict, traffic: dict, device):
        import basic_iterative_solvers_tpu_torch as bis
        from basic_iterative_solvers_tpu_torch.types import (PrecondType,
                                                             SolverType)
        self.bis = bis
        spec, fmt = config["generator"], config["format"]
        self.dtype = getattr(torch, config["dtype"])
        self.device = torch.device(device)
        cfg = bis.SolverConfig(
            method=SolverType[traffic["method"]],
            preconditioner=PrecondType[traffic["preconditioner"]],
            dtype=self.dtype, harness=traffic["harness"],
            tolerance=traffic["tolerance"], max_iters=traffic["max_iters"],
            matrix_format=fmt)
        # the route solve_system would take for this spec and config
        if not bis.device_path(spec, cfg, self.device) or \
                cfg.matrix_format != fmt:
            raise RuntimeError(f"{spec} with {traffic['method']} + "
                               f"{traffic['preconditioner']} does not take "
                               f"the device-native {fmt} route")
        build = (bis.stencil_op.from_source_operator if fmt == "stencil"
                 else bis.dia.from_source_device)
        A = build(spec, dtype=cfg.mat_dtype(), device=self.device)
        self.n = A.n_rows
        zeros = torch.zeros(self.n, dtype=self.dtype, device=self.device)
        self.setup = bis.preprocessing_device(A, cfg, b=zeros, x0=zeros)

    def solve(self, b: torch.Tensor, x0: torch.Tensor):
        """One solve of A·x = b from x0: the port's SolveResult."""
        return self.bis.solve(dataclasses.replace(self.setup, b=b, x0=x0))


def launch_counts() -> dict:
    """Every kernel launch counter of the port's loaded modules
    (`<module>.<function>.<counter>`), found by their `*launches`
    attributes, so a new kernel or route shows without an edit here."""
    out, seen = {}, set()
    for mod_name, mod in sorted(sys.modules.items()):
        if mod is None or mod_name.split(".")[0] != PORT:
            continue
        for attr, fn in sorted(vars(mod).items()):
            if not callable(fn) or id(fn) in seen:
                continue
            counters = {k: v for k, v in getattr(fn, "__dict__", {}).items()
                        if k.endswith("launches") and isinstance(v, int)}
            if counters:
                seen.add(id(fn))
                short = mod_name[len(PORT) + 1:] or PORT
                for k, v in sorted(counters.items()):
                    out[f"{short}.{attr}.{k}"] = v
    return out
