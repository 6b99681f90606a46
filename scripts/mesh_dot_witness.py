"""Where a float32 mesh history departs from one device's: the dots.

Runs the first iterations of the ILU(0)-preconditioned CG row of
chip_smoke's [slice8b] (`fdm:2048` by default: the host-CSR route, b = 2,
x0 = 1, tolerance 0, float32) on one device and on the single-controller
Mesh of `--shards` shards bound to that device, and prints the largest
relative difference of their residual histories for three forms of the
solvers' dots (ops/blas1.whole_dot):

* "port": the port's own, float32 products summed in float64;
* "f32": a float32 `torch.dot`, on one device over all the rows and on
  the mesh per shard, the shards' partials summed by Mesh.psum;
* "witness": one device's solve whose float32 dots are the same shard
  partials summed in psum's order: it reproduces the mesh's "f32"
  history where the dots are all that differ.

With `--time N`, the cost of the port's dots against the float32 ones:
the ms/iter of the same row and of CG on hpcg 128^3 (no preconditioner:
its p·Ap fused into the SpMV kernel, ||r|| a dot), on one device and on
the mesh, N iterations each after a warm-up solve, the two forms in
turns (port, f32, f32, port).

    python3 scripts/mesh_dot_witness.py                  # on the card
    python3 scripts/mesh_dot_witness.py --time 300
    python3 scripts/mesh_dot_witness.py --spec fdm:256 --device cpu

Prints one JSON line.
"""
import argparse
import contextlib
import importlib
import json
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spec", default="fdm:2048")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--time", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import numpy as np
    import torch

    import basic_iterative_solvers_tpu_torch as bt
    from basic_iterative_solvers_tpu_torch.ops import blas1
    # the module (ops/__init__.py exports its function under the same name)
    spmv = importlib.import_module(
        "basic_iterative_solvers_tpu_torch.ops.spmv")
    from basic_iterative_solvers_tpu_torch.parallel import (make_mesh,
                                                            shard_setup)

    dt = torch.float32
    A = bt.generators.from_source(args.spec)
    n = A.n_rows
    cfg = bt.SolverConfig(
        method=bt.SolverType.CONJUGATE_GRADIENT,
        preconditioner=bt.PrecondType.ILU0, dtype=dt, harness="fused",
        gs_mode="colored",
        color_spec=bt.generators.color_spec_for_source(args.spec),
        max_iters=args.iters, tolerance=0.0, breakdown_stall=True)
    s1 = bt.preprocessing(
        A, cfg, b=torch.full((n,), 2.0, dtype=dt, device=args.device),
        x0=torch.full((n,), 1.0, dtype=dt, device=args.device),
        device=args.device)
    s8 = shard_setup(s1, make_mesh(args.shards, device=args.device),
                     mode="shard_map")
    bounds = s8.b.blocks.bounds
    port = blas1.whole_dot

    def f32(a, b):
        return torch.dot(a, b) if a.dtype == torch.float32 else port(a, b)

    def witness(a, b):
        if a.dtype != torch.float32 or a.shape[0] != n:
            return port(a, b)
        return torch.stack([torch.dot(a[lo:hi], b[lo:hi])
                            for lo, hi in bounds]).sum(0)

    @contextlib.contextmanager
    def dots(fn):
        blas1.whole_dot = spmv.whole_dot = fn
        try:
            yield
        finally:
            blas1.whole_dot = spmv.whole_dot = port

    def history(setup, fn):
        with dots(fn):
            res = bt.solve(setup)
        return np.asarray(res.residual_norms[:args.iters], dtype=np.float64)

    def rel(a, b):
        return float(np.max(np.abs(a - b) / b))

    h = {"port": (history(s1, port), history(s8, port)),
         "f32": (history(s1, f32), history(s8, f32))}
    wit = history(s1, witness)
    out = {"spec": args.spec, "device": args.device, "shards": args.shards,
           "iters": args.iters,
           "port_mesh_vs_single": rel(h["port"][1], h["port"][0]),
           "f32_mesh_vs_single": rel(h["f32"][1], h["f32"][0]),
           "witness_vs_f32_mesh": rel(wit, h["f32"][1]),
           "port_vs_f32_single": rel(h["port"][0], h["f32"][0])}
    if args.time:
        import dataclasses

        def timed(setup):
            setup = dataclasses.replace(setup, config=dataclasses.replace(
                setup.config, max_iters=args.time))
            bt.solve(setup)                              # warm-up solve
            turns = {"port": [], "f32": []}
            for form in ("port", "f32", "f32", "port"):
                with dots({"port": port, "f32": f32}[form]):
                    res = bt.solve(setup)
                turns[form].append(1e3 * res.solve_seconds
                                   / max(1, res.iter_count))
            return turns

        cg = bt.stencil_op.from_source_operator("hpcg:128x128x128", dt,
                                                device=args.device)
        m = cg.n_rows
        s_cg = bt.preprocessing_device(
            cg, dataclasses.replace(
                cfg, preconditioner=bt.PrecondType.NONE, gs_mode="auto",
                color_spec=None),
            b=torch.full((m,), 2.0, dtype=dt, device=args.device),
            x0=torch.full((m,), 1.0, dtype=dt, device=args.device))
        mesh_cg = shard_setup(s_cg, make_mesh(args.shards,
                                              device=args.device),
                              mode="shard_map")
        out["ms_per_iter_in_turns"] = {
            args.spec: timed(s1), f"{args.spec} mesh": timed(s8),
            "hpcg:128x128x128 cg": timed(s_cg),
            "hpcg:128x128x128 cg mesh": timed(mesh_cg)}
    if args.device.startswith("cuda"):
        import subprocess
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
