"""Time solver rows of the PyTorch port on one CUDA card through its
public entry points, for comparing two checkouts of the port in turns.
Prints the card's name and power limit, then one JSON line per row.

    python3 scripts/row_times.py                      # this checkout
    python3 scripts/row_times.py --tree build/parent  # another checkout
    python3 scripts/row_times.py --rows pcg_ilu0 --repeats 3

Rows (f32, fused, tolerance 0, b = 2, x0 = 1, the bench's iteration
counts): `cg` (CG on HPCG 128^3, 2500 iterations), `pcg_mg` (CG + the
multigrid V-cycle on HPCG 128^3, 1200), `pcg_ilu0` (CG + ILU(0) on HPCG
128^3, 1200 iterations, the factor-table levels), `mesh_pcg_ilu0` (the
same on an 8-shard mesh bound to the one card) and `mesh_cg_sband` (CG on
sband:500000,8,400 in lane-ELL on that mesh, 400 iterations).  Each row
runs one warm-up solve, then `--repeats` timed ones: ms/iter from the
solve's own clock.  `spmv_x` is one call of `stencil_spmv(A, x, ("x",))`
at HPCG 128^3 f32 (the fused SpMV with its dot, host and card): ms a call
by CUDA events over 1000 calls, `--repeats` times.  Run the
checkouts in turns within one machine (A, B, B, A): a card may be set
below its power maximum, and the mesh rows are bound by the host.
"""
import argparse
import json
import pathlib
import subprocess
import sys

ROWS = ("cg", "pcg_mg", "pcg_ilu0", "mesh_pcg_ilu0", "mesh_cg_sband",
        "spmv_x")


def _setups(torch, bt, name):
    """The row's single-device setup, and whether it runs on the mesh."""
    dt, dev = torch.float32, "cuda"
    if name.endswith("cg_sband"):
        A = bt.generators.from_source("sband:500000,8,400")
        cfg = bt.SolverConfig(dtype=dt, harness="fused", tolerance=0.0,
                              max_iters=400, breakdown_stall=True,
                              matrix_format="lane_ell")
        return bt.preprocessing(
            A, cfg, b=torch.full((A.n_rows,), 2.0, device=dev),
            x0=torch.full((A.n_rows,), 1.0, device=dev), device=dev)
    A = bt.stencil_op.from_source_operator("hpcg:128x128x128", dt,
                                           device=dev)
    precond, iters = {"cg": (bt.PrecondType.NONE, 2500),
                      "pcg_mg": (bt.PrecondType.MULTIGRID, 1200)}.get(
        name, (bt.PrecondType.ILU0, 1200))
    cfg = bt.SolverConfig(preconditioner=precond, dtype=dt,
                          harness="fused", tolerance=0.0, max_iters=iters,
                          breakdown_stall=True)
    return bt.preprocessing_device(
        A, cfg, b=torch.full((A.n_rows,), 2.0, device=dev),
        x0=torch.full((A.n_rows,), 1.0, device=dev))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--tree", default=str(pathlib.Path(__file__).resolve()
                                         .parent.parent),
                   help="the checkout whose package is timed")
    p.add_argument("--rows", default=",".join(ROWS))
    p.add_argument("--repeats", type=int, default=2)
    args = p.parse_args()
    tree = pathlib.Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import torch
    import basic_iterative_solvers_tpu_torch as bt
    from basic_iterative_solvers_tpu_torch.parallel import (make_mesh,
                                                            shard_setup)
    from basic_iterative_solvers_tpu_torch.solvers import make_method
    if not torch.cuda.is_available():
        raise SystemExit("row_times: no CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    for name in args.rows.split(","):
        if name not in ROWS:
            raise SystemExit(f"row_times: unknown row {name!r}")
        if name == "spmv_x":
            A = bt.stencil_op.from_source_operator(
                "hpcg:128x128x128", torch.float32, device="cuda")
            x = torch.randn(A.n_rows, device="cuda")
            ms = []
            for _ in range(1 + args.repeats):         # one warm-up batch
                t0, t1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                t0.record()
                for _ in range(1000):
                    bt.stencil_op.stencil_spmv(A, x, ("x",))
                t1.record()
                t1.synchronize()
                ms.append(t0.elapsed_time(t1) / 1000)
            print(json.dumps({"tree": str(tree), "row": name,
                              "ms_per_call": ms[1:]}))
            continue
        setup = _setups(torch, bt, name)
        if name.startswith("mesh_"):
            setup = shard_setup(setup, make_mesh(8, device="cuda"),
                                mode="shard_map")
        method = make_method(setup)
        bt.solve(setup, method=method)                 # warm-up solve
        ms = []
        for _ in range(args.repeats):
            res = bt.solve(setup, method=method)
            if res.iter_count != setup.config.max_iters:
                raise RuntimeError(f"{name}: {res.iter_count} iterations")
            ms.append(1e3 * res.solve_seconds / res.iter_count)
        print(json.dumps({"tree": str(tree), "row": name,
                          "iters": res.iter_count, "ms_per_iter": ms}))
        del setup, method
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
