"""Where the host time of a mesh CG iteration goes, on one CUDA card.

The shard_map mode's single-controller Mesh is host-bound on one card:
one Python thread issues every shard's work.  This script runs the CG
row of chip_smoke's [slice8] (hpcg 128^3 stencil, float32, no
preconditioner, b = 2, x0 = 1, tolerance 0, fused harness) on a Mesh of
`--shards` shards bound to the card, after a warm-up solve, once plain
and once with a host clock around

* "dispatch": MeshVector.__torch_dispatch__ (every vector op of the
  solver on a MeshVector, shard by shard; it holds the psum of a dot);
* "spmv": the mesh stencil SpMV (parallel/mesh_ops.mesh_stencil_spmv; it
  holds the halo exchange, the windows, the launches and the fused dots'
  psum);
* "ppermute", "psum": the Mesh's collectives, wherever they are called;
* "launch": the hand-kernel launch helper (_build.launch).

Each clock is inclusive, and counts a nested call of its own kind once.
Prints one JSON line: ms/iter plain and clocked, each clock's share of
the clocked solve's wall time and its calls an iteration, and the aten
ops an iteration that reach __torch_dispatch__.

    python3 scripts/mesh_host_share.py
    python3 scripts/mesh_host_share.py --shards 8 --iters 200
"""
import argparse
import collections
import json
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spec", default="hpcg:128x128x128")
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import torch

    import basic_iterative_solvers_tpu_torch as bt
    from basic_iterative_solvers_tpu_torch import _build
    from basic_iterative_solvers_tpu_torch.parallel import (make_mesh,
                                                            mesh_ops,
                                                            shard_setup)
    from basic_iterative_solvers_tpu_torch.parallel import sharded
    from basic_iterative_solvers_tpu_torch.parallel.mesh_vector import (
        MeshVector)

    dt = torch.float32
    A = bt.stencil_op.from_source_operator(args.spec, dt, device=args.device)
    n = A.n_rows
    cfg = bt.SolverConfig(method=bt.SolverType.CONJUGATE_GRADIENT, dtype=dt,
                          harness="fused", max_iters=args.iters,
                          tolerance=0.0, breakdown_stall=True)
    s1 = bt.preprocessing_device(
        A, cfg, b=torch.full((n,), 2.0, dtype=dt, device=args.device),
        x0=torch.full((n,), 1.0, dtype=dt, device=args.device))
    s8 = shard_setup(s1, make_mesh(args.shards, device=args.device),
                     mode="shard_map")
    bt.solve(s8)                                        # warm-up solve

    def per_iter(res):
        return 1e3 * res.solve_seconds / max(1, res.iter_count)

    plain = bt.solve(s8)

    spent = collections.Counter()
    calls = collections.Counter()
    ops = collections.Counter()
    depth = collections.Counter()

    def clocked(kind, fn):
        def wrapped(*a, **kw):
            calls[kind] += 1
            depth[kind] += 1
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                depth[kind] -= 1
                if not depth[kind]:
                    spent[kind] += time.perf_counter() - t0
        return wrapped

    dispatch = MeshVector.__torch_dispatch__.__func__

    def counted(cls, func, types, a=(), kw=None):
        ops[str(func)] += 1
        return dispatch(cls, func, types, a, kw)

    saved = (MeshVector.__dict__["__torch_dispatch__"],
             mesh_ops.mesh_stencil_spmv, sharded.Mesh.ppermute,
             sharded.Mesh.psum, _build.launch)
    MeshVector.__torch_dispatch__ = classmethod(clocked("dispatch", counted))
    mesh_ops.mesh_stencil_spmv = clocked("spmv", saved[1])
    sharded.Mesh.ppermute = clocked("ppermute", saved[2])
    sharded.Mesh.psum = clocked("psum", saved[3])
    _build.launch = clocked("launch", saved[4])
    try:
        torch.cuda.synchronize() if args.device == "cuda" else None
        t0 = time.perf_counter()
        res = bt.solve(s8)
        wall = time.perf_counter() - t0
    finally:
        (MeshVector.__torch_dispatch__, mesh_ops.mesh_stencil_spmv,
         sharded.Mesh.ppermute, sharded.Mesh.psum, _build.launch) = saved
    it = max(1, res.iter_count)
    out = {"spec": args.spec, "shards": args.shards,
           "iters": res.iter_count,
           "ms_per_iter_plain": per_iter(plain),
           "ms_per_iter_clocked": per_iter(res),
           "wall_s_clocked": wall,
           "share_of_wall": {k: v / wall for k, v in spent.items()},
           "calls_per_iter": {k: v / it for k, v in calls.items()},
           "dispatch_ops_per_iter": {k: v / it
                                     for k, v in ops.most_common()}}
    if args.device == "cuda":
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
