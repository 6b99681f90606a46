"""Which operation moves a float32 mesh BiCGSTAB history off one device's.

Runs the first iterations of chip_smoke's [slice8b] row
pbicgstab@anderson128 (BiCGSTAB + SGS, the coloured host-CSR route with
the stencil injected as the operator, const-mode superblock solves with a
per-row D; b = 2, x0 = 1, tolerance 0, float32) on one device and on the
single-controller Mesh of `--shards` shards bound to that device, and
prints the largest relative difference of the residual histories for
these forms of the stencil SpMV's fused dots (ops/spmv._fused_dots, which
BiCGSTAB takes for r̂·v, t·s and t·t):

* "port": the port's own: float32 products summed in float64 partials
  (one device: its kernel's blocks; the mesh: each shard's blocks, the
  shards summed by Mesh.psum), rounded once (stencil_op.partial_dot);
* "f32_dots": the fused dots summed in float32, a float32 torch.dot over
  one device's rows or over each shard's, the shards summed by psum: how
  the fused dots were summed before they took float64 partials;
* "f64_dots": the fused dots dropped, each taken after the SpMV by
  ops/blas1.whole_dot (products summed in float64, rounded once), on both;
* "witness": one device's solve whose fused dots are the mesh's own under
  "f32_dots" (the mesh SpMV run beside on the same x): it reproduces the
  mesh's "f32_dots" history where the fused dots are all that differ.

It also applies the preconditioner (the mesh's #9 levels) once to the same
vector on both and prints their largest difference, and on a card runs the
mesh once more with every #1 shard launch forced onto the leg loop: the
row's difference before #1's shard box route ("port" is after it).

    python3 scripts/mesh_bicg_witness.py                      # on the card
    python3 scripts/mesh_bicg_witness.py --spec \\
        anderson:Lx=16,Ly=16,Lz=16,t=1.0,ranpot=4.0,seed=1 --device cpu

Prints one JSON line.
"""
import argparse
import contextlib
import importlib
import json
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
ROW = "anderson:Lx=128,Ly=128,Lz=128,t=1.0,ranpot=4.0,seed=1"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spec", default=ROW)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import numpy as np
    import torch

    import basic_iterative_solvers_tpu_torch as bt
    from basic_iterative_solvers_tpu_torch import stencil_op as so
    spmv = importlib.import_module(
        "basic_iterative_solvers_tpu_torch.ops.spmv")
    from basic_iterative_solvers_tpu_torch.parallel import mesh_ops as mo
    from basic_iterative_solvers_tpu_torch.parallel import (make_mesh,
                                                            shard_setup)

    dt, dev = torch.float32, args.device
    A = bt.generators.from_source(args.spec)
    n = A.n_rows
    cfg = bt.SolverConfig(
        method=bt.SolverType.BICGSTAB,
        preconditioner=bt.PrecondType.SYMMETRIC_GAUSS_SEIDEL, dtype=dt,
        harness="fused", gs_mode="colored",
        color_spec=bt.generators.color_spec_for_source(args.spec),
        max_iters=args.iters, tolerance=0.0, breakdown_stall=True)
    s1 = bt.preprocessing(
        A, cfg, b=torch.full((n,), 2.0, dtype=dt, device=dev),
        x0=torch.full((n,), 1.0, dtype=dt, device=dev),
        A_dev=so.from_source_operator(args.spec, dt, device=dev), device=dev)
    mesh = make_mesh(args.shards, device=dev)
    s8 = shard_setup(s1, mesh, mode="shard_map")
    fused = spmv._fused_dots

    def f64_dots(A_, x, dots, aux):
        return None                  # _spmv_dots then takes whole_dot

    def f32_dots(A_, x, dots, aux):
        if not isinstance(A_, (so.DeviceStencil, mo.MeshStencil)):
            return fused(A_, x, dots, aux)
        y = spmv._spmv(A_, x)
        partner = {"x": x, "self": y, "aux": aux}
        if isinstance(A_, mo.MeshStencil):
            parts = [torch.stack([torch.dot(y.shards[k],
                                            partner[d].shards[k])
                                  for d in dots])
                     for k in range(A_.mesh.size)]
            return (y,) + tuple(A_.mesh.psum(parts).unbind())
        return (y,) + tuple(torch.dot(y, partner[d]) for d in dots)

    def witness(A_, x, dots, aux):
        out = f32_dots(A_, x, dots, aux)
        if not isinstance(A_, so.DeviceStencil):
            return out
        on8 = lambda v: mesh.scatter(v, s8.A.blocks.rows)  # noqa: E731
        m = f32_dots(s8.A, on8(x), dots, None if aux is None else on8(aux))
        return (out[0],) + tuple(d.to(dev) for d in m[1:])

    @contextlib.contextmanager
    def form(fn):
        spmv._fused_dots = fn
        try:
            yield
        finally:
            spmv._fused_dots = fused

    def history(setup, fn=fused):
        with form(fn):
            res = bt.solve(setup)
        return np.asarray(res.residual_norms[:args.iters], dtype=np.float64)

    def rel(a, b):
        return float(np.max(np.abs(a - b) / b))

    h = {form: (history(s1, fn), history(s8, fn)) for form, fn in (
        ("port", fused), ("f32_dots", f32_dots), ("f64_dots", f64_dots))}
    wit = history(s1, witness)
    out = {"spec": args.spec, "device": dev, "shards": args.shards,
           "iters": args.iters,
           **{f"{form}_mesh_vs_single": rel(m8, m1)
              for form, (m1, m8) in h.items()},
           "witness_vs_f32_dots_mesh": rel(wit, h["f32_dots"][1]),
           "port_history_single": h["port"][0].tolist(),
           "port_history_mesh": h["port"][1].tolist()}
    # the preconditioner's apply (the #9 levels) on the same vector
    g = torch.Generator(device=dev).manual_seed(7)
    r = torch.randn(n, dtype=dt, device=dev, generator=g)
    from basic_iterative_solvers_tpu_torch.precond import apply_preconditioner
    z1 = apply_preconditioner(s1.M, r)
    z8 = mesh.gather(apply_preconditioner(s8.M,
                                          mesh.scatter(r, s8.A.blocks.rows)))
    out["precond_apply_max_abs_diff"] = float((z8 - z1).abs().max())
    if dev.startswith("cuda"):
        import subprocess
        picker = so.halo_route_for
        try:
            so.halo_route_for = lambda *a, **k: "legs"
            legs = history(s8)
        finally:
            so.halo_route_for = picker
        out["legs_route_mesh_vs_single"] = rel(legs, h["port"][0])
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
