"""Time the PyTorch port's host set-up of one row built from host CSR: the
generator, then `preprocessing` (the factorization, the colouring, the
solve pair's and the operator's builds, the copies to `--device`),
float32; the host library's build and the CUDA context come before the
clock starts.  A preconditioned row runs under the source's colour spec
with gs_mode "colored".  Prints one JSON line.

    python scripts/torch_host_setup.py fdm:2048 ilu0
    python scripts/torch_host_setup.py \\
        anderson:Lx=128,Ly=128,Lz=128,t=1.0,ranpot=4.0,seed=1 sgs --stencil
    python scripts/torch_host_setup.py band:8388608,2 sgs --method bi
    python scripts/torch_host_setup.py sband:500000,8,400 none \\
        --format lane_ell --device cuda --numpy

--stencil injects the source's stencil as the solve operator (A_dev), as
the JAX bench's host fallback does; without it the operator comes from the
CSR, as the JAX CLI's host route builds it.  --numpy sets
BIS_TPU_NO_NATIVE=1 before anything runs, so every host pass takes its
NumPy branch instead of the native host library.
"""
import argparse
import json
import os
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

METHODS = {"cg": "CONJUGATE_GRADIENT", "bi": "BICGSTAB", "gm": "GMRES"}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("source")
    p.add_argument("precond")
    p.add_argument("--method", choices=sorted(METHODS), default="cg")
    p.add_argument("--format", default="auto",
                   help="matrix_format of the operator from the CSR")
    p.add_argument("--stencil", action="store_true")
    p.add_argument("--device", default="cpu")
    p.add_argument("--numpy", action="store_true",
                   help="the NumPy branches (BIS_TPU_NO_NATIVE=1)")
    args = p.parse_args()
    if args.numpy:
        os.environ["BIS_TPU_NO_NATIVE"] = "1"
    import torch
    import basic_iterative_solvers_tpu_torch as bt
    from basic_iterative_solvers_tpu_torch import _native
    if args.precond not in bt.PRECOND_CLI_NAMES:
        p.error(f"precond must be one of {sorted(bt.PRECOND_CLI_NAMES)}")
    if _native.available():
        _native.build()               # the library's build is not set-up
    if args.device.startswith("cuda"):
        torch.empty(1, device=args.device)      # nor is the CUDA context
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    A = bt.generators.from_source(args.source)
    gen_s = time.perf_counter() - t0
    A_dev = (bt.stencil_op.from_source_operator(args.source, torch.float32,
                                                device=args.device)
             if args.stencil else None)
    cfg = bt.SolverConfig(
        method=bt.SolverType[METHODS[args.method]],
        preconditioner=bt.PRECOND_CLI_NAMES[args.precond],
        dtype=torch.float32, gs_mode="colored", matrix_format=args.format,
        color_spec=bt.generators.color_spec_for_source(args.source))
    t0 = time.perf_counter()
    setup = bt.preprocessing(A, cfg, A_dev=A_dev, device=args.device)
    if args.device.startswith("cuda"):
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    def mode(B):
        if B is None:
            return None
        if not hasattr(B, "is_plane"):
            return type(B).__name__
        return "table" if B.is_table else "plane" if B.is_plane else (
            "const, per-row D" if B.dinv_rows is not None else "const")

    M = setup.M
    print(json.dumps({"source": args.source, "precond": args.precond,
                      "method": args.method, "stencil": args.stencil,
                      "host": "native" if _native.available() else "numpy",
                      "rows": A.n_rows, "nnz": A.nnz, "generate_s": gen_s,
                      "setup_s": setup_s, "operator": type(setup.A).__name__,
                      "L": mode(M.L_block), "U": mode(M.U_block),
                      "device": args.device}))


if __name__ == "__main__":
    main()
