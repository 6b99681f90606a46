"""Time the PyTorch port's host set-up of a coloured preconditioner built
from host CSR, on the CPU: the generator, then `preprocessing` under the
source's grid colour spec with gs_mode "colored" (the factorization and
the superblock pair's NumPy build), float32.  Prints one JSON line.

    python scripts/torch_host_setup.py fdm:2048 ilu0
    python scripts/torch_host_setup.py \\
        anderson:Lx=128,Ly=128,Lz=128,t=1.0,ranpot=4.0,seed=1 sgs --stencil

--stencil injects the source's stencil as the solve operator (A_dev), as
the JAX bench's host fallback does; without it the operator comes from the
CSR, as the JAX CLI's host route builds it.
"""
import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main():
    import torch
    import basic_iterative_solvers_tpu_torch as bt
    p = argparse.ArgumentParser()
    p.add_argument("source")
    p.add_argument("precond", choices=sorted(bt.PRECOND_CLI_NAMES))
    p.add_argument("--stencil", action="store_true")
    args = p.parse_args()
    t0 = time.perf_counter()
    A = bt.generators.from_source(args.source)
    gen_s = time.perf_counter() - t0
    A_dev = (bt.stencil_op.from_source_operator(args.source, torch.float32,
                                                device="cpu")
             if args.stencil else None)
    cfg = bt.SolverConfig(
        preconditioner=bt.PRECOND_CLI_NAMES[args.precond],
        dtype=torch.float32, gs_mode="colored",
        color_spec=bt.generators.color_spec_for_source(args.source))
    t0 = time.perf_counter()
    M = bt.preprocessing(A, cfg, A_dev=A_dev, device="cpu").M
    setup_s = time.perf_counter() - t0

    def mode(B):
        if B is None:
            return None
        if not hasattr(B, "is_plane"):
            return type(B).__name__
        return "table" if B.is_table else "plane" if B.is_plane else (
            "const, per-row D" if B.dinv_rows is not None else "const")

    print(json.dumps({"source": args.source, "precond": args.precond,
                      "stencil": args.stencil, "rows": A.n_rows,
                      "nnz": A.nnz, "generate_s": gen_s, "setup_s": setup_s,
                      "L": mode(M.L_block), "U": mode(M.U_block),
                      "device": "cpu"}))


if __name__ == "__main__":
    main()
