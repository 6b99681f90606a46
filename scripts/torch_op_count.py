"""Count the PyTorch operations one solver iteration issues, by name.

    python scripts/torch_op_count.py hpcg:128x128x128 cg mg
    python scripts/torch_op_count.py hpcg:32x32x32 cg --cg-flavor pipelined

Runs on the CPU (the kernels' plain versions stand in for them, one
operation each: a stencil SpMV counts as one `stencil_spmv` launch).  It
sets up the solve as the fused f32 rows do (b = 2, x0 = 1), runs one
iteration of the method outside any harness and prints the count of
stencil SpMVs and of the other aten operations, and among those the ones
that compute (views, reshapes and permutes launch nothing): the kernel
launches an iteration issues on a card, the fused harness's own few
aside.  A count, not a time.
"""
import argparse
import collections
import sys
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import basic_iterative_solvers_tpu_torch as bt  # noqa: E402
from basic_iterative_solvers_tpu_torch import stencil_op  # noqa: E402
from basic_iterative_solvers_tpu_torch.solvers import make_method  # noqa: E402


#: aten operations that only describe a tensor and launch no kernel
_VIEWS = {"view", "_unsafe_view", "expand", "permute", "transpose", "t",
          "reshape", "as_strided", "slice", "select", "unsqueeze",
          "squeeze", "alias", "detach"}


class _Count(TorchDispatchMode):
    """Counts aten operations, except while `paused` (inside a plain
    SpMV, which stands for one kernel launch)."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()
        self.paused = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.paused:
            self.ops[str(func.overloadpacket.__name__)] += 1
        return func(*args, **(kwargs or {}))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("source")
    ap.add_argument("method", nargs="?", default="cg")
    ap.add_argument("precond", nargs="?", default="none")
    ap.add_argument("--cg-flavor", default="classic")
    a = ap.parse_args()
    A = stencil_op.from_source_operator(a.source, torch.float32, device="cpu")
    n = A.n_rows
    cfg = bt.SolverConfig(
        method=bt.SOLVER_CLI_FLAGS["-" + a.method],
        preconditioner=bt.PRECOND_CLI_NAMES[a.precond],
        dtype=torch.float32, cg_flavor=a.cg_flavor)
    setup = bt.preprocessing_device(
        A, cfg, b=torch.full((n,), 2.0), x0=torch.full((n,), 1.0))
    method = make_method(setup)
    state = method.iterate(method.init_state())   # caches filled
    spmv_before = stencil_op.stencil_spmv.launches
    calls = collections.Counter()
    orig = stencil_op.stencil_spmv_plain
    mode = _Count()

    def counted(*args, **kw):
        calls["stencil_spmv"] += 1
        mode.paused = True
        try:
            return orig(*args, **kw)
        finally:
            mode.paused = False

    stencil_op.stencil_spmv_plain = counted
    try:
        with mode:
            method.iterate(state)
    finally:
        stencil_op.stencil_spmv_plain = orig
    assert stencil_op.stencil_spmv.launches == spmv_before
    print(f"{a.source} {a.method} -p {a.precond} ({a.cg_flavor}): "
          f"{calls['stencil_spmv']} stencil SpMVs an iteration; "
          f"{sum(mode.ops.values())} aten operations besides, "
          f"{sum(c for k, c in mode.ops.items() if k not in _VIEWS)} of "
          "them computing:")
    print(dict(mode.ops.most_common()))


if __name__ == "__main__":
    main()
