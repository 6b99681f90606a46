"""Readings that the limits of limits/<cell>.json are set from (chip only).

    python3 solverbench/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9

For each of `--seeds`, the program solves the cell's first
`checked_solves` right-hand sides of that seed through the same entry as
a run's window, and check.judge reads them as it reads a run's sample
(one process, one set-up).  For each of `--control-seeds`, the control
does the same: the plain reference's CG put in the program's place,
computed in bfloat16, the precision below the configuration's float32
(the coefficients 26 and −1 are exact in bfloat16, so only lowering the
solve itself changes the answer).  Prints one JSON line a seed, then the
largest program reading and the smallest control reading of each number.
The benchmark's runs do not run this.
"""
import argparse
import gc
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from solverbench import cells, check, reference  # noqa: E402
from solverbench import traffic as gen  # noqa: E402

CONTROL_DTYPE = torch.bfloat16


def readings(cell, seed, answers, failed, device):
    """check.judge's values for one seed's answers, with no limits."""
    inf = {k: float("inf") for k in check.NAMES}
    _, checks = check.judge(cell.config, cell.traffic, seed, answers, failed,
                            inf, device)
    return {k: c["value"] for k, c in checks.items()}


def answers(cell, seeds, solve, device):
    """{seed: (answers, failed, iterations)}: `solve(b, x0) -> (x,
    iterations, converged)` on the first `checked_solves` right-hand sides
    of each seed."""
    config, traffic = cell.config, cell.traffic
    dtype = getattr(torch, config["dtype"])
    rhs_op = reference.StencilOp(config["grid"], config["stencil"])
    out = {}
    for seed in seeds:
        found, failed, iters = [], 0, []
        for index in range(traffic["checked_solves"]):
            _, b = gen.rhs(rhs_op, traffic, seed, index, dtype, device)
            x, k, converged = solve(b, torch.full_like(b, traffic["x0"]))
            failed += not converged
            iters.append(k)
            found.append((index, x.to(dtype).cpu()))
        out[seed] = (found, failed, iters)
    return out


def program_answers(cell, seeds, device):
    from solverbench.program import Program
    program = Program(cell.config, cell.traffic, device)

    def solve(b, x0):
        res = program.solve(b, x0)
        return res.x_star, res.iter_count, res.converged
    out = answers(cell, seeds, solve, device)
    del program, solve
    gc.collect()
    torch.cuda.empty_cache()
    return out


def control_answers(cell, seeds, device):
    traffic = cell.traffic
    op = reference.operator(cell.config, CONTROL_DTYPE, device)
    return answers(cell, seeds, lambda b, x0: reference.cg(
        op, b, x0, traffic["tolerance"], traffic["max_iters"],
        CONTROL_DTYPE), device)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    args = p.parse_args(argv)
    cell = cells.load_cell(args.workload)
    dev = torch.device("cuda")
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctrl = [int(s) for s in args.control_seeds.split(",") if s]
    summary = {}
    for who, fn, ss in (("program", program_answers, seeds),
                        ("control", control_answers, ctrl)):
        if not ss:
            continue
        for seed, (found, failed, iters) in fn(cell, ss, dev).items():
            r = readings(cell, seed, found, failed, dev)
            print(json.dumps({"cell": cell.name, "who": who, "seed": seed,
                              "iters": iters, **r}), flush=True)
            for k, v in r.items():
                v = float("inf") if v is None else v
                summary.setdefault(who, {}).setdefault(k, []).append(v)
    out = {"cell": cell.name, "limits": cell.limits}
    if "program" in summary:
        out["lower"] = {k: max(v) for k, v in summary["program"].items()}
    if "control" in summary:
        out["upper"] = {k: min(v) for k, v in summary["control"].items()}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
