"""Run one cell of the benchmark of basic_iterative_solvers_tpu_torch.

    python3 solverbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for.  A cell is a closed loop with one caller who solves right-hand side
after right-hand side against one operator:

* set-up (`setup_s`, from process start): the port's operator on the
  card, its preconditioner, one warm-up solve of the cell's own shapes
  (the port builds its kernels into build/ inside the checkout then);
* the window: solves back to back through the port's `solve`, each with
  a fresh b made on the card from (seed, solve index) just before its
  call, until the solves have taken `--seconds`; the last solve started
  before then finishes.  A solve is timed from the call to x and its
  float64 residual on hand after a synchronize; making b and copying a
  sampled answer off the card are the benchmark's work and lie between
  the timed stretches, so the window is the sum of those stretches;
* after it: peak memory is read, the program's state freed, and the plain
  reference judges a sample of the answers (check.py).

With `--trace 1` a few whole solves a third of the way into the window
run under torch.profiler, each call to the port inside its own span, and
the result carries the per-layer metrics;
with `--trace 0` the end-to-end ones.  The last line of standard output
is the result, one JSON object; the numbers compared for `correct` are
the last lines of standard error.
"""
import time

T_START = time.perf_counter()   # set-up counts from here

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

T_IMPORTED = time.perf_counter()

from solverbench import cells, check, reference  # noqa: E402
from solverbench import trace as tr  # noqa: E402
from solverbench import traffic as gen  # noqa: E402

#: top-level module names no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "basic_iterative_solvers_tpu")


@dataclasses.dataclass
class Solve:
    index: int
    iters: int
    #: from the call to x and its residual on hand
    seconds: float
    ok: bool
    traced: bool


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    cell: cells.Cell
    itemsize: int
    setup_s: float
    #: the solves' timed stretches, summed
    window_s: float
    solves: list
    memory_peak_bytes: int
    slice: tr.TraceSlice = None


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out = f"nvidia-smi failed: {e}"
    return f"card (name, power limit): {out}"


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _profiler(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _read_slice(prof) -> tr.TraceSlice:
    tmp = tempfile.mkdtemp(prefix="solverbench_trace_")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        return tr.TraceSlice.from_file(path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def measure(cell: cells.Cell, seed: int, seconds: float, trace: bool,
            device="cuda", t_start: float = None) -> dict:
    """One run of `cell`: the result's dict (see the module docstring)."""
    from solverbench.program import Program, launch_counts
    t_start = T_START if t_start is None else t_start
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    config, traffic = cell.config, cell.traffic
    dtype = getattr(torch, config["dtype"])
    rhs_op = reference.StencilOp(config["grid"], config["stencil"])
    t_prog = time.perf_counter()
    program = Program(config, traffic, dev)
    t_built = time.perf_counter()
    n = program.n
    solves = []
    reservoir = check.Reservoir(traffic["checked_solves"], n, dtype, seed,
                                dev)
    t_res = time.perf_counter()

    def one(index: int, traced: bool = False) -> float:
        """Solve `index`: its timed stretch, in seconds."""
        _, b = gen.rhs(rhs_op, traffic, seed, index, dtype, dev)
        x0 = torch.full((n,), traffic["x0"], dtype=dtype, device=dev)
        sync()
        span = (torch.profiler.record_function(tr.SPAN) if traced
                else contextlib.nullcontext())
        t0 = time.perf_counter()
        with span:
            res = program.solve(b, x0)
            sync()
        t1 = time.perf_counter()
        if index == gen.WARMUP:
            reservoir.bufs[0].copy_(res.x_star)  # the copy path, warm
            return t1 - t0
        ok = res.converged and math.isfinite(res.final_residual_norm)
        solves.append(Solve(index, res.iter_count, t1 - t0, ok, traced))
        reservoir.offer(index, res.x_star)
        return t1 - t0

    one(gen.WARMUP)
    t_warm = time.perf_counter()
    if trace:
        with _profiler(dev):                     # the profiler, warm
            torch.ones(1, device=dev).add_(1)
            sync()
    sync()
    counts0 = launch_counts()

    t_w0 = time.perf_counter()
    setup_s = t_w0 - t_start
    log(f"set-up {setup_s:.3f} s: to torch imported "
        f"{T_IMPORTED - t_start:.3f}, to the program's build "
        f"{t_prog - T_IMPORTED:.3f}, operator and preconditioner "
        f"{t_built - t_prog:.3f}, answer buffers {t_res - t_built:.3f}, "
        f"warm-up solve {t_warm - t_res:.3f}, the rest {t_w0 - t_warm:.3f}")
    prof, index, window_s = None, 0, 0.0
    while True:
        if trace and prof is None and window_s >= seconds / 3:
            prof = _profiler(dev)
            with prof:
                for _ in range(traffic["traced_solves"]):
                    window_s += one(index, traced=True)
                    index += 1
            continue
        if index > 0 and window_s >= seconds:
            break
        window_s += one(index)
        index += 1
    wall_s = time.perf_counter() - t_w0
    log(f"window: the solves took {window_s:.4f} s of {wall_s:.4f} s; "
        f"making b, sampling answers{', tracing' if trace else ''} "
        f"between them {wall_s - window_s:.4f} s "
        f"({100 * (wall_s - window_s) / window_s:.2f}% of the solves')")
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    counts1 = launch_counts()
    print("kernel launches in the window: " + json.dumps(
        {k: v - counts0.get(k, 0) for k, v in counts1.items()
         if v != counts0.get(k, 0)}), flush=True)
    log("solves: " + " ".join(f"{s.index}:{s.iters}:{s.seconds:.4f}"
                              + ("" if s.ok else ":failed")
                              + (":traced" if s.traced else "")
                              for s in solves))

    del program
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    slice_ = _read_slice(prof) if prof is not None else None
    prof = None
    failed = sum(1 for s in solves if not s.ok)
    correct, checks = check.judge(config, traffic, seed, reservoir.samples(),
                                  failed, cell.limits, dev)

    run = Run(cell=cell, itemsize=torch.empty((), dtype=dtype).element_size(),
              setup_s=setup_s, window_s=window_s, solves=solves,
              memory_peak_bytes=peak, slice=slice_)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cells.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda
                   else dev.type,
                   "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": len(solves), "failed": failed,
              "metrics": metrics, "device": device_info}
    if slice_ is not None:
        device_info.update(busy_s=slice_.busy_s, window_s=slice_.window_s)
        result["breakdown"] = {"device_ops": slice_.device_ops(),
                               "idle_gaps": slice_.idle_gaps()}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bis_env = {k: v for k, v in sorted(os.environ.items())
               if k.startswith("BIS_")}
    print("BIS_* environment: " + json.dumps(bis_env), flush=True)
    if bis_env:
        log("refusing to measure: the port's BIS_* switches must be unset")
        return 2
    cell = cells.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"refusing to measure: {args.workload} needs {cell.chips} CUDA "
            f"device(s), this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    print(card_line(), flush=True)
    result = measure(cell, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        log("refusing to report: the run loaded " + ", ".join(bad))
        return 3
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
