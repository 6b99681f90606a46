"""Device times of a fused solve from a torch.profiler trace.

The port's counterpart of the JAX package's utils/xprof.py.  The fused
harness (solvers/fused.py) launches each iteration's kernels without
waiting for them, so host clocks cannot see where an iteration ends on the
card.  These functions run the method's fused loop again from its initial
state under `torch.profiler` (CPU and CUDA activities), read the CUDA
kernels' device start times and durations from the exported trace, and:

* `measure_iteration_times` / `attach_iteration_times` (--iter-times):
  segment the kernel timeline on its period, one iteration from one start
  of a marker kernel to the next (the marker: the earliest-starting kernel
  name that occurs exactly once an iteration);
* `measure_phase_table` / `print_phase_table` (--kernel-timers under the
  fused harness): sum the kernels' device times by phase bucket
  (`bucket_of`: the port's SpMV kernels, level kernels and basis kernels
  by name, PyTorch's elementwise, reduction and BLAS kernels as blas1,
  copies and fills as layout_glue).

The re-run asks for exactly the iterations the solve ran, with tolerance
0 and max_iters = iterations + restarts, so that the fused loop's gated
no-op steps past a stop (up to CHECK_EVERY − 1 of them) do not enter the
trace; it launches the same kernels an iteration as the solve did.  Off
the card these return None, as the JAX module does off the TPU.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
import tempfile
from typing import Optional

import numpy as np
import torch

#: trace categories of device activity (torch.profiler's chrome trace)
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

#: kernel-name fragments → phase buckets, tried in order
PHASE_BUCKETS = (
    ("spmv", ("stencil_spmv_kernel", "stencil_spmv_stream_kernel",
              "stencil_spmv_box_kernel", "stencil_spmv_stream_box_kernel",
              "stencil_gs_color_step_kernel",
              "stencil_gs_color_step_box_kernel", "dia_spmv_kernel",
              "lane_ell_spmv_kernel", "stencil_spmv_halo_kernel",
              "stencil_spmv_halo_box_kernel",
              "stencil_gs_color_step_halo_kernel", "dia_spmv_halo_kernel",
              "lane_ell_spmv_halo_kernel",
              "lane_ell_spmv_halo_padded_kernel")),
    ("sptrsv", ("super_level_kernel", "super_level_staged_kernel",
                "super_level_line_kernel", "super_acc_kernel",
                "super_acc_staged_kernel", "super_acc_line_kernel",
                "super_parity_kernel", "super_parity_staged_kernel",
                "super_parity_line_kernel", "super_solve_mega_kernel",
                "super_solve_brick_kernel", "rank_level_kernel",
                "rank_level_vec_kernel")),
    ("orthog", ("project_gram_kernel", "correct_write_kernel")),
    ("layout_glue", ("Memcpy", "Memset", "copy_kernel", "CatArrayBatchedCopy",
                     "fill_kernel", "FillFunctor")),
    ("blas1", ("elementwise_kernel", "reduce_kernel", "dot_kernel",
               "reduce_1Block_kernel", "gemv", "gemm", "splitKreduce",
               "scatter", "index")),
)


def bucket_of(kernel_name: str) -> str:
    """The phase bucket of a device activity's name, "other" if none."""
    for bucket, fragments in PHASE_BUCKETS:
        for f in fragments:
            if f in kernel_name:
                return bucket
    return "other"


def _events(path: str):
    with open(path) as f:
        return [e for e in json.load(f).get("traceEvents", [])
                if e.get("ph") == "X"]


def load_device_events(path: str):
    """The device activities (kernels, copies, fills) of a torch.profiler
    chrome trace, sorted by start: dicts with name, ts and dur in µs."""
    ops = [e for e in _events(path) if e.get("cat") in _DEVICE_CATS]
    ops.sort(key=lambda e: e["ts"])
    return ops


def lost_launches(path: str) -> int:
    """The kernel launches of a trace (the host's cudaLaunch* calls) whose
    device record is missing: 0 for a complete trace."""
    events = _events(path)
    device = {e.get("args", {}).get("correlation") for e in events
              if e.get("cat") in _DEVICE_CATS}
    return sum(1 for e in events if e.get("cat") == "cuda_runtime"
               and "Launch" in e.get("name", "")
               and e.get("args", {}).get("correlation") not in device)


def trace_miss_report(ops, n_iters: int, lost: int = 0) -> str:
    """Why a trace gave no iteration times: its count of device events,
    n_iters, the three kernel names whose counts are nearest n_iters, with
    their counts, and the launches whose device record it lost."""
    counts = collections.Counter(e["name"] for e in ops)
    near = sorted(counts.items(), key=lambda kv: (abs(kv[1] - n_iters),
                                                  kv[0]))[:3]
    return (f"{len(ops)} device events, n_iters={n_iters}, nearest counts: "
            + "; ".join(f"{c} x {name[:80]}" for name, c in near)
            + f"; {lost} launches without a device record")


def iteration_times_from_trace(path: str, n_iters: int, why=None):
    """Per-iteration device walls (seconds) of a trace holding exactly
    `n_iters` iterations, or None when no kernel name occurs exactly
    n_iters times (then, with a list `why`, trace_miss_report's text is
    appended to it).  Iteration k runs from the k-th start of the marker
    to the next; the last one to the end of the last device activity."""
    ops = load_device_events(path)
    counts = collections.Counter(e["name"] for e in ops)
    cands = {n for n, c in counts.items() if c == n_iters}
    if not cands or n_iters < 1:
        if why is not None:
            why.append(trace_miss_report(ops, n_iters, lost_launches(path)))
        return None
    marker = next(e["name"] for e in ops if e["name"] in cands)
    starts = np.array([e["ts"] for e in ops if e["name"] == marker])
    end = max(e["ts"] + e.get("dur", 0) for e in ops)
    return np.diff(np.append(starts, end)) * 1e-6   # trace times are µs


def phase_table_from_trace(path: str):
    """(table, meta): device seconds by phase bucket, and meta with
    'device_wall' (first activity's start to the last one's end), 'n_ops'
    and 'per_op' (seconds by name, largest first); None for a trace with
    no device activity."""
    ops = load_device_events(path)
    if not ops:
        return None
    table = collections.defaultdict(float)
    per_op = collections.defaultdict(float)
    for e in ops:
        d = e.get("dur", 0) * 1e-6
        table[bucket_of(e["name"])] += d
        per_op[e["name"]] += d
    t0 = ops[0]["ts"]
    t1 = max(e["ts"] + e.get("dur", 0) for e in ops)
    meta = {"device_wall": (t1 - t0) * 1e-6, "n_ops": len(ops),
            "per_op": dict(sorted(per_op.items(), key=lambda kv: -kv[1]))}
    return dict(table), meta


def _exact_rerun(method, n_iters: int, restarts: int):
    """A method over the same setup whose fused loop runs exactly n_iters
    iterations (tolerance 0, max_iters = n_iters + restarts), the setup's
    cached operands carried over."""
    from ..solvers.factory import make_method
    setup = method.setup
    cfg = dataclasses.replace(setup.config, tolerance=0.0,
                              max_iters=n_iters + restarts)
    rerun = dataclasses.replace(setup, config=cfg)
    rerun.__dict__.update({k: v for k, v in setup.__dict__.items()
                           if k.startswith("_")})
    return make_method(rerun)


#: traces of a fused loop taken until one holds every launch's device
#: record (trace_fused)
TRACE_ATTEMPTS = 3


def trace_fused(method, n_iters: int, restarts: int = 0) -> Optional[str]:
    """Run the method's fused loop again, exactly n_iters iterations, under
    torch.profiler, and write its chrome trace to a temporary file; returns
    its path, or None off the card or where the method has no fused
    loop.  The profiler may lose the device records of a trace's first
    kernels (on an H100, 3 of 42 traces of hpcg:64x64x64 CG lacked those
    of their first 7 to 195 launches): a trace with any launch lacking
    its record (lost_launches) is taken again, up to TRACE_ATTEMPTS
    times, and the last one is returned as it is."""
    setup = getattr(method, "setup", None)
    if (setup is None or not getattr(method, "supports_fused", False)
            or setup.b.device.type != "cuda" or n_iters < 1):
        return None
    from torch.profiler import ProfilerActivity, profile
    m = _exact_rerun(method, n_iters, restarts)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    for _ in range(TRACE_ATTEMPTS):
        torch.cuda.synchronize(setup.b.device)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            m.solve_fused()
            torch.cuda.synchronize(setup.b.device)
        prof.export_chrome_trace(path)
        if not lost_launches(path):
            break
    return path


def _with_trace(method, n_iters, restarts, parse):
    path = trace_fused(method, n_iters, restarts)
    if path is None:
        return None
    try:
        return parse(path)
    finally:
        os.unlink(path)


def measure_iteration_times(method, n_iters: int, restarts: int = 0,
                            why=None):
    """Per-iteration device walls (seconds) of the method's fused loop,
    re-run under the profiler; None off the card or when the trace shows
    no kernel once an iteration (`why` as in iteration_times_from_trace)."""
    return _with_trace(method, n_iters, restarts,
                       lambda p: iteration_times_from_trace(p, n_iters, why))


def attach_iteration_times(result, method, why=None) -> bool:
    """Fill result.time_per_iteration with measured device walls (the
    reference's time_per_iteration[], solver.hpp:166-171); True on
    success.  Only for res_check_len == 1 (one history row an iteration):
    a restart's history row keeps 0, as in the JAX package.  On a miss, a
    list `why` gets the reason appended."""
    if result.res_check_len != 1:
        if why is not None:
            why.append(f"res_check_len={result.res_check_len}, not 1")
        return False
    times = measure_iteration_times(method, result.iter_count,
                                    result.gmres_restart_count, why)
    if times is None or times.size == 0:
        if why is not None and not why:
            why.append("no device trace on this device")
        return False
    tpi = np.zeros_like(np.asarray(result.time_per_iteration,
                                   dtype=np.float64))
    idx = np.arange(1, times.size + 1)
    slots = idx.copy()
    if result.gmres_restart_count > 0 and result.restart_length > 0:
        slots = idx + (idx - 1) // result.restart_length
    keep = slots < tpi.size - 1
    tpi[slots[keep]] = times[keep]
    result.time_per_iteration = tpi
    result.uniform_iteration_times = False
    return True


def measure_phase_table(method, n_iters: int, restarts: int = 0):
    """(table, meta) of phase_table_from_trace for the method's fused loop
    re-run under the profiler; None off the card."""
    return _with_trace(method, n_iters, restarts, phase_table_from_trace)


def print_phase_table(table, meta, n_iters=None, out=None) -> None:
    """The reference's hierarchical timer table filled from the kernels'
    device times (utilities.hpp:154-324 prints host stopwatch splits; the
    fused loop launches without waiting, so the profiler attributes)."""
    import sys
    out = sys.stderr if out is None else out
    width = 44
    dev = meta["device_wall"]
    rows = [(0, "solve (device wall)", dev)]
    acct = 0.0
    for k in ("spmv", "sptrsv", "orthog", "blas1", "layout_glue", "other"):
        if k in table:
            rows.append((1, k, table[k]))
            acct += table[k]
    lines = ["+" + "-" * (width + 26) + "+"]
    for depth, name, v in rows:
        label = "| " * depth + name
        per_it = f" ({v / n_iters * 1e3:8.4f} ms/iter)" if n_iters else ""
        lines.append(f"| {label:<{width}} {v:10.6f} s{per_it:>20} |")
    lines.append("+" + "-" * (width + 26) + "+")
    lines.append(f"| accounted: {acct:.6f} s of {dev:.6f} s device wall"
                 f" ({100 * acct / max(dev, 1e-12):.0f}%; the rest is the "
                 "device idle between kernels)")
    print("\n".join(lines), file=out)
