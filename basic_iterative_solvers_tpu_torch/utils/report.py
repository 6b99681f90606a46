"""Result reporting.

The reference's postprocessing (postprocessing.hpp:8-68) with the JAX
package's text (basic_iterative_solvers_tpu/utils/report.py): the
residual-norm table with per-iteration times, then the convergence
summary; the roofline line that stands in for LIKWID's counters; and the
hierarchical kernel-timer table of the host harness.

The roofline divides the estimated bytes an iteration moves by a copy rate
measured once a process on the device the solve ran on (a large
device-to-device copy, timed with CUDA events on a card and the host clock
on the CPU), or by the rate the caller passes, and names that device.
"""
from __future__ import annotations

import statistics
import sys
import time

import torch

from ..types import PrecondType, SolverType, to_string


def print_residuals(result, out=None) -> None:
    """Residual Norms / Time for iteration table (the reference's
    print_residuals, postprocessing.hpp:8-30)."""
    out = sys.stdout if out is None else out
    norms = result.residual_norms
    times = result.time_per_iteration
    k = result.res_check_len
    print(f"\n{'':15}Residual Norms{'':27}Time for iteration", file=out)
    print("+" + "-" * 42 + "+" + " " * 8 + "+" + "-" * 25 + "+", file=out)
    for i, rn in enumerate(norms):
        line = f"||A*x_{i * k} - b||_2 = {rn:.16e}"
        if i > 0 and i < len(times):
            line += f"{times[i]:>25.6f}[s]"
        print(line, file=out)
    if getattr(result, "uniform_iteration_times", False):
        print("(fused harness: per-iteration times are the solve-average — "
              "the whole solve is one device dispatch)", file=out)


def summary_output(result, out=None) -> None:
    """Convergence summary (the reference's summary_output,
    postprocessing.hpp:33-68)."""
    out = sys.stdout if out is None else out
    print_residuals(result, out)
    iter_count = result.iter_count
    if result.method == SolverType.GMRES:
        # restarts count as iterations (postprocessing.hpp:39-40)
        iter_count += result.gmres_restart_count
    name = to_string(result.method)
    if result.method == SolverType.GMRES:
        name += f"({result.restart_length})"
    line = f"\nSolver: {name}"
    if result.preconditioner not in (None, PrecondType.NONE):
        line += f" with preconditioner: {to_string(result.preconditioner)}"
    if result.converged:
        line += f" converged in: {iter_count} iterations."
    else:
        line += f" did not converge after {iter_count} iterations."
    print(line, file=out)
    print('With the stopping criteria "tol * ||Ax_0 - b||_2" is: '
          f"{result.stopping_criteria:.16e}", file=out)
    print("The residual of the final iteration is: ||A*x_star - b||_2 = "
          f"{result.final_residual_norm:.16e}.", file=out)


def iteration_traffic_bytes(setup) -> int:
    """Estimated device-memory bytes one solver iteration moves: the SpMV
    streams plus every vector pass of the method's recurrence and of its
    preconditioner (the JAX package's static estimate, report.py:72-139).
    A matrix stored in bfloat16 counts 2 bytes a value."""
    from ..device_matrix import device_matrix_nnz_bytes
    from ..precond import Preconditioner, estimated_precond_passes
    config = setup.config
    n = setup.b.numel()
    vec = n * setup.b.element_size()             # one full vector pass
    spmv = device_matrix_nnz_bytes(setup.A) + 2 * vec   # read x, write y
    # (SpMVs, vector passes, preconditioner applies) an iteration
    shapes = {
        SolverType.JACOBI: (1, 5, 0),
        SolverType.GAUSS_SEIDEL: (2, 4, 0),
        SolverType.SYMMETRIC_GAUSS_SEIDEL: (4, 8, 0),
        SolverType.CONJUGATE_GRADIENT: (1, 10, 1),    # 3 dots + 3 axpys
        SolverType.BICGSTAB: (2, 16, 2),
        SolverType.GMRES: (1, 4, 1),                  # + the basis below
    }
    n_spmv, n_vec, n_prec = shapes[config.method]
    gs_method = config.method in (SolverType.GAUSS_SEIDEL,
                                  SolverType.SYMMETRIC_GAUSS_SEIDEL)
    if gs_method and setup.gs_L_block is not None:
        # residual-form sweeps through the superblock solves: one residual
        # SpMV and the solves' passes
        sym = config.method == SolverType.SYMMETRIC_GAUSS_SEIDEL
        Mb = Preconditioner(
            ptype=(PrecondType.SYMMETRIC_GAUSS_SEIDEL if sym
                   else PrecondType.GAUSS_SEIDEL),
            outer_iters=1, inner_iters=1, L_block=setup.gs_L_block,
            U_block=setup.gs_U_block)
        return int(spmv + (4 + estimated_precond_passes(Mb)) * vec)
    if gs_method and setup.n_colors > 0:
        # coloured sweeps: one SpMV and one masked update a colour step a
        # sweep; a grid spec chains sx colours a step
        steps = setup.n_colors
        spec = setup.color_spec
        if (spec is not None and spec.kind == "grid"
                and spec.params[3] > 1):
            steps = max(1, setup.n_colors // spec.params[3])
        sweeps = 2 if config.method == SolverType.SYMMETRIC_GAUSS_SEIDEL \
            else 1
        n_spmv = sweeps * steps + 1                   # +1 sampled residual
        n_vec = 3 * sweeps * steps + 2
    total = n_spmv * spmv + n_vec * vec
    if config.method == SolverType.GMRES:
        # the basis: passes over the ~(j+1)-row active basis an iteration
        # (lowsync 2, cgs2 4, mgs 2), j = m/2 on average over a cycle, rows
        # stored in gmres_basis_dtype
        m = config.restart_length
        passes = {"lowsync": 2, "cgs2": 4, "mgs": 2,
                  "fused": 2}[config.orthog_mode]
        bd = config.gmres_basis_dtype
        if bd is None:
            bvec = vec
        else:
            from ..config import torch_dtype
            bvec = n * torch.empty((), dtype=torch_dtype(bd)).element_size()
        total += passes * (m / 2 + 1) * bvec
    total += n_prec * estimated_precond_passes(setup.M) * vec
    return int(total)


_COPY_RATES = {}


def measured_copy_gbps(device) -> tuple:
    """(GB/s, device name): the rate of a large copy on `device`, measured
    once a process (bytes read plus bytes written over the median of five
    copies: 512 MiB each way on a card, CUDA events; 64 MiB on the CPU,
    the host clock)."""
    device = torch.device(device)
    key = str(device)
    if key in _COPY_RATES:
        return _COPY_RATES[key]
    cuda = device.type == "cuda"
    nbytes = (512 if cuda else 64) << 20
    src = torch.ones(nbytes // 4, dtype=torch.float32, device=device)
    dst = torch.empty_like(src)
    times = []
    for _ in range(6):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            dst.copy_(src)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            dst.copy_(src)
            times.append(time.perf_counter() - t0)
    secs = statistics.median(times[1:])
    name = torch.cuda.get_device_name(device) if cuda else "the CPU"
    _COPY_RATES[key] = (2 * nbytes / secs / 1e9, name)
    return _COPY_RATES[key]


def roofline_report(setup, result, hbm_gbps: float = None, out=None,
                    secs_per_iter: float = None) -> None:
    """The solve's achieved bandwidth against a memory roofline: the
    iteration's estimated total traffic (SpMV and every vector pass) over
    the seconds an iteration took, as a share of `hbm_gbps`, by default
    the copy rate measured on the solve's device (measured_copy_gbps).
    `secs_per_iter` replaces the solve-average (--iter-times passes the
    median device wall from the profiler there)."""
    out = sys.stderr if out is None else out
    iters = max(1, result.iter_count)
    secs = (result.solve_seconds / iters if secs_per_iter is None
            else secs_per_iter)
    if hbm_gbps is None:
        hbm_gbps, where = measured_copy_gbps(setup.b.device)
        label = f"the copy rate measured on {where}"
    else:
        label = "the given rate"
    traffic = iteration_traffic_bytes(setup)
    floor_ms = traffic / (hbm_gbps * 1e9) * 1e3
    achieved_gbps = traffic / max(secs, 1e-12) / 1e9
    pct = 100.0 * achieved_gbps / hbm_gbps
    print(f"[roofline] {iters} iters, {secs * 1e3:.5f} ms/iter; est. "
          f"traffic {traffic / 1e6:.1f} MB/iter -> {achieved_gbps:.0f} GB/s "
          f"achieved = {pct:.0f}% of {hbm_gbps:.0f} GB/s, {label} "
          f"(floor {floor_ms:.3f} ms/iter)", file=out)


def print_kernel_report(timers, result=None, out=None) -> None:
    """Hierarchical per-kernel timer table (the reference's print_timers,
    utilities/utilities.hpp:154-324): phase rows with their kernel children
    (spmv, precond, sptrsv, dot, norm, sum, and GMRES's orthog, least_sq,
    update_g), the kernel rows filled where the host harness ran with
    kernel_timers (utils/ktimers.py)."""
    out = sys.stderr if out is None else out
    names = set(timers.names())

    def g(n):
        return timers[n].check() if n in names else None

    rows = [(0, "total"), (1, "read_matrix"), (1, "preprocessing")]
    rows += [(2, n) for n in timers.names()
             if n.startswith("preprocessing_")]
    rows += [(1, "solve"),
             (2, "spmv"), (2, "precond"), (3, "sptrsv"),
             (2, "orthog"), (2, "least_sq"), (2, "update_g"),
             (2, "dot"), (2, "norm"), (2, "sum"),
             (1, "postprocessing")]
    width = 44
    lines = ["+" + "-" * (width + 14) + "+"]
    for depth, name in rows:
        v = g(name)
        if v is None:
            continue
        label = "| " * depth + name
        lines.append(f"| {label:<{width}} {v:10.6f} s |")
    lines.append("+" + "-" * (width + 14) + "+")
    print("\n".join(lines), file=out)
