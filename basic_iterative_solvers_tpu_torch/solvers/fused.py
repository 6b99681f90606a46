"""Device-resident solve loop, the performance harness.

The JAX package runs the whole solve as one `lax.while_loop`
(basic_iterative_solvers_tpu/solvers/fused.py).  Here the loop is a Python
loop of asynchronous launches that never waits for the device inside an
iteration: the while-condition lives on the device as a 0-d bool tensor
`active`, and an iteration past the stop is a no-op (the method gates its
step scalars with `active`, and the counters and history only advance
while it holds).  The host reads `active` once every `CHECK_EVERY`
iterations and stops there.

Semantics are those of the JAX runner (and of the reference's harness,
solver.hpp:166-191): history entry 0 is ||r0||, the norm is sampled every
`res_check_len` iterations, the stopping test reads the last sampled norm,
the loop stops at |last| < tol·||r0||, at max_iters or on a non-finite
norm, and the explicit float64 final residual is appended.  GMRES runs in
restart cycles (`fused_solve`'s restart_state_fn).

In the GSPMD mode the method's vectors are row-sharded DTensors; the loop's
own scalars (the sampled norm, the counters, the condition) are taken as
every rank's whole value (`full_value`), plain tensors on the device.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from ..ops.blas1 import full_value
from .base import (SolveResult, SolverSetup, _stopping,
                   explicit_residual_norm, finalize_x)

#: iterations between host reads of the loop condition: each read waits for
#: the device, and up to CHECK_EVERY-1 gated no-op iterations follow a stop
CHECK_EVERY = 64


class _LoopTimer:
    """CUDA events around the loop on a card, the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.start_ev = torch.cuda.Event(enable_timing=True)
            self.end_ev = torch.cuda.Event(enable_timing=True)
            self.start_ev.record()
        else:
            self.t0 = time.perf_counter()

    def seconds(self) -> float:
        if self.cuda:
            self.end_ev.record()
            self.end_ev.synchronize()
            return self.start_ev.elapsed_time(self.end_ev) / 1e3
        return time.perf_counter() - self.t0


def gate(s, active):
    """The step scalar, or 0 where the fused loop has stopped (a where, so
    a NaN scalar past the stop cannot leak into the state)."""
    return s if active is None else torch.where(active, s, 0.0)


def keep_if_stopped(new, old, active):
    """`new`, or `old` where the fused loop has stopped."""
    return new if active is None else torch.where(active, new, old)


def finite_or_zero(s):
    """Breakdown guard of tolerance=0 runs (config.breakdown_stall): a
    non-finite step scalar stalls to 0 instead of poisoning the state."""
    return torch.where(torch.isfinite(s), s, torch.zeros_like(s))


def fused_solve(setup: SolverSetup, init_state: Callable, iterate: Callable,
                sample_norm: Callable, final_x: Callable,
                restart_state_fn: Optional[Callable] = None,
                cycle_len: Optional[int] = None) -> SolveResult:
    """Run the device-resident loop.

    init_state() -> state dict with 'residual_norm' = ||b - A x0||;
    iterate(state, active) -> state, a no-op step where `active` is False;
    sample_norm(state) -> 0-d device tensor.

    Restarted methods (GMRES) pass restart_state_fn(state) -> state (the
    full restart: explicit x, recomputed residual, Krylov reset) and
    cycle_len = m.  The loop then runs cycles of at most m iterations, every
    bound being `it < max_iters - restarts`, and restarts after a completed
    cycle whose sampled norm is still above the stop and finite; the
    restart norm goes into the history and into the stopping test (the
    JAX runner's semantics, basic_iterative_solvers_tpu/solvers/fused.py).
    The cycle end is a host check point: the restart condition is read
    there, once per cycle."""
    config = setup.config
    max_iters, k = config.max_iters, config.res_check_len
    max_hist = max_iters * 2 + 2       # index max_hist is a discard slot

    state = init_state()
    r0 = full_value(state["residual_norm"])
    device = r0.device
    stopping = _stopping(config, r0)
    norms = torch.zeros(max_hist + 1, dtype=r0.dtype, device=device)
    norms[0] = r0
    it = torch.zeros((), dtype=torch.int64, device=device)
    hist = torch.ones((), dtype=torch.int64, device=device)
    last = r0
    # `it < max_iters - restarts` needs no device term: the host loop
    # bounds the count (while `active` holds, every step advanced `it`)
    active = (last.abs() >= stopping) & torch.isfinite(last)

    def steps(count: int) -> bool:
        """Run `count` gated iterations, reading `active` on the host every
        CHECK_EVERY of them and after the last; False once it has stopped."""
        nonlocal state, it, last, hist, active
        done = 0
        while done < count:
            chunk = min(CHECK_EVERY, count - done)
            for _ in range(chunk):
                state = iterate(state, active)
                it = it + active
                do = active if k == 1 else active & (it % k == 0)
                rn = full_value(sample_norm(state))
                last = torch.where(do, rn, last)
                slot = torch.where(do, hist, max_hist)
                norms.scatter_(0, slot.view(1), rn.view(1))
                hist = hist + do
                active = (active & (last.abs() >= stopping)
                          & torch.isfinite(last))
            done += chunk
            if not bool(active):
                return False
        return True

    timer = _LoopTimer(device)
    restarts = 0
    if restart_state_fn is None:
        steps(max_iters)
    else:
        done = 0                  # iterations run, all of them active
        while True:
            count = min(cycle_len, max_iters - restarts - done)
            if count <= 0 or not steps(count):
                break
            done += count
            if count < cycle_len:
                break
            # a completed cycle, still above the stop and finite: restart
            state = restart_state_fn(state)
            restarts += 1
            last = full_value(state["residual_norm"])
            norms.scatter_(0, hist.view(1), last.view(1))
            hist = hist + 1
            active = (last.abs() >= stopping) & torch.isfinite(last)
    solve_seconds = timer.seconds()

    it = int(it)
    hist = int(hist)
    hist_norms = norms[:hist + 1].cpu().numpy()
    residual_norm = float(last)
    x_star = final_x(state)
    final_norm = explicit_residual_norm(setup, x_star)
    x_star = finalize_x(setup, x_star)
    hist_norms[hist] = final_norm
    return SolveResult(
        uniform_iteration_times=True,
        x_star=x_star, iter_count=it,
        converged=bool(residual_norm < float(stopping)),
        stopping_criteria=float(stopping),
        residual_norms=hist_norms,
        time_per_iteration=np.full(hist + 1, solve_seconds / max(1, it)),
        final_residual_norm=final_norm,
        gmres_restart_count=restarts,
        method=config.method, preconditioner=config.preconditioner,
        restart_length=config.restart_length,
        res_check_len=config.res_check_len, solve_seconds=solve_seconds)
