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
norm, and the explicit float64 final residual is appended.
"""
from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

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


def fused_solve(setup: SolverSetup, init_state: Callable, iterate: Callable,
                sample_norm: Callable, final_x: Callable) -> SolveResult:
    """Run the device-resident loop.

    init_state() -> state dict with 'residual_norm' = ||b - A x0||;
    iterate(state, active) -> state, a no-op step where `active` is False;
    sample_norm(state) -> 0-d device tensor."""
    config = setup.config
    max_iters, k = config.max_iters, config.res_check_len
    max_hist = max_iters * 2 + 2       # index max_hist is a discard slot

    state = init_state()
    r0 = state["residual_norm"]
    device = r0.device
    stopping = _stopping(config, r0)
    norms = torch.zeros(max_hist + 1, dtype=r0.dtype, device=device)
    norms[0] = r0
    it = torch.zeros((), dtype=torch.int64, device=device)
    hist = torch.ones((), dtype=torch.int64, device=device)
    last = r0
    # `it < max_iters` needs no device term: the host loop bounds the count
    active = (last.abs() >= stopping) & torch.isfinite(last)

    timer = _LoopTimer(device)
    done = 0
    while done < max_iters:
        chunk = min(CHECK_EVERY, max_iters - done)
        for _ in range(chunk):
            state = iterate(state, active)
            it = it + active
            do = active if k == 1 else active & (it % k == 0)
            rn = sample_norm(state)
            last = torch.where(do, rn, last)
            slot = torch.where(do, hist, max_hist)
            norms.scatter_(0, slot.view(1), rn.view(1))
            hist = hist + do
            active = active & (last.abs() >= stopping) & torch.isfinite(last)
        done += chunk
        if not bool(active):
            break
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
        method=config.method, preconditioner=config.preconditioner,
        restart_length=config.restart_length,
        res_check_len=config.res_check_len, solve_seconds=solve_seconds)
