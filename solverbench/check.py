"""The comparison that decides a run's `correct`.

After the window has closed and the program's state is freed, the plain
reference (reference.py) judges a sample of the window's answers, drawn
from the seed: each sampled solve's x, as the port returned it, against
its right-hand side made again from (seed, solve index).  Three numbers
are compared, each with its limit from `limits/<cell>.json`:

* `failed`: the window's solves that did not report convergence, or
  whose final residual was not finite (limit 0);
* `resid`: the largest ‖b − A·x‖₂ / ‖b‖₂ of the sample, in float64, A the
  configuration's operator in its stated storage (stencil or DIA);
* `err`: the largest ‖x − x_true‖₂ / ‖x_true‖₂ of the sample.

A run with no sampled answer is not correct.
"""
from __future__ import annotations

import math
import random

import torch

from . import reference, traffic as gen

NAMES = ("failed", "resid", "err")


class Reservoir:
    """A uniform sample of at most `k` of a window's answers, its choices
    drawn from the seed, the answers copied off the card into buffers
    made in set-up (pinned on a card)."""

    def __init__(self, k: int, n: int, dtype, seed: int, device):
        pin = torch.device(device).type == "cuda"
        self.bufs = [torch.empty(n, dtype=dtype, pin_memory=pin)
                     for _ in range(k)]
        self.index = [None] * k
        self.rng = random.Random(gen.stream_seed(seed, 0, "check"))
        self.seen = 0

    def offer(self, index: int, x: torch.Tensor):
        k, i = len(self.bufs), self.seen
        slot = i if i < k else self.rng.randrange(i + 1)
        self.seen += 1
        if slot < k:
            self.bufs[slot].copy_(x)
            self.index[slot] = index

    def samples(self):
        return [(i, b) for i, b in zip(self.index, self.bufs) if i is not None]


def judge(config: dict, traffic: dict, seed: int, samples, failed: int,
          limits: dict, device):
    """(correct, checks): checks maps each name of NAMES to its value and
    its limit; a value that is not finite is given as None and fails."""
    dtype = getattr(torch, config["dtype"])
    rhs_op = reference.StencilOp(config["grid"], config["stencil"])
    op = reference.operator(config, torch.float64, device)
    resid = err = 0.0 if samples else float("nan")
    for index, x in samples:
        xt, b = gen.rhs(rhs_op, traffic, seed, index, dtype, device)
        x = x.to(device)
        r = reference.relative_residual(op, b, x)
        e = reference.relative_error(x, xt)
        if not (math.isfinite(r) and math.isfinite(e)):
            resid = err = float("nan")
            break
        resid, err = max(resid, r), max(err, e)
    values = {"failed": failed, "resid": resid, "err": err}
    checks, correct = {}, bool(samples)
    for name in NAMES:
        v, lim = values[name], limits[name]
        ok = math.isfinite(v) and v <= lim
        correct = correct and ok
        checks[name] = {"value": v if math.isfinite(v) else None,
                        "limit": lim}
    return correct, checks
