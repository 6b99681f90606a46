"""Stacked wall-clock timers.

Analog of the reference's Stopwatch/Timers/TIME instrumentation
(common.hpp:206-354, utilities/utilities.hpp:110-152): named accumulating
stopwatches with start/stop/check and a hierarchical report.  CUDA work is
asynchronous, so a scope that wraps device calls times their enqueue unless
it ends in `torch.cuda.synchronize()`.
"""
from __future__ import annotations

import contextlib
import time
from collections import OrderedDict


class Stopwatch:
    """start/stop/check accumulator (reference Stopwatch, common.hpp:206-254).

    check() = running split without stopping."""

    def __init__(self):
        self._t0 = None
        self._elapsed = 0.0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        if self._t0 is not None:
            self._elapsed += time.perf_counter() - self._t0
            self._t0 = None

    def check(self) -> float:
        if self._t0 is None:
            return self._elapsed
        return self._elapsed + (time.perf_counter() - self._t0)

    def get_wtime(self) -> float:
        return self._elapsed


class Timers:
    """Named stopwatch registry + TIME()-style context manager."""

    def __init__(self):
        self._watches: "OrderedDict[str, Stopwatch]" = OrderedDict()

    def __getitem__(self, name: str) -> Stopwatch:
        if name not in self._watches:
            self._watches[name] = Stopwatch()
        return self._watches[name]

    def names(self):
        return list(self._watches)

    @contextlib.contextmanager
    def time(self, name: str):
        sw = self[name]
        sw.start()
        try:
            yield sw
        finally:
            sw.stop()

    def report(self) -> str:
        """Hierarchical-ish ASCII table (reference print_timers,
        utilities/utilities.hpp:154-324)."""
        lines = ["+----------------------------------+------------+",
                 "| phase                            |   seconds  |",
                 "+----------------------------------+------------+"]
        for name, sw in self._watches.items():
            # check() = running split, so mid-run dumps (milestones) show
            # live phase totals like the reference (common.hpp:234-242)
            lines.append(f"| {name:<32} | {sw.check():10.6f} |")
        lines.append("+----------------------------------+------------+")
        return "\n".join(lines)
