"""ms_per_iter: the window's untraced solves' seconds over their useful
iterations.  Gated iterations past a stop are paid, not counted."""


def read(run):
    solves = [s for s in run.solves if not s.traced]
    iters = sum(s.iters for s in solves)
    return 1e3 * sum(s.seconds for s in solves) / iters if iters else None
