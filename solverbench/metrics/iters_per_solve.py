"""iters_per_solve: the mean SolveResult.iter_count of the window's
solves (a program counter: useful iterations, not the gated ones)."""


def read(run):
    if not run.solves:
        return None
    return sum(s.iters for s in run.solves) / len(run.solves)
