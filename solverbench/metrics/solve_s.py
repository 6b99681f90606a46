"""solve_s: the window's seconds over the solves completed (host clock).
Every solve is timed from the call to x and its float64 residual on
hand; the window is those timed stretches, back to back, summed (making
the next b and copying a sampled answer off the card lie between them)."""


def read(run):
    return run.window_s / len(run.solves) if run.solves else None
