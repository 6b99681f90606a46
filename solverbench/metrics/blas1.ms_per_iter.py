"""blas1.ms_per_iter: device ms of the blas1 layer's kernels (vector
updates, dots, norms) in the traced slice, a useful iteration."""


def read(run):
    sl = run.slice
    if sl is None:
        return None
    t = sl.layer_seconds().get("blas1", 0.0)
    iters = sum(s.iters for s in run.solves if s.traced)
    return 1e3 * t / iters if t > 0 and iters else None
