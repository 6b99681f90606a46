"""launches_per_iter: device kernels in the traced slice over the useful
iterations of its solves."""


def read(run):
    if run.slice is None or not run.slice.kernel_launches:
        return None
    iters = sum(s.iters for s in run.solves if s.traced)
    return run.slice.kernel_launches / iters if iters else None
