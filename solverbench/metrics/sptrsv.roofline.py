"""sptrsv.roofline: the triangular solves the traced solves need, at the
card's published bandwidth, over the device time of the sptrsv layer's
kernels, in %.  Needed: one apply (an L and a U solve) a useful
iteration and one for the initial residual (roofline.trisolve_apply_bytes,
factors left out: a lower bound)."""
from solverbench import roofline


def read(run):
    sl = run.slice
    t = sl.layer_seconds().get("sptrsv", 0.0) if sl is not None else 0.0
    if t <= 0:
        return None
    applies = sum(s.iters + 1 for s in run.solves if s.traced)
    need = applies * roofline.bound_seconds(
        roofline.trisolve_apply_bytes(run.cell.config, run.itemsize))
    return 100.0 * need / t
