"""spmv.roofline: the SpMVs the traced solves need, at the card's
published peaks, over the device time of the spmv layer's kernels, in %.

Needed: one SpMV a useful iteration and the initial residual's in the
solve dtype, and the final residual's with x and y in float64 (a stored
matrix counted in its own dtype; roofline.spmv_bytes).
The layer's time includes the SpMVs of gated iterations, so the
harness's waste shows as a lower share."""
from solverbench import roofline


def read(run):
    sl = run.slice
    t = sl.layer_seconds().get("spmv", 0.0) if sl is not None else 0.0
    if t <= 0:
        return None
    cfg = run.cell.config
    traced = [s for s in run.solves if s.traced]
    ops = roofline.spmv_ops(cfg)
    need = (sum(s.iters + 1 for s in traced) * roofline.bound_seconds(
        roofline.spmv_bytes(cfg, run.itemsize), ops)
        + len(traced) * roofline.bound_seconds(roofline.spmv_bytes(cfg, 8),
                                               ops))
    return 100.0 * need / t
