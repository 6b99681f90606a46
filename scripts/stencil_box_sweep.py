"""Time the box routes of the stencil SpMV kernels (#1 and #2,
csrc/stencil_spmv.cu) on one CUDA card against the length of their z runs.

    python3 scripts/stencil_box_sweep.py
    python3 scripts/stencil_box_sweep.py --specs hpcg:384x384x384 \
        --zr 0 26 48 --dtype float64

For each spec and each run length zr (0: the one `stencil_op._box_grid`
plans), #1's and #2's box routes on y = A·x with the y·x dot, by device
time: the median over 10 batches of 10 bound launches, each batch
enqueued behind a sleeping kernel so that the host's launch cost is
hidden.  The run lengths take turns, forwards and backwards, on one
card.  Prints the card's name and power limit, then one line per spec,
run length and kernel with the grid, the times, the byte bound (x and y
over 3.35 TB/s) and the share of it.
"""
import argparse
import pathlib
import statistics
import subprocess
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

PEAK_BYTES_S = 3.35e12


def _device_ms(torch, fn, reps=10, batch=10, sleep_cycles=100_000_000):
    fn()
    times = []
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        torch.cuda.synchronize()
        ev[0].record()
        torch.cuda._sleep(sleep_cycles)
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(batch):
            fn()
        host_ms = 1e3 * (time.perf_counter() - t0)
        ev[2].record()
        ev[2].synchronize()
        if host_ms >= ev[0].elapsed_time(ev[1]):
            raise RuntimeError("enqueuing took longer than the sleep")
        times.append(ev[1].elapsed_time(ev[2]) / batch)
    return statistics.median(times)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--specs", nargs="+",
                    default=["hpcg:128x128x128", "hpcg:384x384x384"])
    ap.add_argument("--zr", nargs="+", type=int, default=[0, 2, 4, 8, 16])
    ap.add_argument("--dtype", default="float32")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("stencil_box_sweep: no CUDA device")
    import basic_iterative_solvers_tpu_torch as bt
    so = bt.stencil_op
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dt = getattr(torch, args.dtype)
    for spec in args.specs:
        A = so.from_source_operator(spec, dt, device="cuda")
        x = torch.randn(A.n_rows, dtype=dt, device="cuda")
        bound = 2 * A.n_rows * x.element_size() / PEAK_BYTES_S * 1e3
        ref = so._stencil_spmv_cuda(A, x, (), None, route="legs")
        times = {}
        planned = so._box_grid

        def use(zr):
            def grid(dims, vec, sms=132, resident=2):
                gx, gy, r = planned(dims, vec, sms, resident)
                r = zr or r
                return gx, -(-dims[2] // r), r
            so._box_grid = grid
        try:
            for zr in args.zr + args.zr[::-1]:
                use(zr)
                for stream in (False, True):
                    launch, y, _, _ = so._bind_spmv(A, x, ("x",), None,
                                                    stream, "box")
                    launch()
                    torch.cuda.synchronize()
                    if not torch.equal(y, ref):
                        raise RuntimeError(f"box route differs: {spec} {zr}")
                    times.setdefault((zr, stream), []).append(
                        _device_ms(torch, launch))
            for (zr, stream), ts in sorted(times.items()):
                use(zr)
                dims, vec = so.box_form(A)[1], so.box_vec(A, x)
                grid = so._box_grid(dims, vec, so.sm_count(0),
                                    so._box_resident(stream, dims, vec,
                                                     x.element_size()))
                print(f"[box-sweep] {spec} {args.dtype} "
                      f"{'#2' if stream else '#1'} zr={zr or 'planned'} "
                      f"grid(gx, gy, zr)={grid} device_ms="
                      f"{[f'{t:.5f}' for t in ts]} bound_ms={bound:.5f} "
                      f"share_of_bound={bound / min(ts):.3f}")
        finally:
            so._box_grid = planned
        del A, x, ref
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
