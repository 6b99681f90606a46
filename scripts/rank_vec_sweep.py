"""Time the vec route of the rank-space level kernel (#8,
csrc/block_trisolve.cu: rank_level_vec_kernel) on one CUDA card against
its launch shape, beside the scalar route.

    python3 scripts/rank_vec_sweep.py
    python3 scripts/rank_vec_sweep.py --spec band:30000,2 --dtype float64

The SGS pair of the band's rank-space solve (its mod colouring, built from
host CSR as pbicgstab@band builds it).  For every level with groups: the
scalar route, the shape `rank_vec_shape` picks, and every block of
THREADS threads with CPT chunks a thread, by device time (the median over
10 batches of 10 launches, each batch enqueued behind a sleeping kernel),
each bit-equal to the scalar route.  Prints the card's name and power
limit, then one line per level with the scalar time, the rule's shape and
time, and the fastest shape with its time.
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402

THREADS = (64, 128, 256)
CPT = (1, 2, 3, 4, 6, 8)


def main():
    import torch
    import basic_iterative_solvers_tpu_torch as bt
    from basic_iterative_solvers_tpu_torch.coloring import spec_colors_np
    from basic_iterative_solvers_tpu_torch.ops import block_trisolve as bk
    from basic_iterative_solvers_tpu_torch.stencil_op import sm_count
    p = argparse.ArgumentParser()
    p.add_argument("--spec", default=chip_smoke.BAND)
    p.add_argument("--dtype", default="float32",
                   choices=("float32", "float64"))
    args = p.parse_args()
    chip_smoke.phase_device(torch)
    dt = getattr(torch, args.dtype)
    dev = torch.device("cuda", 0)
    A = bt.generators.from_source(args.spec)
    cs = bt.generators.color_spec_for_source(args.spec)
    colors = spec_colors_np(cs, A.n_rows)
    L, U = bk.build_best_trisolve_pair(A, A.diagonal(), A.diagonal(), colors,
                                       cs, dtype=dt, need_d=True,
                                       device="cuda")
    g = torch.Generator(device="cuda").manual_seed(8)
    Y = torch.randn((L.n_colors, L.M), dtype=dt, device="cuda", generator=g)
    X = torch.randn_like(Y)
    item = X.element_size()
    key = lambda li: ("vec_args", li, str(dev))  # noqa: E731
    for name, B in (("L", L), ("U", U)):
        for li, (c, groups) in enumerate(B.levels):
            if not groups or bk.rank_route_for(B, li) != "vec":
                continue
            windows = bk._rank_table(B, li, dev)[2]
            ref = bk.rank_level(B, li, Y, X.clone(), route="scalar")
            scalar_ms = chip_smoke._device_ms(
                lambda: bk.rank_level(B, li, Y, X, route="scalar"), torch,
                sleep_cycles=20_000_000)
            rule = bk.rank_vec_shape(B.M, item, sm_count(0))
            times = {}
            for threads in THREADS:
                for cpt in CPT:
                    B._tables[key(li)] = (threads, bk._rank_vec_args(
                        B, li, windows, cpt))
                    out = bk.rank_level(B, li, Y, X.clone(), route="vec")
                    torch.cuda.synchronize()
                    if not torch.equal(out, ref):
                        raise RuntimeError(f"{name} level {li} ({threads}, "
                                           f"{cpt}) differs from scalar")
                    times[threads, cpt] = chip_smoke._device_ms(
                        lambda: bk.rank_level(B, li, Y, X, route="vec"),
                        torch, sleep_cycles=20_000_000)
            del B._tables[key(li)]
            best = min(times, key=times.get)
            work = chip_smoke._rank_level_work(B, li, item)
            bound = chip_smoke._bound(*work)["bound_ms"]
            print(f"[rank-sweep] {args.spec} {args.dtype} {name} level {li} "
                  f"(colour {c}, {len(groups)} groups): scalar "
                  f"{scalar_ms:.4f} ms; rule {rule} {times[rule]:.4f}; "
                  f"fastest {best} {times[best]:.4f}; bound {bound:.4f}; "
                  "all: " + " ".join(f"{t}x{k}={v:.4f}"
                                     for (t, k), v in times.items()))


if __name__ == "__main__":
    main()
