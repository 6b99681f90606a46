"""Time the split route's kernels #10 (super_acc) and #11 (super_parity)
on one CUDA card: every route of their mode in turns beside their bounds,
whole applies, the parity launch's block shapes, and the fused levels
whose code they share.

    python3 scripts/split_route_ab.py
    python3 scripts/split_route_ab.py --pairs table384 --dtype float64
    python3 scripts/split_route_ab.py --sweep
    python3 scripts/split_route_ab.py --fused --tree build/parent

Pairs, built on the card in seconds: `table384`, the hpcg:384x384x384
ILU(0) pair (factor tables); `plane2048`, the fdm:2048 pair of
scripts/superblock_line_sweep.py (L in plane mode, U const with a per-row
D), both triangles as planes on the split route, as BIS_SB_ALIGNED=0
builds the pair from host CSR (chip_smoke._as_planes).

Default: for each pair, every level through chip_smoke._split_steps (each
form of the mode bit-equal to plain and to the others, each step's device
time in turns beside its byte bound and, for a parity step, its sector
bound), then chip_smoke._split_applies (the fused pair and the split pair
on both routes, in turns).  `--sweep`: each parity step of the pair's
levels on every block (tl, lb) the kernel takes, forced through the
shape cache, by device time, bit-equal to the plain step; prints the
rule's block (`parity_shape`) and the fastest.  `--fused`: the fused
levels only, each on the route the picker names, by device time, one JSON
line a pair; with `--tree DIR` the package is imported from another
checkout (unpack one with `git archive` under `build/`), for timing two
checkouts in turns (A, B, B, A), each in its own process.
"""
import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
SLEEP = 2_000_000           # ~1 ms of sleep ahead of each timed batch


def _pairs(torch, bt, bk, name, dt, split):
    """(L, U) of the pair `name`; `split`: both on the split route (planes
    for plane2048)."""
    from basic_iterative_solvers_tpu_torch.coloring import spec_for_device
    if name == "table384":
        A = bt.stencil_op.from_source_operator("hpcg:384x384x384", dt,
                                               device="cuda")
        pair = bk.build_superblock_ilu0_pair_stencil(A, spec_for_device(A),
                                                     dtype=dt)
        return tuple(dataclasses.replace(B, fused=not split, _args={})
                     for B in pair)
    sys.path.insert(0, str(REPO / "scripts"))
    import superblock_line_sweep
    pair = superblock_line_sweep.pairs(torch, bt, bk, "fdm2048", dt)
    if not split:
        return pair
    import chip_smoke
    return tuple(chip_smoke._as_planes(B, torch) for B in pair)


def _parity_blocks(bk, B, li, item):
    """Every (tl, lb) the parity kernels take for level li of B."""
    nx = B.spec_params[0]
    rows = -(-nx // B.sx)
    line_bytes = ((len(B.levels[li][2]) + 1) * B.proto[0] * item
                  if B.is_table else 0)
    fixed = 4 * ((nx + 3) & ~3) if line_bytes else 0
    out, tl = [], 8
    while tl <= min(bk.LINE_THREADS, 1 << (rows - 1).bit_length()):
        lb = 1
        while (tl * lb <= bk.LINE_THREADS
               and fixed + lb * line_bytes <= bk.LINE_SMEM_MAX):
            if tl * lb >= 32:
                out.append((tl, lb))
            lb *= 2
        tl *= 2
    return out


def _sweep(torch, bk, chip_smoke, name, B, y, x, item, idx):
    for li, (_sb, cross, _s) in enumerate(B.levels):
        acc = None
        if cross:
            acc = torch.empty(B.m, dtype=x.dtype, device=x.device)
            bk.super_acc_plain(B, li, y, x, acc)
        p = next(iter(bk._parity_order(B)))
        ref = bk.super_parity_plain(B, li, p, y, acc, x.clone())
        rule = bk._parity_shape(B, li, item, idx)
        key = ("parity_shape", li, item, idx)
        times = {}
        for shape in _parity_blocks(bk, B, li, item):
            B._args[key] = shape
            out = x.clone()
            bk.super_parity(B, li, p, y, acc, out)
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                raise RuntimeError(f"{name} level {li} parity block {shape} "
                                   "differs from plain")
            times[shape] = chip_smoke._device_ms(
                lambda: bk.super_parity(B, li, p, y, acc, out), torch,
                sleep_cycles=SLEEP)
        B._args[key] = rule
        best = min(times, key=times.get)
        print(json.dumps({"pair": name, "upper": B.upper, "level": li,
                          "parity": p, "rule": list(rule),
                          "rule_ms": times[rule], "fastest": list(best),
                          "fastest_ms": times[best],
                          "all": {f"{t}x{b}": ms
                                  for (t, b), ms in times.items()}}))


def _fused(torch, bk, name, pair, dt, tree):
    sys.path.insert(0, str(REPO))
    import chip_smoke
    g = torch.Generator(device="cuda").manual_seed(7)
    n = pair[0].n_rows
    y = torch.randn(n, dtype=dt, device="cuda", generator=g)
    x = torch.randn(n, dtype=dt, device="cuda", generator=g)
    rows = []
    for B in pair:
        for li in range(len(B.levels)):
            rows.append({
                "upper": B.upper, "level": li,
                "route": bk.level_route_for(B, li, x.element_size(),
                                            device=x.device),
                "ms": chip_smoke._device_ms(
                    lambda: bk.super_level(B, li, y, x), torch,
                    sleep_cycles=SLEEP)})
    print(json.dumps({"tree": str(tree), "pair": name, "dtype": str(dt),
                      "levels": rows}))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pairs", nargs="+", default=["table384", "plane2048"])
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--fused", action="store_true")
    ap.add_argument("--tree", default=str(REPO))
    args = ap.parse_args()
    tree = pathlib.Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("split_route_ab: no CUDA device")
    import basic_iterative_solvers_tpu_torch as bt
    from basic_iterative_solvers_tpu_torch.ops import block_trisolve as bk
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dt = getattr(torch, args.dtype)
    item = torch.empty((), dtype=dt).element_size()
    idx = torch.cuda.current_device()
    for name in args.pairs:
        pair = _pairs(torch, bt, bk, name, dt, split=not args.fused)
        if args.fused:
            _fused(torch, bk, name, pair, dt, tree)
            del pair
            torch.cuda.empty_cache()
            continue
        sys.path.insert(0, str(REPO))
        import chip_smoke
        g = torch.Generator(device="cuda").manual_seed(5)
        n = pair[0].n_rows
        y = torch.randn(n, dtype=dt, device="cuda", generator=g)
        x = torch.randn(n, dtype=dt, device="cuda", generator=g)
        label = f"{name} {args.dtype}"
        for B in pair:
            if args.sweep:
                _sweep(torch, bk, chip_smoke, name, B, y, x, item, idx)
            else:
                steps = chip_smoke._split_steps(
                    torch, bk, "split-ab", label, B, y, x,
                    lambda B_, li, it, part, p=None:
                    (chip_smoke._level_work(B_, li, it, part, p)
                     if B_.is_table else
                     chip_smoke._plane_level_work(B_, li, it, part)))
                for step in ("acc", "par"):
                    if any(k not in ("bound", "sector_bound_ms", "plain")
                           for k in steps[step]):
                        print(f"[split-ab] {label} "
                              f"{'U' if B.upper else 'L'} {step}: "
                              f"{chip_smoke._split_record(steps, step)}")
        if not args.sweep:
            fused = _pairs(torch, bt, bk, name, dt, split=False)
            chip_smoke._split_applies(torch, bk, "split-ab", label, fused,
                                      pair, y)
            del fused
        del pair, x, y
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
