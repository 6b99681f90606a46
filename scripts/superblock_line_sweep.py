"""Time the line route of the superblock level kernel (#9 in plane and
const modes, csrc/block_trisolve.cu: super_level_line_kernel) on one CUDA
card against its block shape, beside the direct route.

    python3 scripts/superblock_line_sweep.py
    python3 scripts/superblock_line_sweep.py --pairs fdm2048 --dtype float64

Pairs, built on the card from the stencils in a second or two (the
structure of the pairs the coloured host route builds, their values
synthetic): `const128`, the HPCG 128^3 GS pair (const mode); `fdm2048`,
the fdm:2048 pair as pcg_ilu0@fdm2048 runs it: L in plane mode (the GS
pair's legs as coefficient x mask planes, unit diagonal), U const with a
per-row D (random, in [1, 2)).  For each pair, every level of L and U on
one device and as the 8 launches of an 8-shard mesh (the last L level and
the U levels): the direct route, the shape `line_shape` picks, and every
other block (tl threads a line, lb lines) within the kernel's limits, by
device time (the median over 10 batches of 10 bound launches, each batch
enqueued behind a sleeping kernel), each shape bit-equal to the direct
route and to the plain level.  Prints the card's name and power limit,
then one line per level and launch with the direct time, the rule's
shape and time, and the fastest shape; `--out FILE` writes every shape's
time there as well.
"""
import argparse
import dataclasses
import pathlib
import subprocess
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402

#: the sleeping kernel ahead of each timed batch (~10 ms): longer than
#: enqueuing 10 calls of 8 shard launches
SLEEP = 20_000_000


def _plane_form(torch, bk, B, dev):
    """B's levels as plane mode: each leg's coefficient x its in-grid mask
    as a plane, the unit diagonal per row (an ILU(0) L's structure)."""
    import numpy as np
    np_dt = bk._np_dtype(B.dtype)
    vc, vs = [], []
    for li, (sb, cross, selfs) in enumerate(B.levels):
        c_planes = [c * bk._leg_mask_np(sb, (dx, dy, dz), B.spec_params, B.m)
                    for c, dx, dy, dz in B.const_cross[li]]
        s_planes = [c * bk._leg_mask_np(sb, (dx, 0, 0), B.spec_params, B.m,
                                        self_upper=B.upper)
                    for c, dx in B.const_self[li]]
        vc.append(torch.from_numpy(np.array(c_planes, dtype=np_dt)).to(dev)
                  if cross else None)
        vs.append(torch.from_numpy(np.array(s_planes, dtype=np_dt)).to(dev)
                  if selfs else None)
    return dataclasses.replace(
        B, const_cross=(), const_self=(), vals_cross=tuple(vc),
        vals_self=tuple(vs), dinv=None, d=None,
        dinv_rows=torch.ones(B.n_rows, dtype=B.dtype, device=dev),
        unit=True, _args={})


def pairs(torch, bt, bk, name, dt):
    from basic_iterative_solvers_tpu_torch.coloring import spec_for_device
    spec = "hpcg:128x128x128" if name == "const128" else "fdm:2048"
    A = bt.stencil_op.from_source_operator(spec, dt, device="cuda")
    # the source's grid colour spec (fdm: (2048, 2048, 1, 2, 2, 1))
    L, U = bk.build_superblock_gs_pair_stencil(
        A, bt.generators.color_spec_for_source(spec) if name == "fdm2048"
        else spec_for_device(A), dtype=dt)
    if name == "const128":
        return L, U
    g = torch.Generator(device="cuda").manual_seed(5)
    d = 1.0 + torch.rand(U.n_rows, dtype=dt, device="cuda", generator=g)
    return (_plane_form(torch, bk, L, "cuda"),
            dataclasses.replace(U, dinv=None, d=None, dinv_rows=1.0 / d,
                                _args={}))


def shapes(bk, nx, sx, n_groups, item):
    """Every (tl, lb) the kernel takes for these lines."""
    tl_max = min(bk.LINE_THREADS, 1 << (nx - 1).bit_length())
    out = []
    tl = 16
    while tl <= tl_max:
        lb = 1
        while tl * lb <= bk.LINE_THREADS and lb * (
                nx * item + 8 * n_groups) <= bk.LINE_SMEM_MAX:
            if tl * lb >= 32:
                out.append((tl, lb))
            lb *= 2
        tl *= 2
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pairs", nargs="+", default=["const128", "fdm2048"])
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("superblock_line_sweep: no CUDA device")
    import basic_iterative_solvers_tpu_torch as bt
    from basic_iterative_solvers_tpu_torch.ops import block_trisolve as bk
    from basic_iterative_solvers_tpu_torch.parallel import make_mesh
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dt = getattr(torch, args.dtype)
    item = torch.empty((), dtype=dt).element_size()
    idx = torch.cuda.current_device()
    mesh = make_mesh(args.shards, device="cuda")
    out = open(args.out, "w") if args.out else None
    for name in args.pairs:
        for B in pairs(torch, bt, bk, name, dt):
            MB = bk.shard_superblock(B, mesh)
            g = torch.Generator(device="cuda").manual_seed(7)
            n, R, H = B.n_rows, MB.rows, MB.halo
            pad = args.shards * R - n
            for li in range(len(B.levels)):
                y = torch.randn(n, dtype=dt, device="cuda", generator=g)
                x = torch.randn(n, dtype=dt, device="cuda", generator=g)
                xw = torch.nn.functional.pad(x, (H, pad + H))
                ys = [v.clone() for v in torch.nn.functional.pad(
                    y, (0, pad)).split(R)]
                wins = [xw[k * R:(k + 1) * R + 2 * H].clone()
                        for k in range(args.shards)]
                launches = {"one device": [(B, None, y, x)],
                            f"{args.shards} shards": [
                                (B, Bs, ys[k], wins[k])
                                for k, Bs in enumerate(MB.shards)
                                if Bs.lines[li][1] > Bs.lines[li][0]]}
                if B.upper is False and li != len(B.levels) - 1:
                    del launches[f"{args.shards} shards"]
                for what, calls in launches.items():
                    _sweep(torch, bk, name, B, li, what, calls, item, idx,
                           out)
            del MB
        torch.cuda.empty_cache()
    if out:
        out.close()


def _sweep(torch, bk, name, B, li, what, calls, item, idx, out):
    def cache(Bs):
        return B._args if Bs is None else Bs._args

    def set_route(route, shape=None):
        for _B, Bs, _y, _x in calls:
            cache(Bs)[("route", li, item, idx)] = route
            if shape is not None:
                cache(Bs)[("line_shape", li, item, idx)] = shape

    def run():
        for _B, Bs, yk, xk in calls:
            if Bs is None:
                bk.super_level(B, li, yk, xk)
            else:
                bk.super_level_halo(Bs, li, yk, xk)

    def result():
        outs = []
        for _B, Bs, yk, xk in calls:
            xo = xk.clone()
            if Bs is None:
                bk.super_level(B, li, yk, xo)
            else:
                bk.super_level_halo(Bs, li, yk, xo)
            outs.append(xo)
        return outs

    for _B, Bs, _y, _x in calls:
        bk.level_route_for(B, li, item, Bs, calls[0][3].device)
    rule = {id(Bs): cache(Bs)[("line_shape", li, item, idx)]
            for _B, Bs, _y, _x in calls}
    plain = []
    for _B, Bs, yk, xk in calls:
        xo = xk.clone()
        if Bs is None:
            bk.super_level_plain(B, li, yk, xo)
        else:
            bk.super_level_halo_plain(Bs, li, yk, xo)
        plain.append(xo)
    set_route("direct")
    direct = result()
    if not all(torch.equal(a, b) for a, b in zip(direct, plain)):
        raise RuntimeError(f"{name} level {li} {what}: direct route "
                           "differs from plain")
    direct_ms = chip_smoke._device_ms(run, torch, sleep_cycles=SLEEP)
    nx, sx = B.spec_params[0], B.sx
    groups = len(B.levels[li][1]) if B.is_plane else 0
    rule_shape = rule[id(calls[0][1])]
    times = {}
    for shape in shapes(bk, nx, sx, groups, item):
        set_route("line", shape)
        got = result()
        if not all(torch.equal(a, b) for a, b in zip(got, direct)):
            raise RuntimeError(f"{name} level {li} {what}: line route "
                               f"{shape} differs from the direct route")
        times[shape] = chip_smoke._device_ms(run, torch, sleep_cycles=SLEEP)
    for _B, Bs, _y, _x in calls:
        cache(Bs).pop(("route", li, item, idx))
        cache(Bs)[("line_shape", li, item, idx)] = rule[id(Bs)]
    best = min(times, key=times.get)
    mode = ("plane" if B.is_plane else "const, per-row D"
            if B.dinv_rows is not None else "const")
    line = (f"[line-sweep] {name} {B.dtype} {'U' if B.upper else 'L'} level "
            f"{li} ({mode}, {len(B.levels[li][1])} cross, {what}): direct "
            f"{direct_ms:.5f} ms; rule {rule_shape} {times[rule_shape]:.5f}; "
            f"best {best} {times[best]:.5f}; every shape bit-equal to the "
            "direct route and plain")
    print(line, flush=True)
    if out:
        out.write(line + "\n" + "".join(
            f"    {s}: {t:.5f}\n" for s, t in sorted(times.items())))
        out.flush()


if __name__ == "__main__":
    main()
