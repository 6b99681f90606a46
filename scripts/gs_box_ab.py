"""Time the GS colour-step kernel #3 (csrc/stencil_spmv.cu) on its box and
its legs route on one CUDA card, one device and the 8 shard launches of
an 8-shard mesh, for the package of a checkout.

    python3 scripts/gs_box_ab.py              # this checkout's package
    python3 scripts/gs_box_ab.py build/other  # another, unpacked there

Operators: fdm:2048 (f32, f64), HPCG 128^3 (f32), Anderson 128^3 (f32,
and its bf16 diagonal beside f32 vectors), each under its own colouring,
colour 0.  Both routes forced, by device time in turns (box, legs, legs,
box: chip_smoke._in_turns), the 8 shard launches where the halo is of
whole 16-byte vectors (the box route's shard form needs it), bit-equal to
each other.  To compare two checkouts, run it for each in turns (A, B, B,
A) in one call on the card.  Prints the card's name and power limit, then
one line per operator.
"""
import dataclasses
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
if len(sys.argv) > 1:
    sys.path.insert(0, str((ROOT / sys.argv[1]).resolve()))

import chip_smoke  # noqa: E402

CASES = (("fdm:2048", "float32"), ("fdm:2048", "float64"),
         (chip_smoke.MAIN_SPEC, "float32"),
         (chip_smoke.ANDERSON_128, "float32"),
         (chip_smoke.ANDERSON_128, "bfloat16"))


def main():
    import torch
    import basic_iterative_solvers_tpu_torch as bt
    from basic_iterative_solvers_tpu_torch.coloring import spec_for_device
    from basic_iterative_solvers_tpu_torch.parallel import make_mesh
    from basic_iterative_solvers_tpu_torch.parallel import mesh_ops as mo
    from basic_iterative_solvers_tpu_torch.parallel.sharded import (
        _halo_exchange, _split)
    so = bt.stencil_op
    chip_smoke.phase_device(torch)
    print(f"[gs-box-ab] package {pathlib.Path(bt.__file__).parent}")
    mesh = make_mesh(chip_smoke.MESH_SHARDS, device="cuda")
    k_all = range(chip_smoke.MESH_SHARDS)
    for spec, md_name in CASES:
        md = getattr(torch, md_name)
        dt = torch.float64 if md == torch.float64 else torch.float32
        A = so.from_source_operator(spec, md, device="cuda")
        W = mo.wrap_stencil(dataclasses.replace(
            A, shards=chip_smoke.MESH_SHARDS), mesh, "rows")
        R, n = W.rows, A.n_rows
        cs = spec_for_device(A)
        g = torch.Generator(device="cuda").manual_seed(3)
        x = torch.randn(n, device="cuda", generator=g, dtype=dt)
        rhs = torch.randn(n, device="cuda", generator=g, dtype=dt)
        dinv = (1.0 / so.stencil_diag(A)).to(dt)
        single = chip_smoke._in_turns(torch, {
            rt: (lambda rt=rt: so._stencil_gs_color_step_cuda(
                A, x, rhs, dinv, cs, 0, route=rt)) for rt in ("box", "legs")},
            ("box", "legs", "legs", "box"))
        line = (f"[gs-box-ab] {spec} {md_name} colour 0, device ms in turns: "
                f"one device box={single['box']} legs={single['legs']}")
        # the shard form's windows: line-aligned (window_halo) where the
        # checkout has them, else the exact halo, timed where whole vectors
        hw = getattr(A, "window_halo", A.halo)
        if hw[0] % (16 // x.element_size()) == 0:
            npad = chip_smoke.MESH_SHARDS * R
            pad = lambda v: torch.nn.functional.pad(v, (0, npad - n))  # noqa: E731
            wins = _halo_exchange(mesh, _split(pad(x), len(k_all)), *hw)
            rs, ds = _split(pad(rhs), len(k_all)), _split(pad(dinv),
                                                          len(k_all))
            dg = W.diag_shards or (None,) * len(k_all)

            def run(rt):
                return [so._stencil_gs_color_step_halo_cuda(
                    A, wins[k], k * R, R, rs[k], ds[k], cs, 0, dg[k], None,
                    route=rt) for k in k_all]
            box, legs = run("box"), run("legs")
            torch.cuda.synchronize()
            if not all(torch.equal(b, c) for b, c in zip(box, legs)):
                raise RuntimeError(f"{spec} {md_name}: the shard routes "
                                   "differ")
            t = chip_smoke._in_turns(torch, {
                rt: (lambda rt=rt: run(rt)) for rt in ("box", "legs")},
                ("box", "legs", "legs", "box"))
            line += (f"; {len(k_all)} shard launches ({R} rows each) "
                     f"box={t['box']} legs={t['legs']}")
        print(line)


if __name__ == "__main__":
    main()
