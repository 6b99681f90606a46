"""Checks of the port's CUDA kernels that need a card.

They skip where there is none (here, the CPU tests' machines).  On a
machine with a card and no JAX, run them without the JAX-loading
conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

This file imports torch and numpy only.
"""
import dataclasses

import numpy as np
import pytest
import torch

import basic_iterative_solvers_tpu_torch as bt
from basic_iterative_solvers_tpu_torch import stencil_op as tso


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    return torch.device("cuda")


SPECS = ["hpcg:37x21x5", "fdm:70",
         "anderson:Lx=9,Ly=7,Lz=6,t=1.0,ranpot=4.0,seed=1"]


@pytest.mark.cuda
@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("dt,rtol", [(torch.float32, 1e-6),
                                     (torch.float64, 1e-13)])
def test_stream_kernel_equals_resident_kernel(card, spec, dt, rtol):
    """#2's y bit-equal to #1's, its dots within rtol of #1's (relative to
    Σ|y·v|: the partials are summed in another order), one launch
    counted."""
    A = tso.from_source_operator(spec, dt, device=card)
    g = np.random.default_rng(7)
    x = torch.from_numpy(g.standard_normal(A.n_rows)).to(card, dt)
    aux = torch.from_numpy(g.standard_normal(A.n_rows)).to(card, dt)
    dots = ("x", "self", "aux")
    before = tso.stencil_spmv_stream.launches
    out2 = tso.stencil_spmv_stream(A, x, dots, aux)
    out1 = tso._stencil_spmv_cuda(A, x, dots, aux)
    torch.cuda.synchronize()
    assert tso.stencil_spmv_stream.launches == before + 1
    assert torch.equal(out2[0], out1[0])
    for kind, d2, d1 in zip(dots, out2[1:], out1[1:]):
        partner = {"x": x, "self": out1[0], "aux": aux}[kind]
        scale = float((out1[0] * partner).abs().sum())
        assert abs(float(d2 - d1)) <= rtol * scale


@pytest.mark.cuda
def test_stream_routes_a_multigrid_solve(card):
    """With STREAM set, a CG + MG solve launches #2 at every level and
    never #1; unset, the reverse; the counts and histories agree."""
    old = tso.STREAM
    results = {}
    try:
        for stream in (False, True):
            tso.STREAM = stream
            tso.stencil_spmv.launches = 0
            tso.stencil_spmv_stream.launches = 0
            res = bt.solve_system("hpcg:16x16x16", "cg", "mg",
                                  dtype=torch.float64, tolerance=1e-10,
                                  device=card)
            results[stream] = res
            n1, n2 = (tso.stencil_spmv.launches,
                      tso.stencil_spmv_stream.launches)
            assert res.converged
            assert (n1 == 0 and n2 > 0) if stream else (n2 == 0 and n1 > 0)
    finally:
        tso.STREAM = old
    off, on = results[False], results[True]
    assert off.iter_count == on.iter_count
    np.testing.assert_allclose(on.residual_norms, off.residual_norms,
                               rtol=1e-6)


@pytest.mark.cuda
def test_stream_refuses_legs_outside_its_reach(card):
    """A leg beyond #2's halo raises on the card (STREAM sends such an
    operator to #1 instead, counted)."""
    A = tso.make_stencil([((0, 0, 0), 4.0), ((3, 0, 0), -1.0)], 8, 4, 4,
                         dtype=torch.float32, device=card)
    x = torch.ones(A.n_rows, device=card)
    with pytest.raises(ValueError, match="halo"):
        tso.stencil_spmv_stream(A, x)
    old = tso.STREAM
    tso.STREAM = True
    try:
        before = tso.stencil_spmv_stream.outside_reach
        y = tso.stencil_spmv(A, x)
        assert tso.stencil_spmv_stream.outside_reach == before + 1
        assert torch.equal(y, tso._stencil_spmv_cuda(A, x, (), None))
    finally:
        tso.STREAM = old


BOX_CASES = ["hpcg:128x128x128", "hpcg:37x21x5", "hpcg:8x40x9", "fdm:2048",
             "galerkin:64",
             "bf16:anderson:Lx=32,Ly=24,Lz=16,t=1.0,ranpot=4.0,seed=1"]
BOX_DOTS = [(), ("x",), ("self",), ("aux",), ("x", "self", "aux")]


def _box_operator(card, case, dt):
    """The operator of a BOX_CASES entry: "galerkin:64" is the 64^3 level
    of the 128^3 multigrid hierarchy (27 legs, four coefficient groups),
    "bf16:..." an operator stored in bfloat16 (Anderson's diagonal)."""
    if case == "galerkin:64":
        from basic_iterative_solvers_tpu_torch import mg
        A = tso.from_source_operator("hpcg:128x128x128", dt, device=card)
        return mg.build_mg_hierarchy(A, bt.SolverConfig(
            preconditioner=bt.PrecondType.MULTIGRID, dtype=dt))[1].A
    if case.startswith("bf16:"):
        return tso.from_source_operator(case[5:], torch.bfloat16, device=card)
    return tso.from_source_operator(case, dt, device=card)


def _routes(counter):
    return (counter.box_launches, counter.legs_launches)


@pytest.mark.cuda
@pytest.mark.parametrize("case", BOX_CASES)
@pytest.mark.parametrize("dt,rtol", [(torch.float32, 1e-6),
                                     (torch.float64, 1e-13)])
def test_box_routes_equal_the_leg_loop(card, case, dt, rtol):
    """For every dot set: #1's box route gives y equal (torch.equal) to its
    leg loop's, #2 on the route route_for names (box on lines of whole
    16-byte vectors, else its legs route) and #2's legs route equal to
    #1's; the dots within rtol of the leg loop's (relative to sum|y v|:
    the partials are summed in another order); each call counted once on
    its route; the wrappers take route_for's route."""
    A = _box_operator(card, case, dt)
    g = np.random.default_rng(13)
    x = torch.from_numpy(g.standard_normal(A.n_rows)).to(card, dt)
    aux = torch.from_numpy(g.standard_normal(A.n_rows)).to(card, dt)
    assert tso.route_for(A, x, stream=False) == "box"
    r2 = tso.route_for(A, x, aux, stream=True)
    assert r2 == ("box" if A.dims[0] % (16 // x.element_size()) == 0
                  else "legs")
    for dots in BOX_DOTS:
        c1, c2 = _routes(tso.stencil_spmv), _routes(tso.stencil_spmv_stream)
        box = tso._stencil_spmv_cuda(A, x, dots, aux, route="box")
        legs = tso._stencil_spmv_cuda(A, x, dots, aux, route="legs")
        s2 = tso._stencil_spmv_stream_cuda(A, x, dots, aux)
        s2_legs = tso._stencil_spmv_stream_cuda(A, x, dots, aux,
                                                route="legs")
        default = tso.stencil_spmv(A, x, dots, aux)
        torch.cuda.synchronize()
        assert _routes(tso.stencil_spmv) == (c1[0] + 2, c1[1] + 1)
        assert _routes(tso.stencil_spmv_stream) == (
            c2[0] + (r2 == "box"), c2[1] + 1 + (r2 == "legs"))
        outs = [o if dots else (o,) for o in (box, legs, s2, s2_legs,
                                              default)]
        for o in outs[:1] + outs[2:]:
            assert torch.equal(o[0], outs[1][0])
        partner = {"x": x, "self": outs[1][0], "aux": aux}
        for j, kind in enumerate(dots, start=1):
            scale = float((outs[1][0] * partner[kind]).abs().sum())
            for o in outs:
                assert abs(float(o[j] - outs[1][j])) <= rtol * scale


@pytest.mark.cuda
def test_box_routes_refuse_what_they_cannot_take(card):
    """A forced box route raises for a leg outside the box (#1, #2) and,
    for #2, for lines that are not whole 16-byte vectors; nothing is
    counted."""
    far = tso.make_stencil([((0, 0, 0), 4.0), ((0, 2, 0), -1.0)], 8, 6, 5,
                           dtype=torch.float32, device=card)
    odd = tso.from_source_operator("hpcg:37x21x5", torch.float32, device=card)
    before = (_routes(tso.stencil_spmv), _routes(tso.stencil_spmv_stream))
    for A, fn in ((far, tso._stencil_spmv_cuda),
                  (far, tso._stencil_spmv_stream_cuda),
                  (odd, tso._stencil_spmv_stream_cuda)):
        x = torch.ones(A.n_rows, device=card)
        with pytest.raises(ValueError, match="box|16-byte"):
            fn(A, x, (), None, route="box")
    assert (_routes(tso.stencil_spmv),
            _routes(tso.stencil_spmv_stream)) == before


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["dia", "lane_ell", "stencil", "stream",
                                  "gs_step"])
def test_bf16_forms_equal_their_widened_twins(card, kind, dt):
    """Each bf16 form (#4, #5 with bf16 data; #1, #2, #3 with a bf16
    diagonal) gives the same kernel's result on the data widened to x's
    dtype bit for bit, #4 and #5 also their plain versions', and counts
    its launch in bf16_launches."""
    import dataclasses
    from basic_iterative_solvers_tpu_torch.coloring import spec_for_device
    from basic_iterative_solvers_tpu_torch.ops import dia_spmv, lane_ell
    g = torch.Generator(device="cuda").manual_seed(3)
    if kind == "dia":
        A = bt.dia.from_source_device(SPECS[2], torch.bfloat16, device=card)
        W = dataclasses.replace(A, data=A.data.to(dt))
        fn, plain = dia_spmv.dia_spmv, dia_spmv.dia_spmv_plain
    elif kind == "lane_ell":
        A = bt.from_csr(bt.generators.from_source("sband:3000,8,300"),
                        torch.bfloat16, "lane_ell", device=card)
        W = dataclasses.replace(A, vals=A.vals.to(dt))
        fn, plain = lane_ell.lane_ell_spmv, lane_ell.lane_ell_spmv_plain
    else:
        A = tso.from_source_operator(SPECS[2], torch.bfloat16, device=card)
        W = tso.make_stencil(zip(A.legs, A.coeff_values), *A.dims, dtype=dt,
                             diag=A.diag.to(dt), device=card)
        fn, plain = {"stencil": (tso.stencil_spmv, None),
                     "stream": (tso.stencil_spmv_stream, None),
                     "gs_step": (tso.stencil_gs_color_step, None)}[kind]
    x = torch.randn(A.n_rows, dtype=dt, device=card, generator=g)
    args = ()
    if kind == "gs_step":
        args = (torch.randn(A.n_rows, dtype=dt, device=card, generator=g),
                1.0 / tso.stencil_diag(A).to(dt), spec_for_device(A), 1)
    before = fn.bf16_launches
    y = fn(A, x, *args)
    assert fn.bf16_launches == before + 1
    assert torch.equal(y, fn(W, x, *args))
    if plain is not None:
        assert torch.equal(y, plain(A, x))


MESH_SPECS = ["hpcg:16x12x10", "hpcg:8x8x8", "fdm:70",
              "anderson:Lx=9,Ly=7,Lz=6,t=1.0,ranpot=4.0,seed=1"]


def _rows(W, v):
    """v placed on mesh operator W's shards in its layout."""
    return W.mesh.scatter(v, W.blocks.rows)


def _whole(W, v):
    """A MeshVector of W's layout, each shard on its device, gathered."""
    assert v.blocks == W.blocks
    assert [s.device for s in v.shards] == list(W.mesh.devices)
    return W.mesh.gather(v)


def _mesh_operands(card, kind, spec, dt, mat_dt):
    """(single-device operator, mesh operator, x) on an 8-shard mesh on
    the card."""
    import dataclasses
    from basic_iterative_solvers_tpu_torch.parallel import make_mesh
    from basic_iterative_solvers_tpu_torch.parallel import mesh_ops
    mesh = make_mesh(8, device=card)
    if kind == "dia":
        A = bt.dia.from_source_device(spec, mat_dt, device=card)
        W = mesh_ops.wrap_dia(A, mesh, "rows")
    elif kind == "lane_ell":
        A = bt.from_csr(bt.generators.from_source("sband:5000,8,300"),
                        mat_dt, "lane_ell", device=card)
        W = mesh_ops.wrap_lane_ell(A, mesh, "rows")
    else:
        A = tso.from_source_operator(spec, mat_dt, device=card)
        W = mesh_ops.wrap_stencil(dataclasses.replace(A, shards=8), mesh,
                                  "rows")
    g = np.random.default_rng(11)
    x = torch.from_numpy(g.standard_normal(A.n_rows)).to(card, dt)
    return A, W, x


@pytest.mark.cuda
@pytest.mark.parametrize("spec", MESH_SPECS)
@pytest.mark.parametrize("dt,mat_dt", [(torch.float32, torch.float32),
                                       (torch.float64, torch.float64),
                                       (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("kind", ["stencil", "gs_step", "dia", "lane_ell"])
def test_halo_forms_equal_single_device_and_plain(card, kind, spec, dt,
                                                  mat_dt):
    """Each shard-local kernel (#1, #3, #4, #5 halo forms) on an 8-shard
    mesh on the card: y concatenated over the shards bit-equal to the
    single-device kernel's, each shard within TOL of its plain twin (#1,
    #3: the plain version sums leg by leg) or bit-equal (#4, #5), one
    launch a shard counted."""
    from basic_iterative_solvers_tpu_torch.coloring import spec_for_device
    from basic_iterative_solvers_tpu_torch.ops import dia_spmv, lane_ell
    from basic_iterative_solvers_tpu_torch.parallel import mesh_ops
    from basic_iterative_solvers_tpu_torch.parallel.sharded import (
        _halo_exchange, _split)
    if kind in ("dia", "lane_ell") and spec != MESH_SPECS[0]:
        pytest.skip("the sparse formats run one operator")
    if mat_dt == torch.bfloat16 and kind in ("stencil", "gs_step") \
            and "anderson" not in spec:
        pytest.skip("a bf16 stencil form needs a diagonal (Anderson)")
    A, W, x = _mesh_operands(card, kind, spec, dt, mat_dt)
    tol = 1e-5 if dt == torch.float32 else 1e-12
    n_dev, R = W.n_devices, W.rows
    if kind == "gs_step":
        cs = spec_for_device(A)
        rhs = torch.randn_like(x)
        dinv = 1.0 / tso.stencil_diag(A).to(dt)
        colors = [(c,) for c in range(cs.n_colors)]
        if cs.kind == "grid" and cs.params[3] > 1:
            colors.append(tuple(range(cs.params[3])))
        counter = tso.stencil_gs_color_step_halo
        attr = "bf16_launches" if mat_dt == torch.bfloat16 else "launches"
        for c in colors:
            y1 = tso.stencil_gs_color_step(A, x, rhs, dinv, cs, c)
            before = getattr(counter, attr)
            y8 = _whole(W, mesh_ops.mesh_gs_color_step(
                W, _rows(W, x), _rows(W, rhs), _rows(W, dinv), cs, c))
            assert getattr(counter, attr) == before + n_dev * len(c)
            assert torch.equal(y1, y8), c
            p1 = tso.stencil_gs_color_step_plain(A, x, rhs, dinv, cs, c)
            assert float((y8 - p1).abs().max()) <= tol * float(
                p1.abs().max())
        return
    if kind == "stencil":
        y1 = tso._stencil_spmv_cuda(A, x, (), None)
        counter = tso.stencil_spmv_halo
        y8 = _whole(W, mesh_ops.mesh_stencil_spmv(W, _rows(W, x)))
    elif kind == "dia":
        y1 = dia_spmv.dia_spmv(A, x)
        counter = dia_spmv.dia_spmv_halo
        y8 = _whole(W, mesh_ops.mesh_dia_spmv(W, _rows(W, x)))
    else:
        y1 = lane_ell.lane_ell_spmv(A, x)
        counter = lane_ell.lane_ell_spmv_halo
        y8 = _whole(W, mesh_ops.mesh_lane_ell_spmv(W, _rows(W, x)))
    assert torch.equal(y1, y8)
    # each shard against its plain twin, on the same window
    attr = "bf16_launches" if mat_dt == torch.bfloat16 else "launches"
    if kind == "lane_ell":
        npad = W.inner.R * lane_ell.LANES
        h = W.inner.S * lane_ell.LANES
    else:
        npad = n_dev * R
        h = None
    xs = _split(torch.nn.functional.pad(x, (0, npad - x.numel())), n_dev)
    if kind == "stencil":
        windows = _halo_exchange(W.mesh, xs, *A.window_halo)
    elif kind == "dia":
        from basic_iterative_solvers_tpu_torch.parallel.sharded import _halo
        hneg, hpos = _halo(A.offsets)
        windows = _halo_exchange(W.mesh, xs, hneg, hpos)
    else:
        windows = _halo_exchange(W.mesh, xs, h, h)
    for k in range(n_dev):
        before = getattr(counter, attr)
        if kind == "stencil":
            d = None if W.diag_shards is None else W.diag_shards[k]
            yk = tso.stencil_spmv_halo(A, windows[k], k * R, ("x",),
                                       diag=d)
            pk = tso.stencil_spmv_halo_plain(A, windows[k], k * R, ("x",),
                                             diag=d)
            scale = float(pk[0].abs().max()) or 1.0
            assert float((yk[0] - pk[0]).abs().max()) <= tol * scale
            hneg = A.window_halo[0]
            dscale = float((pk[0] * windows[k][hneg:hneg + R])
                           .abs().sum()) or 1.0
            assert abs(float(yk[1] - pk[1])) <= tol * dscale
        elif kind == "dia":
            yk = dia_spmv.dia_spmv_halo(W.data_shards[k], A.offsets,
                                        windows[k], hneg)
            assert torch.equal(yk, dia_spmv.dia_spmv_halo_plain(
                W.data_shards[k], A.offsets, windows[k], hneg))
        else:
            M = W.inner
            yk = lane_ell.lane_ell_spmv_halo(M, W.vals_shards[k],
                                             W.idx_shards[k], windows[k],
                                             k * R, M.S)
            assert torch.equal(yk, lane_ell.lane_ell_spmv_halo_plain(
                M, W.vals_shards[k], W.idx_shards[k], windows[k], k * R,
                M.S))
        assert getattr(counter, attr) == before + 1


@pytest.mark.cuda
def test_mesh_solve_on_the_card(card):
    """CG + Jacobi and SGS (masked sweeps) on an 8-shard mesh on the card
    take the single-device solve's counts, through the halo kernels."""
    from basic_iterative_solvers_tpu_torch.parallel import (make_mesh,
                                                            shard_setup)
    mesh = make_mesh(8, device=card)
    for spec, method, precond in (
            ("hpcg:16x16x16", "CONJUGATE_GRADIENT", "JACOBI"),
            ("fdm:32", "SYMMETRIC_GAUSS_SEIDEL", "NONE")):
        A = tso.from_source_operator(spec, torch.float64, device=card)
        cfg = bt.SolverConfig(method=bt.SolverType[method],
                              preconditioner=bt.PrecondType[precond],
                              dtype=torch.float64, tolerance=1e-6,
                              harness="fused", max_iters=3000)
        r1 = bt.solve(bt.preprocessing_device(A, cfg))
        before = (tso.stencil_spmv_halo.launches,
                  tso.stencil_gs_color_step_halo.launches)
        r8 = bt.solve(shard_setup(bt.preprocessing_device(A, cfg), mesh,
                                  mode="shard_map"))
        assert r8.converged and r8.iter_count == r1.iter_count
        # the sampled history; the explicit final residual after it sits
        # nearer the rounding floor
        np.testing.assert_allclose(r8.residual_norms[:-1],
                                   r1.residual_norms[:-1], rtol=1e-8)
        np.testing.assert_allclose(r8.residual_norms[-1],
                                   r1.residual_norms[-1], rtol=1e-4)
        assert tso.stencil_spmv_halo.launches > before[0]
        if method != "CONJUGATE_GRADIENT":
            assert tso.stencil_gs_color_step_halo.launches > before[1]


def _mesh_pair(card, spec, mode, dt):
    """(L, U) of `mode` on the card: the analytic const GS pair or the
    factor-table ILU(0) pair of a stencil, or the ILU(0) pair from host
    CSR (L in plane mode) and the SGS pair from host CSR (const, per-row
    D) under the source's grid spec."""
    from basic_iterative_solvers_tpu_torch.coloring import spec_for_device
    from basic_iterative_solvers_tpu_torch.ops import block_trisolve as bk
    if mode in ("const", "table") and spec.startswith("hpcg"):
        A = tso.from_source_operator(spec, dt, device=card)
        if mode == "const":
            return bk.build_superblock_gs_pair_stencil(
                A, spec_for_device(A), dtype=dt, need_d=True)
        return bk.build_superblock_ilu0_pair_stencil(A, spec_for_device(A),
                                                     dtype=dt)
    cfg = bt.SolverConfig(
        preconditioner=bt.PrecondType["ILU0" if mode == "plane"
                                      else "SYMMETRIC_GAUSS_SEIDEL"],
        dtype=dt, gs_mode="colored",
        color_spec=bt.generators.color_spec_for_source(spec))
    M = bt.preprocessing(bt.generators.from_source(spec), cfg,
                         device=card).M
    return M.L_block, M.U_block


MESH_SUPER = [("hpcg:16x12x8", 4, "const"), ("hpcg:16x12x8", 4, "table"),
              ("hpcg:8x8x8", 8, "table"), ("fdm:32", 8, "const"),
              ("fdm:32", 8, "plane"), ("hpcg:16x12x8", 4, "plane")]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("spec,n_dev,mode", MESH_SUPER)
def test_mesh_super_level_equals_twin_and_single_device(card, spec, n_dev,
                                                        mode, dt):
    """Kernel #9's mesh form: every shard's launch of every level of L and
    U bit-equal to its plain twin on the same window, the shards' own
    rows together bit-equal to the single-device kernel's level, one
    launch a shard that owns lines of the level counted."""
    from basic_iterative_solvers_tpu_torch.ops import block_trisolve as bk
    from basic_iterative_solvers_tpu_torch.parallel import make_mesh
    L, U = _mesh_pair(card, spec, mode, dt)
    mesh = make_mesh(n_dev, device=card)
    g = np.random.default_rng(5)
    for B in (L, U):
        # a plane pair's U is const mode with a per-row D
        attr = ("table_launches" if B.is_table else "plane_launches"
                if B.is_plane else "launches")
        MB = bk.shard_superblock(B, mesh)
        n, R, H = B.n_rows, MB.rows, MB.halo
        pad = n_dev * R - n
        for li in range(len(B.levels)):
            y = torch.from_numpy(g.standard_normal(n)).to(card, dt)
            x = torch.from_numpy(g.standard_normal(n)).to(card, dt)
            single = bk.super_level(B, li, y, x.clone())
            xw = torch.nn.functional.pad(x, (H, pad + H))
            yw = torch.nn.functional.pad(y, (0, pad))
            owned = []
            for k, Bs in enumerate(MB.shards):
                yk = yw[k * R:(k + 1) * R].clone()
                win = xw[k * R:(k + 1) * R + 2 * H].clone()
                twin = bk.super_level_halo_plain(Bs, li, yk, win.clone())
                before = getattr(bk.super_level_halo, attr)
                bk.super_level_halo(Bs, li, yk, win)
                torch.cuda.synchronize()
                lines = Bs.lines[li][1] - Bs.lines[li][0]
                assert getattr(bk.super_level_halo, attr) == before + (
                    1 if lines else 0)
                assert torch.equal(win, twin), (li, k)
                owned.append(win[H:H + R])
            assert torch.equal(torch.cat(owned)[:n], single), li


def _launch_on(bk, B, Bs, li, route, y, x):
    """One launch of level li (whole, or shard Bs's part) with `route`
    forced through the route cache, the cached route restored after."""
    cache = B._args if Bs is None else Bs._args
    key = ("route", li, x.element_size(), x.device.index)
    saved = cache.get(key)
    cache[key] = route
    try:
        if Bs is None:
            return bk.super_level(B, li, y, x)
        return bk.super_level_halo(Bs, li, y, x)
    finally:
        if saved is None:
            del cache[key]
        else:
            cache[key] = saved


LINE_PAIRS = [("fdm:32", "plane"), ("hpcg:16x12x8", "plane"),
              ("hpcg:16x16x16", "const"),
              ("anderson:Lx=9,Ly=8,Lz=6,t=1.0,ranpot=4.0,seed=1", "const")]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("spec,mode", LINE_PAIRS)
def test_line_route_equals_direct_and_plain(card, spec, mode, dt):
    """#9's line route (plane mode, const mode with a constant or a
    per-row D): every level of L and U, on one device and on every shard
    of a 4-shard mesh, bit-equal to the direct route and to the plain
    level (the shard's plain twin), each route forced through the route
    cache; the picker names the direct route for launches this small;
    each launch is counted in its mode and route's counter."""
    from basic_iterative_solvers_tpu_torch.ops import block_trisolve as bk
    from basic_iterative_solvers_tpu_torch.parallel import make_mesh
    L, U = _mesh_pair(card, spec, mode, dt)
    assert L.is_plane == (mode == "plane")
    mesh = make_mesh(4, device=card)
    g = np.random.default_rng(23)
    for B in (L, U):
        kind = "plane" if B.is_plane else "const"
        MB = bk.shard_superblock(B, mesh)
        n, R, H = B.n_rows, MB.rows, MB.halo
        pad = 4 * R - n
        for li in range(len(B.levels)):
            y = torch.from_numpy(g.standard_normal(n)).to(card, dt)
            x = torch.from_numpy(g.standard_normal(n)).to(card, dt)
            xw = torch.nn.functional.pad(x, (H, pad + H))
            yw = torch.nn.functional.pad(y, (0, pad))
            launches = [(None, y, x, bk.super_level,
                         bk.super_level_plain(B, li, y, x.clone()))]
            for k, Bs in enumerate(MB.shards):
                if Bs.lines[li][1] > Bs.lines[li][0]:
                    yk = yw[k * R:(k + 1) * R].clone()
                    win = xw[k * R:(k + 1) * R + 2 * H].clone()
                    launches.append((Bs, yk, win, bk.super_level_halo,
                                     bk.super_level_halo_plain(
                                         Bs, li, yk, win.clone())))
            for Bs, yk, xk, counter, ref in launches:
                # launches this small leave the card idle: the picker names
                # the direct route; both run when forced
                assert bk.level_route_for(B, li, xk.element_size(), Bs,
                                          card) == "direct"
                outs = {}
                for route in ("line", "direct"):
                    attr = f"{kind}_{route}_launches"
                    before = getattr(counter, attr)
                    outs[route] = _launch_on(bk, B, Bs, li, route, yk,
                                             xk.clone())
                    assert getattr(counter, attr) == before + 1
                torch.cuda.synchronize()
                assert torch.equal(outs["line"], ref), (B.upper, li)
                assert torch.equal(outs["line"], outs["direct"])


@pytest.mark.cuda
def test_solves_launch_the_line_route(card):
    """CG + SGS on HPCG 32^3 (const levels) and CG + ILU(0) on fdm:64 from
    host CSR (L plane, U const with a per-row D), float64, fused: every
    plane and const level launched on the line route, none on the direct
    route; the same counts and histories with the direct route forced."""
    from basic_iterative_solvers_tpu_torch.ops import block_trisolve as bk
    for spec, precond in (("hpcg:32x32x32", "SYMMETRIC_GAUSS_SEIDEL"),
                          ("fdm:64", "ILU0")):
        cfg = bt.SolverConfig(
            method=bt.SolverType.CONJUGATE_GRADIENT,
            preconditioner=bt.PrecondType[precond], dtype=torch.float64,
            gs_mode="colored", tolerance=1e-10, max_iters=500,
            color_spec=bt.generators.color_spec_for_source(spec))
        setup = bt.preprocessing(bt.generators.from_source(spec), cfg,
                                 device=card)
        res = {}
        idx = torch.cuda.current_device()
        for route in ("line", "direct"):
            for B in (setup.M.L_block, setup.M.U_block):
                for li in range(len(B.levels)):
                    B._args[("route", li, 8, idx)] = route
            for kind in ("const", "plane"):
                for rt in ("line", "direct"):
                    setattr(bk.super_level, f"{kind}_{rt}_launches", 0)
            res[route] = bt.solve(setup)
            counts = {rt: sum(getattr(bk.super_level, f"{k}_{rt}_launches")
                              for k in ("const", "plane"))
                      for rt in ("line", "direct")}
            other = "direct" if route == "line" else "line"
            assert counts[route] > 0 and counts[other] == 0, (spec, counts)
        assert res["line"].converged
        assert res["line"].iter_count == res["direct"].iter_count
        np.testing.assert_allclose(res["line"].residual_norms,
                                   res["direct"].residual_norms, rtol=1e-12)


@pytest.mark.cuda
def test_mesh_superblock_solves_on_the_card(card):
    """CG + SGS (const) and CG + ILU(0) (factor table) on an 8-shard mesh
    on the card, the blocks cut into the shards: the single-device
    solve's counts and histories (rtol 1e-8), the mesh form of #9
    launched."""
    from basic_iterative_solvers_tpu_torch.ops import block_trisolve as bk
    from basic_iterative_solvers_tpu_torch.parallel import (make_mesh,
                                                            shard_setup)
    mesh = make_mesh(8, device=card)
    for precond, attr in (("SYMMETRIC_GAUSS_SEIDEL", "launches"),
                          ("ILU0", "table_launches")):
        A = tso.from_source_operator("hpcg:16x16x16", torch.float64,
                                     device=card)
        cfg = bt.SolverConfig(preconditioner=bt.PrecondType[precond],
                              dtype=torch.float64, tolerance=1e-8,
                              harness="fused", max_iters=500)
        r1 = bt.solve(bt.preprocessing_device(A, cfg))
        before = getattr(bk.super_level_halo, attr)
        s8 = shard_setup(bt.preprocessing_device(A, cfg), mesh,
                         mode="shard_map")
        assert isinstance(s8.M.L_block, bk.MeshSuperBlockTriSolve)
        r8 = bt.solve(s8)
        assert r8.converged and r8.iter_count == r1.iter_count
        np.testing.assert_allclose(r8.residual_norms[:-1],
                                   r1.residual_norms[:-1], rtol=1e-8)
        assert getattr(bk.super_level_halo, attr) > before


#: a basis kernel's Pw/Pv against plain, relative to Σ|V_i·w| of the row
#: (chip_smoke.BASIS_TOL: float32 sums in different orders)
BASIS_TOL = 1e-5


def _basis_operands(card, rows, n, dtype, seed):
    g = np.random.default_rng(seed)
    V = torch.from_numpy(g.standard_normal((rows, n)).astype(np.float32))
    w, vc, ht = (torch.from_numpy(g.standard_normal(k).astype(np.float32))
                 .to(card) for k in (n, n, rows))
    return V.to(card, dtype), w, vc, ht


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [2, 51, 130])
@pytest.mark.parametrize("n,route", [(8192 * 3, "ring"),
                                     (8192 * 3, "strided"),
                                     (12347, "strided")],
                         ids=["aligned-ring", "aligned-strided",
                              "ragged-strided"])
def test_basis_routes_equal_plain(card, n, route, rows, dtype):
    """#6 and #7 on each route against their plain versions, j in
    {0, 7, rows - 2}: the written row and vnext bit for bit, nrm2 within
    1e-5 relative, Pw/Pv within BASIS_TOL of Σ|V_i·w| and exact zeros
    beyond row j; each call counted once on its route; the ring route's
    results the same bits on a second call (the blocks' partials summed
    in block order, the ticket reset)."""
    from basic_iterative_solvers_tpu_torch.ops import gmres_basis as gb
    V, w, vc, ht = _basis_operands(card, rows, n, dtype, rows)
    for j in sorted({0, 7, rows - 2} & set(range(rows - 1))):
        counts = [(f, f.launches, getattr(f, f"{route}_launches"))
                  for f in (gb.project_gram, gb.correct_write)]
        Pk = gb._project_gram_cuda(V, w, vc, j, route)
        Pp = gb.project_gram_plain(V, w, vc, j)
        Vk, Vp = V.clone(), V.clone()
        vk, nk = gb._correct_write_cuda(Vk, w, ht, j, route)
        vp, np_ = gb.correct_write_plain(Vp, w, ht, j)
        torch.cuda.synchronize()
        for f, total, on_route in counts:
            assert f.launches == total + 1
            assert getattr(f, f"{route}_launches") == on_route + 1
        Vf = V[:j + 1].float()
        for k, p, v in zip(Pk, Pp, (w, vc)):
            assert k.shape == (rows,) and k.dtype == torch.float32
            scale = (Vf * v).abs().sum(1)
            assert bool(((k[:j + 1] - p[:j + 1]).abs()
                         <= BASIS_TOL * scale).all())
            assert not k[j + 1:].any()
        assert torch.equal(Vk, Vp) and torch.equal(vk, vp)
        assert abs(float(nk) - float(np_)) <= 1e-5 * float(np_)
        if route == "ring":
            again = gb._project_gram_cuda(V, w, vc, j, route)
            assert all(torch.equal(a, b) for a, b in zip(again, Pk))
            v2, n2 = gb._correct_write_cuda(V.clone(), w, ht, j, route)
            assert torch.equal(v2, vk) and torch.equal(n2, nk)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grid", [37, 264], ids=["grid37", "grid264"])
def test_basis_ring_sums_read_only_written_partials(card, grid, dtype):
    """The ring route's cross-block sums add only the partials its blocks
    wrote in the launch: with the scratch filled with NaN, at grids whose
    last group of blocks is part-full (37 = 2 * 16 + 5; 264 = 16 * 16 + 8,
    #6's grid on an H100), Pw/Pv, vnext and nrm2 are finite and the same
    bits as with a zeroed scratch, Pw/Pv within BASIS_TOL of plain and
    zero beyond row j, over two groups of 64 rows."""
    from basic_iterative_solvers_tpu_torch.ops import gmres_basis as gb
    rows, n, j = 70, 512 * 8 * 264, 68
    V, w, vc, ht = _basis_operands(card, rows, n, dtype, grid)
    stream = torch.cuda.current_stream(card)
    out = {}
    for key, fill in (("zero", 0.0), ("nan", float("nan"))):
        def scratch(name):
            return torch.full((gb.ring_scratch(name, rows, n, j, grid),),
                              fill, device=card)
        Vk = V.clone()
        out[key] = (gb._project_gram_ring(V, w, vc, j, grid,
                                           scratch("project_gram"), stream)
                     + gb._correct_write_ring(Vk, w, ht, j, grid,
                                              scratch("correct_write"),
                                              stream) + (Vk,))
    torch.cuda.synchronize()
    Pp = gb.project_gram_plain(V, w, vc, j)
    Vp = V.clone()
    vp, np_ = gb.correct_write_plain(Vp, w, ht, j)
    Pw, Pv, vk, nk, Vk = out["nan"]
    assert all(torch.equal(a, b) for a, b in zip(out["zero"], out["nan"]))
    assert all(bool(t.isfinite().all()) for t in (Pw, Pv, vk, nk))
    Vf = V[:j + 1].float()
    for k, p, v in zip((Pw, Pv), Pp, (w, vc)):
        assert bool(((k[:j + 1] - p[:j + 1]).abs()
                     <= BASIS_TOL * (Vf * v).abs().sum(1)).all())
        assert not k[j + 1:].any()
    assert torch.equal(Vk, Vp) and torch.equal(vk, vp)
    assert abs(float(nk) - float(np_)) <= 1e-5 * float(np_)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_basis_wrappers_take_the_shape_route(card, dtype):
    """The public wrappers launch the ring route on aligned rows and the
    strided route on a ragged row or an offset base, counted on each."""
    from basic_iterative_solvers_tpu_torch.ops import gmres_basis as gb
    n, rows = 8192 * 3, 6
    V, w, vc, ht = _basis_operands(card, rows, n, dtype, 5)
    flat = torch.zeros(rows * n + 1, dtype=dtype, device=card)
    offset = flat[1:].view(rows, n)
    offset.copy_(V)
    ragged = V[:, :12347].contiguous()
    for basis, wv, vcv, route in (
            (V, w, vc, "ring"), (offset, w, vc, "strided"),
            (ragged, w[:12347].clone(), vc[:12347].clone(), "strided")):
        assert gb.route_for(basis, wv, vcv) == route
        before = [(f.launches, getattr(f, f"{route}_launches"))
                  for f in (gb.project_gram, gb.correct_write)]
        Pk = gb.project_gram(basis, wv, vcv, 2)
        Pp = gb.project_gram_plain(basis, wv, vcv, 2)
        Bp = basis.clone()     # a clone is aligned: the kernel writes basis
        vp, _ = gb.correct_write_plain(Bp, wv, ht, 2)
        vk, _ = gb.correct_write(basis, wv, ht, 2)
        torch.cuda.synchronize()
        assert [(f.launches, getattr(f, f"{route}_launches"))
                for f in (gb.project_gram, gb.correct_write)] == [
            (a + 1, b + 1) for a, b in before]
        assert torch.equal(basis, Bp) and torch.equal(vk, vp)
        for k, p in zip(Pk, Pp):
            assert bool(((k - p).abs() <= 1e-3 * p.abs().max()).all())


# ---------------------------------------------------------------------------
# #5's counted routes and #9's staged factor-table route
# ---------------------------------------------------------------------------

LANE_SPEC = "sband:60000,8,400"


@pytest.mark.cuda
@pytest.mark.parametrize("dt,mat_dt", [(torch.float32, torch.float32),
                                       (torch.float64, torch.float64),
                                       (torch.float32, torch.bfloat16),
                                       (torch.float64, torch.bfloat16)])
def test_lane_ell_routes_equal_plain(card, dt, mat_dt):
    """Both routes of #5 (idx16, the shape's; idx32) bit-equal to the
    plain version on finite x, each launch counted in its route's counter;
    the wrapper takes idx16."""
    from basic_iterative_solvers_tpu_torch.ops import lane_ell
    M = bt.from_csr(bt.generators.from_source(LANE_SPEC), mat_dt,
                    "lane_ell", device=card)
    assert lane_ell.route_for(M) == "idx16"
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        M.n_rows)).to(card, dt)
    yp = lane_ell.lane_ell_spmv_plain(M, x)
    for route in lane_ell.ROUTES:
        before = getattr(lane_ell.lane_ell_spmv, f"{route}_launches")
        y = lane_ell._lane_ell_spmv_cuda(M, x, route)
        torch.cuda.synchronize()
        assert getattr(lane_ell.lane_ell_spmv,
                       f"{route}_launches") == before + 1
        assert torch.equal(y, yp), route
    before = lane_ell.lane_ell_spmv.idx16_launches
    assert torch.equal(lane_ell.lane_ell_spmv(M, x), yp)
    assert lane_ell.lane_ell_spmv.idx16_launches == before + 1


@pytest.mark.cuda
def test_lane_ell_nonfinite_x_at_a_pad_column(card):
    """The departure by design, on the card: with Inf in x at a column a
    skipped pad slot points at, both routes differ from the plain version
    only on rows holding such a slot (plain NaN, kernel not), and the
    halo form's padded route keeps the plain version's result there."""
    from basic_iterative_solvers_tpu_torch.ops import lane_ell
    M = bt.from_csr(bt.generators.from_source(LANE_SPEC), torch.float32,
                    "lane_ell", device=card)
    plane = M.R * lane_ell.LANES
    r = torch.arange(M.R, device=card).view(M.R, 1)
    cols = ((r + M.idx.long() // lane_ell.LANES - M.S) * lane_ell.LANES
            + M.idx.long() % lane_ell.LANES).clamp(0, plane - 1)
    skipped = (torch.arange(M.K, device=card).view(M.K, 1, 1)
               >= M.row_len.long())
    j = int(cols[skipped].min())
    x = torch.randn(M.n_rows, device=card,
                    generator=torch.Generator(device="cuda").manual_seed(2))
    x[j] = float("inf")
    yp = lane_ell.lane_ell_spmv_plain(M, x)
    hit = (skipped & (cols == j)).any(0).reshape(-1)[:M.n_rows]
    for route in ("idx16", "idx32"):
        yk = lane_ell._lane_ell_spmv_cuda(M, x, route)
        differ = ~((yk == yp) | (yk.isnan() & yp.isnan()))
        assert differ.any() and not (differ & ~hit).any()
        assert yp[differ].isnan().all() and not yk[differ].isnan().any()
    # one shard covering every row, its window x with S x2-rows of zeros
    # a side
    h = M.S * lane_ell.LANES
    xw = torch.nn.functional.pad(x, (h, plane - M.n_rows + h))
    yk = lane_ell._lane_ell_spmv_halo_cuda(M, M.vals, M.idx16, xw, 0, M.S,
                                           None, "padded")[:M.n_rows]
    assert bool(((yk == yp) | (yk.isnan() & yp.isnan())).all())


@pytest.mark.cuda
@pytest.mark.parametrize("mat_dt", [torch.float32, torch.bfloat16])
def test_lane_ell_halo_routes_equal_plain(card, mat_dt):
    """#5's halo form on an 8-shard mesh: both routes' shards, on the
    16-bit plane the mesh holds and on the int32 one, bit-equal to their
    plain twins, each launch counted in its route's counter; the wrapper
    takes the shape's route (padded: these shards are a few blocks)."""
    from basic_iterative_solvers_tpu_torch.ops import lane_ell
    from basic_iterative_solvers_tpu_torch.parallel import make_mesh
    from basic_iterative_solvers_tpu_torch.parallel import mesh_ops
    from basic_iterative_solvers_tpu_torch.parallel.sharded import (
        _halo_exchange, _split)
    A = bt.from_csr(bt.generators.from_source(LANE_SPEC), mat_dt,
                    "lane_ell", device=card)
    mesh = make_mesh(8, device=card)
    W = mesh_ops.wrap_lane_ell(A, mesh, "rows")
    M, R = W.inner, W.rows
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        A.n_rows)).to(card, torch.float32)
    h = M.S * lane_ell.LANES
    xs = _split(torch.nn.functional.pad(x, (0, M.R * lane_ell.LANES
                                            - x.numel())), 8)
    wins = _halo_exchange(mesh, xs, h, h)
    for k in range(8):
        twin = lane_ell.lane_ell_spmv_halo_plain(
            M, W.vals_shards[k], W.idx_shards[k], wins[k], k * R, M.S)
        idx32 = M.idx[:, k * R:(k + 1) * R].contiguous()
        assert W.idx_shards[k].dtype == torch.int16
        for route in lane_ell.HALO_ROUTES:
            for idx in (W.idx_shards[k], idx32):
                before = getattr(lane_ell.lane_ell_spmv_halo,
                                 f"{route}_launches")
                yk = lane_ell._lane_ell_spmv_halo_cuda(
                    M, W.vals_shards[k], idx, wins[k], k * R, M.S, None,
                    route)
                torch.cuda.synchronize()
                assert getattr(lane_ell.lane_ell_spmv_halo,
                               f"{route}_launches") == before + 1
                assert torch.equal(yk, twin), (k, route, idx.dtype)
        before = lane_ell.lane_ell_spmv_halo.padded_launches
        assert torch.equal(lane_ell.lane_ell_spmv_halo(
            M, W.vals_shards[k], W.idx_shards[k], wins[k], k * R, M.S), twin)
        assert lane_ell.lane_ell_spmv_halo.padded_launches == before + 1


def _table_pair(card, spec, dt):
    from basic_iterative_solvers_tpu_torch.coloring import spec_for_device
    from basic_iterative_solvers_tpu_torch.ops import block_trisolve as bk
    A = tso.from_source_operator(spec, dt, device=card)
    return A, bk.build_superblock_ilu0_pair_stencil(A, spec_for_device(A),
                                                    dtype=dt)


def _on_route(bk, route, fn, *args):
    saved = bk.level_route_for
    bk.level_route_for = lambda *a, **k: route
    try:
        return fn(*args)
    finally:
        bk.level_route_for = saved


def _direct_level(bk, fn, *args):
    return _on_route(bk, "direct", fn, *args)


@pytest.mark.cuda
@pytest.mark.parametrize("spec,dt,levels", [
    ("hpcg:128x128x128", torch.float32, "all"),
    ("hpcg:128x128x128", torch.float64, "all"),
    ("hpcg:36x20x16", torch.float64, "all"),
    ("hpcg:384x384x384", torch.float32, "last")])
def test_table_level_staged_equals_plain_and_direct(card, spec, dt, levels):
    """#9's factor-table level on the shape's route (staged in float32,
    direct in float64), every level (at 384^3 the last L and U levels, the
    most cross legs) bit-equal to the plain level and to the direct route,
    each launch counted in its route's counter; a whole apply equal on
    both routes."""
    from basic_iterative_solvers_tpu_torch.ops import block_trisolve as bk
    A, (L, U) = _table_pair(card, spec, dt)
    g = torch.Generator(device="cuda").manual_seed(13)
    y = torch.randn(A.n_rows, dtype=dt, device=card, generator=g)
    x = torch.randn(A.n_rows, dtype=dt, device=card, generator=g)
    route = "staged" if dt == torch.float32 else "direct"
    for B in (L, U):
        lis = (range(len(B.levels)) if levels == "all"
               else (len(B.levels) - 1,))
        for li in lis:
            assert bk.level_route_for(B, li, x.element_size(),
                                      device=x.device) == route
            attr = f"table_{route}_launches"
            before = getattr(bk.super_level, attr)
            xs, xd, xp = x.clone(), x.clone(), x.clone()
            bk.super_level(B, li, y, xs)
            assert getattr(bk.super_level, attr) == before + 1
            _direct_level(bk, bk.super_level, B, li, y, xd)
            bk.super_level_plain(B, li, y, xp)
            torch.cuda.synchronize()
            assert torch.equal(xs, xp) and torch.equal(xs, xd), (B.upper, li)
    if levels == "all":
        z = bk.blocked_ilu0(L, U, y)
        assert torch.equal(z, _direct_level(bk, bk.blocked_ilu0, L, U, y))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_table_level_staged_on_a_mesh(card, dt):
    """#9's mesh form in factor-table mode on a 4-shard mesh: each shard's
    launch on the staged route in float32 (forced: these shards' grids are
    too small for level_route_for to take it; float64 has only the direct
    route) bit-equal to its plain twin and to the direct route, the launch
    counted in its route's counter."""
    from basic_iterative_solvers_tpu_torch.ops import block_trisolve as bk
    from basic_iterative_solvers_tpu_torch.parallel import make_mesh
    route = "staged" if dt == torch.float32 else "direct"
    _A, (L, U) = _table_pair(card, "hpcg:32x32x32", dt)
    mesh = make_mesh(4, device=card)
    g = torch.Generator(device="cuda").manual_seed(17)
    for B in (L, U):
        MB = bk.shard_superblock(B, mesh)
        n, R, H = B.n_rows, MB.rows, MB.halo
        pad = 4 * R - n
        for li in range(len(B.levels)):
            y = torch.randn(n, dtype=dt, device=card, generator=g)
            x = torch.randn(n, dtype=dt, device=card, generator=g)
            xw = torch.nn.functional.pad(x, (H, pad + H))
            ys = torch.nn.functional.pad(y, (0, pad)).split(R)
            for k, Bs in enumerate(MB.shards):
                win = xw[k * R:(k + 1) * R + 2 * H]
                ws, wd = win.clone(), win.clone()
                twin = bk.super_level_halo_plain(Bs, li, ys[k].clone(),
                                                 win.clone())
                attr = f"table_{route}_launches"
                before = getattr(bk.super_level_halo, attr)
                _on_route(bk, route, bk.super_level_halo, Bs, li,
                          ys[k].clone(), ws)
                owns = Bs.lines[li][1] > Bs.lines[li][0]
                assert getattr(bk.super_level_halo, attr) == before + owns
                _direct_level(bk, bk.super_level_halo, Bs, li,
                              ys[k].clone(), wd)
                torch.cuda.synchronize()
                assert torch.equal(ws, twin) and torch.equal(ws, wd)


RANK_CASES = [("band:30000,2", None), ("band:5000,3", None),
              ("fdm:64", 3), ("band:2000,8", None)]


def _rank_pair(card, spec, mod, dt):
    from basic_iterative_solvers_tpu_torch import coloring as tcol
    from basic_iterative_solvers_tpu_torch.ops import block_trisolve as bk
    A = bt.generators.from_source(spec)
    cs = (bt.generators.color_spec_for_source(spec) if mod is None
          else tcol.ColorSpec("mod", mod, (mod,)))
    colors = tcol.spec_colors_np(cs, A.n_rows)
    return bk.build_best_trisolve_pair(A, A.diagonal(), A.diagonal(), colors,
                                       cs, dtype=dt, need_d=True, device=card)


def _rank_routes(bk):
    return (bk.rank_level.vec_launches, bk.rank_level.scalar_launches)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("spec,mod", RANK_CASES)
def test_rank_level_routes_equal_plain(card, spec, mod, dt):
    """Kernel #8 on every level with groups: the vec and the scalar route
    bit-equal to each other and to the plain level (on the CPU), with y a
    separate tensor and with y aliasing x (the U solve in place); the
    level's launch counted on its route; rank_route_for names "vec" where
    the level has at most 8 groups, 2 in float64 (band:2000,8's longest
    levels: scalar, and the vec route refuses them)."""
    from basic_iterative_solvers_tpu_torch.ops import block_trisolve as bk
    g = torch.Generator(device="cuda").manual_seed(5)
    for B in _rank_pair(card, spec, mod, dt):
        Bc = dataclasses.replace(B, vals=B.vals.cpu(), dinv=B.dinv.cpu(),
                                 d=None, _tables={})
        for li, (c, groups) in enumerate(B.levels):
            if not groups:
                continue
            want = ("vec" if len(groups) <= (
                2 if dt == torch.float64 else 8) else "scalar")
            assert bk.rank_route_for(B, li) == want
            X = torch.randn((B.n_colors, B.M), dtype=dt, device=card,
                            generator=g)
            Y = torch.randn_like(X)
            for alias in (False, True):
                outs = {}
                for route in ("vec", "scalar"):
                    if route == "vec" and len(groups) > 8:
                        with pytest.raises(ValueError, match="vec route"):
                            bk.rank_level(B, li, Y, X.clone(), route=route)
                        continue
                    count = f"{route}_launches"
                    before = getattr(bk.rank_level, count)
                    x = X.clone()
                    bk.rank_level(B, li, x if alias else Y, x, route=route)
                    assert getattr(bk.rank_level, count) == before + 1
                    outs[route] = x
                xp = X.cpu()
                bk.rank_level_plain(Bc, li, xp if alias else Y.cpu(), xp)
                torch.cuda.synchronize()
                for route, x in outs.items():
                    assert torch.equal(x.cpu(), xp), (route, li, alias)
                before = getattr(bk.rank_level, f"{want}_launches")
                bk.rank_level(B, li, Y, X.clone())
                assert getattr(bk.rank_level, f"{want}_launches") == \
                    before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_blocked_sgs_takes_the_vec_route(card, dt):
    """A whole blocked_sgs apply on band:30000,2 launches its 4 levels on
    the picker's routes (all vec in float32; the 2-group ones in float64)
    and equals the CPU's plain apply bit for bit."""
    from basic_iterative_solvers_tpu_torch.ops import block_trisolve as bk
    L, U = _rank_pair(card, "band:30000,2", None, dt)
    y = torch.randn(L.n_rows, dtype=dt, device=card)
    before = _rank_routes(bk)
    z = bk.blocked_sgs(L, U, y)
    vec = 4 if dt == torch.float32 else 2
    assert _rank_routes(bk) == (before[0] + vec, before[1] + 4 - vec)
    Lc, Uc = (dataclasses.replace(B, vals=B.vals.cpu(), dinv=B.dinv.cpu(),
                                  d=None if B.d is None else B.d.cpu(),
                                  _tables={}) for B in (L, U))
    assert torch.equal(z.cpu(), bk.blocked_sgs(Lc, Uc, y.cpu()))


GS_BOX_CASES = ["hpcg:128x128x128", "hpcg:37x21x5", "fdm:2048", "fdm:70",
                "anderson:Lx=32,Ly=24,Lz=16,t=1.0,ranpot=4.0,seed=1",
                "bf16:anderson:Lx=32,Ly=24,Lz=16,t=1.0,ranpot=4.0,seed=1"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", GS_BOX_CASES)
@pytest.mark.parametrize("dt,rtol", [(torch.float32, 1e-5),
                                     (torch.float64, 1e-12)])
def test_gs_step_routes_equal_plain(card, case, dt, rtol):
    """#3 on every colour: the box route (forced wherever lines are whole
    16-byte vectors) and the leg loop bit-equal, within rtol of plain
    (which sums leg by leg); each launch counted on its route, the
    default call on gs_route_for's (box there, but for float64 on a 3-D
    grid); a forced box route on lines it cannot take raises."""
    from basic_iterative_solvers_tpu_torch.coloring import spec_for_device
    A = _box_operator(card, case, dt)
    g = torch.Generator(device="cuda").manual_seed(9)
    x = torch.randn(A.n_rows, dtype=dt, device=card, generator=g)
    rhs = torch.randn(A.n_rows, dtype=dt, device=card, generator=g)
    dinv = 1.0 / tso.stencil_diag(A).to(dt)
    cs = spec_for_device(A)
    route = tso.gs_route_for(A, x, rhs, dinv, cs)
    fits = A.dims[0] % (16 // x.element_size()) == 0
    flat = A.dims[2] == 1
    assert route == ("box" if fits and (dt == torch.float32 or flat)
                     else "legs")
    fn = tso.stencil_gs_color_step
    for c in range(cs.n_colors):
        before = _routes(fn)
        box = (tso._stencil_gs_color_step_cuda(A, x, rhs, dinv, cs, c,
                                               route="box")
               if fits else None)
        legs = tso._stencil_gs_color_step_cuda(A, x, rhs, dinv, cs, c,
                                               route="legs")
        default = fn(A, x, rhs, dinv, cs, c)
        torch.cuda.synchronize()
        assert _routes(fn) == (before[0] + fits + (route == "box"),
                               before[1] + 1 + (route == "legs"))
        assert torch.equal(default, legs)
        if box is not None:
            assert torch.equal(box, legs), c
        p = tso.stencil_gs_color_step_plain(A, x, rhs, dinv, cs, c)
        assert float((legs - p).abs().max()) <= rtol * float(p.abs().max())
    if not fits:
        with pytest.raises(RuntimeError, match="box route"):
            tso._stencil_gs_color_step_cuda(A, x, rhs, dinv, cs, 0,
                                            route="box")


@pytest.mark.cuda
@pytest.mark.parametrize("spec,mat_dt", [
    ("fdm:2048", torch.float32), ("fdm:2048", torch.float64),
    ("anderson:Lx=32,Ly=24,Lz=16,t=1.0,ranpot=4.0,seed=1", torch.float32),
    ("anderson:Lx=32,Ly=24,Lz=16,t=1.0,ranpot=4.0,seed=1", torch.bfloat16)])
def test_gs_halo_routes_equal_single_device(card, spec, mat_dt):
    """#3's shard form on an 8-shard mesh: every shard on the box route
    (gs_halo_route_for's) and on the leg loop bit-equal, the shards
    together bit-equal to the single-device step, every colour; each
    shard launch counted on its route; shards of 5 lines of an Anderson
    grid (not starting on a plane) too."""
    from basic_iterative_solvers_tpu_torch.coloring import spec_for_device
    from basic_iterative_solvers_tpu_torch.parallel import mesh_ops
    dt = torch.float64 if mat_dt == torch.float64 else torch.float32
    A, W, x = _mesh_operands(card, "gs_step", spec, dt, mat_dt)
    cs = spec_for_device(A)
    rhs = torch.randn_like(x)
    dinv = 1.0 / tso.stencil_diag(A).to(dt)
    n, hneg, hpos = A.n_rows, *A.window_halo
    fn = tso.stencil_gs_color_step_halo
    for R in (W.rows, 5 * A.dims[0]):
        n_dev = -(-n // R)
        pad = lambda v: torch.nn.functional.pad(v, (0, n_dev * R - n))  # noqa: E731
        xw = torch.nn.functional.pad(pad(x), (hneg, hpos))
        rs, ds = pad(rhs).split(R), pad(dinv).split(R)
        dg = None if A.diag is None else pad(A.diag).split(R)
        for c in range(cs.n_colors):
            single = tso.stencil_gs_color_step(A, x, rhs, dinv, cs, c)
            outs = {"box": [], "legs": []}
            for k in range(n_dev):
                win = xw[k * R:k * R + hneg + R + hpos].contiguous()
                d = None if dg is None else dg[k].contiguous()
                r, dv = rs[k].contiguous(), ds[k].contiguous()
                assert tso.gs_halo_route_for(A, win, r, dv, cs, d) == "box"
                for route in ("box", "legs"):
                    before = _routes(fn)
                    outs[route].append(tso._stencil_gs_color_step_halo_cuda(
                        A, win, k * R, R, r, dv, cs, c, d, None,
                        route=route))
                    assert _routes(fn) == (before[0] + (route == "box"),
                                           before[1] + (route == "legs"))
            torch.cuda.synchronize()
            box, legs = torch.cat(outs["box"]), torch.cat(outs["legs"])
            assert torch.equal(box, legs), (R, c)
            assert torch.equal(box[:n], single), (R, c)
            assert not bool(box[n:].any())
        before = _routes(fn)
        y8 = _whole(W, mesh_ops.mesh_gs_color_step(
            W, _rows(W, x), _rows(W, rhs), _rows(W, dinv), cs, 0))
        assert _routes(fn) == (before[0] + W.n_devices, before[1])
        assert torch.equal(y8, tso.stencil_gs_color_step(A, x, rhs, dinv, cs,
                                                         0))


def _split_pair(card, spec, mode, dt, monkeypatch):
    """(L, U) on the split route: the factor-table ILU(0) pair of a stencil
    (split by hand), or the ILU(0) pair from host CSR built with
    BIS_SB_ALIGNED=0 (both triangles in plane mode)."""
    from basic_iterative_solvers_tpu_torch.ops import block_trisolve as bk
    if mode == "table":
        _A, pair = _table_pair(card, spec, dt)
        return tuple(dataclasses.replace(B, fused=False, _args={})
                     for B in pair)
    monkeypatch.setattr(bk, "NO_ALIGNED", True)
    pair = _mesh_pair(card, spec, "plane", dt)
    assert all(B.is_plane and not B.fused for B in pair)
    return pair


def _split_counts(bk):
    return {(c.__name__, rt): getattr(c, f"{rt}_launches")
            for c in (bk.super_acc, bk.super_parity)
            for rt in ("staged", "line", "direct")}


def _split_plain(bk, B, y, x):
    """A whole split solve of B through the plain acc and parity steps."""
    acc = torch.empty(B.m, dtype=x.dtype, device=x.device)
    for li, (_sb, cross, _s) in enumerate(B.levels):
        if cross:
            bk.super_acc_plain(B, li, y, x, acc)
        for p in bk._parity_order(B):
            bk.super_parity_plain(B, li, p, y, acc if cross else None, x)
    return x


SPLIT_PAIRS = [("hpcg:12x8x6", "table"), ("hpcg:72x20x16", "table"),
               ("fdm:24", "plane"), ("hpcg:12x8x6", "plane")]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("spec,mode", SPLIT_PAIRS)
def test_split_routes_equal_direct_and_plain(card, spec, mode, dt,
                                             monkeypatch):
    """#10 and #11 on their mode's new route (staged: factor table;
    line: plane) and on the direct route, forced through the route
    cache, float32 and float64: every level and
    parity of L and U bit-equal to each other and to the plain steps,
    each launch counted in its route's counter."""
    from basic_iterative_solvers_tpu_torch.ops import block_trisolve as bk
    new = "staged" if mode == "table" else "line"
    g = torch.Generator(device="cuda").manual_seed(29)
    for B in _split_pair(card, spec, mode, dt, monkeypatch):
        n = B.n_rows
        for li, (_sb, cross, _s) in enumerate(B.levels):
            y = torch.randn(n, dtype=dt, device=card, generator=g)
            x = torch.randn(n, dtype=dt, device=card, generator=g)
            acc = None
            if cross:
                acc = bk.super_acc_plain(B, li, y, x, torch.empty(
                    B.m, dtype=dt, device=card))
                for route in (new, "direct"):
                    before = _split_counts(bk)
                    got = _launch_split(bk, B, li, route, bk.super_acc, y, x,
                                        torch.full_like(acc, float("nan")))
                    after = _split_counts(bk)
                    assert after[("super_acc", route)] == \
                        before[("super_acc", route)] + 1
                    torch.cuda.synchronize()
                    assert torch.equal(got, acc), (B.upper, li, route)
            for p in bk._parity_order(B):
                ref = bk.super_parity_plain(B, li, p, y, acc, x.clone())
                for route in (new, "direct"):
                    before = _split_counts(bk)
                    got = _launch_split(bk, B, li, route, bk.super_parity, p,
                                        y, acc, x.clone())
                    assert _split_counts(bk)[("super_parity", route)] == \
                        before[("super_parity", route)] + 1
                    torch.cuda.synchronize()
                    assert torch.equal(got, ref), (B.upper, li, p, route)
                x = ref


def _launch_split(bk, B, li, route, fn, *args):
    """fn(B, li, *args) with level li's route forced through the route
    cache for both vector types (a float64 parity step reads the float32
    level's), the cached routes restored after."""
    keys = [("route", li, item, args[-1].device.index) for item in (4, 8)]
    saved = {k: B._args.get(k) for k in keys}
    B._args.update(dict.fromkeys(keys, route))
    try:
        return fn(B, li, *args)
    finally:
        for k, v in saved.items():
            if v is None:
                del B._args[k]
            else:
                B._args[k] = v


@pytest.mark.cuda
@pytest.mark.parametrize("spec,mode,route", [
    ("hpcg:128x128x128", "table", "staged"), ("fdm:520", "plane", "line")])
def test_split_apply_takes_the_picked_route(card, spec, mode, route,
                                            monkeypatch):
    """A whole split ILU(0) apply, float32, on shapes that fill the card:
    every acc and parity launch on the route the picker names for the
    fused level, counted there, none on the others; the result bit-equal
    to the plain split apply (and, for the factor table, to the fused
    apply)."""
    from basic_iterative_solvers_tpu_torch.ops import block_trisolve as bk
    dt = torch.float32
    L, U = _split_pair(card, spec, mode, dt, monkeypatch)
    for B in (L, U):
        for li in range(len(B.levels)):
            assert bk.level_route_for(B, li, 4, device=card) == route
    y = torch.randn(L.n_rows, dtype=dt, device=card)
    before = _split_counts(bk)
    z = bk.blocked_ilu0(L, U, y)
    after = _split_counts(bk)
    n_acc = sum(1 for B in (L, U) for lv in B.levels if lv[1])
    grew = {k: after[k] - before[k] for k in after}
    assert grew == {**{k: 0 for k in grew},
                    ("super_acc", route): n_acc,
                    ("super_parity", route): 2 * L.S * L.sx}
    xl = _split_plain(bk, L, y, torch.empty_like(y))
    assert torch.equal(z, _split_plain(bk, U, xl, xl))
    if mode == "table":
        _A, fused = _table_pair(card, spec, dt)
        assert torch.equal(z, bk.blocked_ilu0(*fused, y))


MEGA_PAIRS = [("hpcg:128x128x128", "const"),
              ("anderson:Lx=32,Ly=32,Lz=32,t=1.0,ranpot=4.0,seed=1",
               "host")]


def _mega_counts(bk):
    m = bk.super_solve_mega
    return m.launches, m.brick_launches, m.direct_launches


def _mega_on(bk, B, route, y, x):
    """super_solve_mega of B with `route` forced through the route cache,
    the cached route restored after."""
    key = ("mega_route", x.element_size(), x.device.index)
    bk.mega_route_for(B, x.element_size(), x.device)
    saved = B._args[key]
    B._args[key] = route
    try:
        return bk.super_solve_mega(B, y, x)
    finally:
        B._args[key] = saved


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("spec,kind", MEGA_PAIRS)
def test_mega_brick_route_equals_direct_per_level_and_plain(card, spec, kind,
                                                            dt):
    """#12's brick route (the picker's on these pairs) on L and U, apart
    and in place: bit-equal to the direct route, the per-level route and
    the plain loop; each launch counted once in `.launches` and once in
    its route's count."""
    from basic_iterative_solvers_tpu_torch.ops import block_trisolve as bk
    L, U = _mesh_pair(card, spec, "const" if kind == "const" else "sgs", dt)
    assert L.is_const and (L.dinv_rows is not None) == (kind == "host")
    g = np.random.default_rng(31)
    for B in (L, U):
        y = torch.from_numpy(g.standard_normal(B.n_rows)).to(card, dt)
        assert bk.mega_route_for(B, y.element_size(), card) == "brick"
        ref = bk.super_solve_mega_plain(B, y, torch.empty_like(y))
        lvl = torch.empty_like(y)
        for li in range(len(B.levels)):
            bk.super_level(B, li, y, lvl)
        outs = {}
        for route, grew in (("brick", (1, 1, 0)), ("direct", (1, 0, 1))):
            before = _mega_counts(bk)
            outs[route] = _mega_on(bk, B, route, y, torch.empty_like(y))
            inplace = y.clone()
            _mega_on(bk, B, route, inplace, inplace)
            torch.cuda.synchronize()
            assert tuple(a - b for a, b in zip(_mega_counts(bk), before)) \
                == tuple(2 * v for v in grew)
            assert torch.equal(inplace, outs[route]), (route, B.upper)
        assert torch.equal(outs["brick"], ref), B.upper
        assert torch.equal(outs["brick"], outs["direct"])
        assert torch.equal(outs["brick"], lvl)


@pytest.mark.cuda
def test_mega_switch_counts_the_brick_route(card, monkeypatch):
    """blocked_sgs at 128^3 with MEGA on: two one-launch solves, both on
    the brick route, no level launch; bit-equal to MEGA off.  384^3 and
    fdm:2048 in float64 do not fit the card's shared memory: direct."""
    from basic_iterative_solvers_tpu_torch.coloring import spec_for_device
    from basic_iterative_solvers_tpu_torch.ops import block_trisolve as bk
    L, U = _mesh_pair(card, "hpcg:128x128x128", "const", torch.float32)
    y = torch.randn(L.n_rows, device=card)
    off = bk.blocked_sgs(L, U, y)
    monkeypatch.setattr(bk, "MEGA", True)
    before, levels = _mega_counts(bk), bk.super_level.launches
    on = bk.blocked_sgs(L, U, y)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_mega_counts(bk), before)) == (2, 2, 0)
    assert bk.super_level.launches == levels
    assert torch.equal(on, off)
    A = tso.from_source_operator("hpcg:384x384x384", torch.float32,
                                 device=card)
    L384, _U = bk.build_superblock_gs_pair_stencil(A, spec_for_device(A),
                                                   dtype=torch.float32)
    assert bk.mega_route_for(L384, 4, card) == "direct"
    assert bk.mega_grid(L384, card) > 0


@pytest.mark.cuda
def test_mega_brick_launch_the_card_refuses_raises(card):
    """A brick shape whose bricks do not fit on the card at once is
    refused by the launch: it raises, counts nothing and falls back to
    nothing."""
    from basic_iterative_solvers_tpu_torch.ops import block_trisolve as bk
    L, _U = _mesh_pair(card, "hpcg:128x128x128", "const", torch.float32)
    idx = torch.cuda.current_device()
    assert bk.mega_route_for(L, 4, card) == "brick"
    shape = L._args[("brick_shape", 4, idx)]
    assert bk.mega_grid(L, card) == bk.brick_count(L, shape) == 128
    L._args[("brick_shape", 4, idx)] = (2, 2, 32, 1)    # 4,096 bricks
    y = torch.randn(L.n_rows, device=card)
    x = torch.full_like(y, 7.0)
    before = _mega_counts(bk)
    try:
        with pytest.raises(RuntimeError, match="super_solve_brick"):
            bk.super_solve_mega(L, y, x)
    finally:
        L._args[("brick_shape", 4, idx)] = shape
    torch.cuda.synchronize()
    assert _mega_counts(bk) == before
    assert bool((x == 7.0).all())


HALO_BOX = [("hpcg:16x12x10", torch.float32, torch.float32),
            ("hpcg:16x12x10", torch.float64, torch.float64),
            ("fdm:72", torch.float32, torch.float32),
            ("anderson:Lx=32,Ly=24,Lz=16,t=1.0,ranpot=4.0,seed=1",
             torch.float32, torch.bfloat16),
            ("anderson:Lx=32,Ly=24,Lz=16,t=1.0,ranpot=4.0,seed=1",
             torch.float64, torch.float64)]


@pytest.mark.cuda
@pytest.mark.parametrize("spec,dt,mat_dt", HALO_BOX)
def test_halo_box_route_equals_legs_and_single_device(card, spec, dt,
                                                      mat_dt):
    """#1's shard form on the mesh's line-aligned windows: every shard on
    the box route (halo_route_for's) and on the leg loop bit-equal in y,
    the shards together bit-equal to the single-device #1, every dot kind
    within TOL of the plain version's, each launch counted on its route;
    8 shards as the mesh cuts them and shards of 5 lines (not on a plane),
    and one window over the whole grid (the GSPMD mode at world size 1).
    The mesh SpMV then takes the box route in every launch."""
    from basic_iterative_solvers_tpu_torch.parallel import mesh_ops
    A, W, x = _mesh_operands(card, "stencil", spec, dt, mat_dt)
    aux = torch.randn_like(x)
    n, (hneg, hpos) = A.n_rows, A.window_halo
    tol = 1e-5 if dt == torch.float32 else 1e-12
    fn = tso.stencil_spmv_halo
    dots = ("x", "self", "aux")
    single = tso._stencil_spmv_cuda(A, x, dots, aux)
    for R in (W.rows, 5 * A.dims[0], n):
        n_dev = -(-n // R)
        pad = lambda v: torch.nn.functional.pad(v, (0, n_dev * R - n))  # noqa: E731
        xw = torch.nn.functional.pad(pad(x), (hneg, hpos))
        auxs = pad(aux).split(R)
        dg = None if A.diag is None else pad(A.diag).split(R)
        ys = {"box": [], "legs": []}
        for k in range(n_dev):
            win = xw[k * R:k * R + hneg + R + hpos].contiguous()
            d = None if dg is None else dg[k].contiguous()
            a = auxs[k].contiguous()
            assert tso.halo_route_for(A, win, a, d) == "box"
            plain = tso.stencil_spmv_halo_plain(A, win, k * R, dots, a, d)
            for route in ("box", "legs"):
                before = _routes(fn)
                out = tso._stencil_spmv_halo_cuda(
                    A, win, k * R, R, dots, a, d, None, route=route)
                assert _routes(fn) == (before[0] + (route == "box"),
                                       before[1] + (route == "legs"))
                ys[route].append(out[0])
                for j, kind in enumerate(dots):
                    partner = {"x": win[hneg:hneg + R], "self": plain[0],
                               "aux": a}[kind]
                    scale = float((plain[0] * partner).abs().sum()) or 1.0
                    assert abs(float(out[1 + j] - plain[1 + j])) \
                        <= tol * scale, (R, k, route, kind)
        torch.cuda.synchronize()
        box, legs = torch.cat(ys["box"]), torch.cat(ys["legs"])
        assert torch.equal(box, legs), R
        assert torch.equal(box[:n], single[0]), R
        assert not bool(box[n:].any())
    before = _routes(fn)
    y8 = mesh_ops.mesh_stencil_spmv(W, _rows(W, x), ("x",))
    assert _routes(fn) == (before[0] + W.n_devices, before[1])
    assert torch.equal(_whole(W, y8[0]), single[0])


@pytest.mark.cuda
def test_halo_box_launch_refuses_a_misaligned_window(card):
    """A box launch on a window that starts off 16 bytes raises (the
    launcher refuses it) and counts nothing: nothing falls back to the
    leg loop."""
    A = tso.from_source_operator("hpcg:16x12x10", torch.float32, device=card)
    hneg, hpos = A.window_halo
    R = 16 * 12 * 2
    xw = torch.zeros(hneg + R + hpos + 1, device=card)[1:]
    before = _routes(tso.stencil_spmv_halo)
    with pytest.raises(RuntimeError, match="box route"):
        tso._stencil_spmv_halo_cuda(A, xw, 0, R, (), None, None, None,
                                    route="box")
    assert _routes(tso.stencil_spmv_halo) == before


@pytest.mark.cuda
def test_mesh_and_gspmd_cg_take_the_box_route(card):
    """CG on HPCG 32^3 (f32 and f64) on an 8-shard mesh and in the GSPMD
    mode at world size 1 (NCCL) keeps one device's iteration count and
    history, every #1 shard launch on the box route; #3's shard form
    takes its box route on the 27-point mesh's windows in f32."""
    import torch.distributed as dist
    from basic_iterative_solvers_tpu_torch.coloring import spec_for_device
    from basic_iterative_solvers_tpu_torch.parallel import (
        make_device_mesh, make_mesh, mesh_ops, shard_setup)
    from basic_iterative_solvers_tpu_torch.ops.blas1 import full_value
    fn = tso.stencil_spmv_halo
    torch.cuda.set_device(card.index or 0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        dmesh = make_device_mesh()
        for dt, tol in ((torch.float32, 1e-5), (torch.float64, 1e-10)):
            A = tso.from_source_operator("hpcg:32x32x32", dt, device=card)
            cfg = bt.SolverConfig(dtype=dt, harness="fused", tolerance=tol,
                                  max_iters=500)
            r1 = bt.solve(bt.preprocessing_device(A, cfg))
            for mesh, mode in ((make_mesh(8, device=card), "shard_map"),
                               (dmesh, "gspmd")):
                before = _routes(fn)
                r = bt.solve(shard_setup(bt.preprocessing_device(A, cfg),
                                         mesh, mode=mode))
                box, legs = (a - b for a, b in zip(_routes(fn), before))
                assert r.converged and r.iter_count == r1.iter_count, mode
                assert box >= r.iter_count and legs == 0, mode
                np.testing.assert_allclose(r.residual_norms[:-1],
                                           r1.residual_norms[:-1],
                                           rtol=1e-3 if dt == torch.float32
                                           else 1e-8)
                assert bool(torch.isfinite(full_value(r.x_star)).all())
        A = tso.from_source_operator("hpcg:32x32x32", torch.float32,
                                     device=card)
        W = mesh_ops.wrap_stencil(dataclasses.replace(A, shards=8),
                                  make_mesh(8, device=card), "rows")
        x = torch.randn(A.n_rows, device=card)
        cs = spec_for_device(A)
        dinv = 1.0 / tso.stencil_diag(A)
        before = _routes(tso.stencil_gs_color_step_halo)
        y8 = mesh_ops.mesh_gs_color_step(W, _rows(W, x), _rows(W, x),
                                         _rows(W, dinv), cs, 0)
        assert _routes(tso.stencil_gs_color_step_halo) == (before[0] + 8,
                                                           before[1])
        assert torch.equal(_whole(W, y8), tso.stencil_gs_color_step(
            A, x, x, dinv, cs, 0))
    finally:
        dist.destroy_process_group()
