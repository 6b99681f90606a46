"""Checks of the port's CUDA kernels that need a card.

They skip where there is none (here, the CPU tests' machines).  On a
machine with a card and no JAX, run them without the JAX-loading
conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

This file imports torch and numpy only.
"""
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
