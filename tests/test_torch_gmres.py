"""The port's GMRES(m) against the JAX package's: the mgs, cgs2 and lowsync
orthogonalizations in float64, fused mode with its scaled-raw basis (the
plain versions of the basis kernels run here), the gated steps of the
fused harness, and the debug-check hook of the host harness.

Parity cases build the same generator spec in both packages and hand both
b = 2 and x0 = 1 (the bench's).
"""
import warnings

import numpy as np
import pytest
import torch

import basic_iterative_solvers_tpu as bis
from basic_iterative_solvers_tpu.ops import pallas_env

import basic_iterative_solvers_tpu_torch as bt
from basic_iterative_solvers_tpu_torch.ops import gmres_basis
from basic_iterative_solvers_tpu_torch.solvers import make_method
from basic_iterative_solvers_tpu_torch.solvers.gmres import GMRESMethod

#: the port's entry points run on the card unless asked; these tests
#: run on the CPU
CPU = "cpu"

HARNESSES = ["host", "fused"]
#: fused mode's convergence cases (tests/test_pallas_interpret.py's)
FUSED_KW = dict(method="gm", tolerance=1e-5, max_iters=300, restart_length=8)


def _solve_both(spec, harness, dtype=np.float64, **cfg):
    Aj = bis.stencil_op.from_source_operator(spec, dtype=dtype)
    n = Aj.n_rows
    bv, xv = np.full(n, 2.0, dtype), np.full(n, 1.0, dtype)
    rj = bis.solve(bis.preprocessing_device(Aj, bis.SolverConfig(
        method=bis.SolverType.GMRES, dtype=dtype, harness=harness, **cfg),
        b=bv, x0=xv))
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    At = bt.stencil_op.from_source_operator(spec, tdt, device=CPU)
    rt = bt.solve(bt.preprocessing_device(At, bt.SolverConfig(
        method=bt.SolverType.GMRES, dtype=tdt, harness=harness, **cfg),
        b=torch.from_numpy(bv), x0=torch.from_numpy(xv)))
    return rj, rt


def _check_histories(rj, rt, m):
    """Histories to rtol 1e-8 above 1e-7·‖r0‖ and within the first eight
    restart cycles.  Every restart recomputes x from the basis, and the
    cycles amplify rounding: on fdm:16 GMRES(10) the two packages' histories
    part after the eighth cycle, as the JAX package's own two harnesses do
    (tests/test_reference_parity.py pins the reference to the same prefix);
    below ~1e-7·‖r0‖ the norms are float64 rounding noise (measured: ≤ 3e-9
    above that floor, up to 4e-8 below it)."""
    hj, ht = rj.residual_norms[:-1], rt.residual_norms[:-1]
    keep = (hj >= 1e-7 * hj[0]) & (np.arange(len(hj)) < 8 * (m + 1))
    np.testing.assert_allclose(ht[keep], hj[keep], rtol=1e-8)


@pytest.mark.parametrize("harness", HARNESSES)
@pytest.mark.parametrize("rl", [10, 50])
@pytest.mark.parametrize("mode", ["mgs", "cgs2", "lowsync"])
@pytest.mark.parametrize("spec", ["hpcg:16x16x16", "fdm:16"])
def test_gmres_f64_parity(spec, mode, rl, harness):
    """The same iteration and restart counts, histories as
    `_check_histories` says, and the explicit final residual at rtol 1e-4
    (it sits at the rounding floor of b − A·x, which x* that differ in
    their last bits move by ~1e-5).  fdm:16
    GMRES(10) runs to tol 1e-8: at 1e-10 the restart where it stops is
    rounding noise (the JAX package's own harnesses take 159 and 160
    iterations), and its final residual is compared at rtol 0.1, the spread
    of the JAX package's own two harnesses there (5%)."""
    chaotic = spec == "fdm:16" and rl == 10
    rj, rt = _solve_both(spec, harness, orthog_mode=mode, restart_length=rl,
                         tolerance=1e-8 if chaotic else 1e-10)
    assert rt.converged and rj.converged
    assert rt.iter_count == rj.iter_count
    assert rt.gmres_restart_count == rj.gmres_restart_count
    assert (rt.gmres_restart_count > 0) == (rl == 10)
    assert len(rt.residual_norms) == len(rj.residual_norms)
    _check_histories(rj, rt, rl)
    np.testing.assert_allclose(rt.final_residual_norm, rj.final_residual_norm,
                               rtol=0.1 if chaotic else 1e-4)


def test_fused_mode_f64_warns_and_runs_lowsync():
    """A float64 solve has no fused kernels: the port warns, naming the
    reason, and runs lowsync, as the JAX package does; the two agree as the
    lowsync parity cases do."""
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        rj, rt = _solve_both("hpcg:16x16x16", "fused", orthog_mode="fused",
                             restart_length=10, tolerance=1e-10)
    msgs = [str(w.message) for w in rec]
    assert any("float32 solve dtype" in m and "falling back to 'lowsync'"
               in m for m in msgs)
    assert (rt.iter_count, rt.gmres_restart_count) == (65, 6)
    assert rt.iter_count == rj.iter_count
    _check_histories(rj, rt, 10)


@pytest.mark.parametrize("basis", ["float64", "float16"])
def test_fused_mode_refuses_other_basis_dtypes(basis):
    A = bt.stencil_op.from_source_operator("hpcg:8x8x8", torch.float32,
                                           device=CPU)
    setup = bt.preprocessing_device(A, bt.SolverConfig(
        method=bt.SolverType.GMRES, dtype=torch.float32,
        orthog_mode="fused", gmres_basis_dtype=basis))
    with pytest.warns(UserWarning, match="basis"):
        method = make_method(setup)
    assert method.orthog == "lowsync"


def test_fused_mode_matches_lowsync():
    """orthog_mode='fused' (scaled-raw basis, the basis kernels' plain
    versions) follows the lowsync trajectory across restarts: within 2
    iterations of the JAX package's lowsync and of the port's own, x* to
    atol 1e-4 (as test_gmres_fused_matches_lowsync holds the JAX
    package's); no kernel launches on CPU tensors."""
    gmres_basis.project_gram.launches = 0
    gmres_basis.correct_write.launches = 0
    rf = bt.solve_system("hpcg:16x16x16", orthog_mode="fused",
                         dtype=torch.float32, harness="fused", **FUSED_KW,
                         device=CPU)
    rl = bt.solve_system("hpcg:16x16x16", orthog_mode="lowsync",
                         dtype=torch.float32, harness="fused", **FUSED_KW,
                         device=CPU)
    rj = bis.solve_system("hpcg:16x16x16", orthog_mode="lowsync",
                          dtype=np.float32, harness="fused", **FUSED_KW)
    assert rf.converged and rl.converged and rj.converged
    assert rf.gmres_restart_count >= 1
    assert abs(rf.iter_count - rl.iter_count) <= 2
    assert abs(rf.iter_count - rj.iter_count) <= 2
    np.testing.assert_allclose(rf.x_star.numpy(), rl.x_star.numpy(),
                               rtol=0, atol=1e-4)
    assert gmres_basis.project_gram.launches == 0
    assert gmres_basis.correct_write.launches == 0


def test_fused_mode_matches_jax_fused_kernels():
    """Against the JAX package's own fused mode, its Pallas kernels run in
    interpret mode: within 1 iteration, the same restart count."""
    pallas_env.INTERPRET = True
    try:
        rj = bis.solve_system("hpcg:16x16x16", orthog_mode="fused",
                              dtype=np.float32, harness="fused", **FUSED_KW)
    finally:
        pallas_env.INTERPRET = False
    rt = bt.solve_system("hpcg:16x16x16", orthog_mode="fused",
                         dtype=torch.float32, harness="fused", **FUSED_KW,
                         device=CPU)
    assert rj.converged and rt.converged
    assert abs(rt.iter_count - rj.iter_count) <= 1
    assert rt.gmres_restart_count == rj.gmres_restart_count


def test_fused_mode_bf16_basis():
    """A bfloat16 basis converges within 3 iterations of a float32 one, and
    the per-iteration orthonormality and triangularity checks pass on the
    host harness (diag(s)·V is unit to storage precision)."""
    kw = dict(orthog_mode="fused", dtype=torch.float32, **FUSED_KW)
    r32 = bt.solve_system("hpcg:16x16x16", harness="fused", **kw, device=CPU)
    rbf = bt.solve_system("hpcg:16x16x16", harness="fused",
                          gmres_basis_dtype="bfloat16", **kw, device=CPU)
    rdbg = bt.solve_system("hpcg:16x16x16", harness="host",
                           gmres_basis_dtype="bfloat16", debug_checks=True,
                           **kw, device=CPU)
    assert r32.converged and rbf.converged and rdbg.converged
    assert abs(rbf.iter_count - r32.iter_count) <= 3
    assert rdbg.iter_count == rbf.iter_count


@pytest.mark.parametrize("mode,dtype,basis", [
    ("mgs", torch.float64, None), ("cgs2", torch.float64, None),
    ("lowsync", torch.float64, None), ("fused", torch.float32, "bfloat16")])
def test_gated_steps_change_nothing_explicit_x_reads(mode, dtype, basis):
    """Steps past the stop leave x, H, Q, g, G, s and the rows 0..n_it of V
    unchanged and the step counter where it was; rows beyond n_it stay
    finite, since explicit_x multiplies them by 0."""
    A = bt.stencil_op.from_source_operator("hpcg:8x8x8", dtype, device=CPU)
    method = make_method(bt.preprocessing_device(A, bt.SolverConfig(
        method=bt.SolverType.GMRES, dtype=dtype, orthog_mode=mode,
        gmres_basis_dtype=basis, restart_length=10)))
    state = method.init_state()
    for _ in range(4):
        state = method.iterate(state, torch.tensor(True))
    before = {k: v.clone() for k, v in state.items()
              if isinstance(v, torch.Tensor)}
    x_before = method.explicit_x(state, 4)
    for _ in range(3):
        state = method.iterate(state, torch.tensor(False))
    assert int(state["j"]) == 4 and state["jh"] == 7
    for key in ("x_old", "H", "Q", "g", "G", "s"):
        if key in before:
            assert torch.equal(state[key], before[key]), key
    assert torch.equal(state["V"][:5], before["V"][:5])
    assert bool(torch.isfinite(state["V"].to(torch.float32)).all())
    assert torch.equal(method.final_x(state), x_before)


@pytest.mark.parametrize("case", [
    dict(method="gm", restart_length=10, tolerance=1e-8, dtype=torch.float64),
    dict(method="gm", restart_length=10, tolerance=1e-8, dtype=torch.float64,
         orthog_mode="lowsync"),
    dict(method="bi", tolerance=1e-10, dtype=torch.float64),
    dict(method="gm", orthog_mode="fused", gmres_basis_dtype="bfloat16",
         dtype=torch.float32, **{k: v for k, v in FUSED_KW.items()
                                 if k != "method"}),
], ids=["gmres-mgs", "gmres-lowsync", "bicgstab", "gmres-fused-bf16"])
def test_fused_stop_matches_host(case):
    """Solves that stop inside a check chunk (and inside a restart cycle)
    give the same iteration and restart counts, history and x* under both
    harnesses: the gated steps after the stop change nothing.  (The fused
    harness keeps its history in the solve dtype, as the JAX package's
    does, so the appended float64 final residual is compared on its own.)"""
    spec = "hpcg:16x16x16" if case["dtype"] == torch.float32 else "fdm:16"
    rh, rf = (bt.solve_system(spec, harness=h, **case,
                              device=CPU) for h in HARNESSES)
    assert rh.converged and rf.converged
    assert rh.iter_count == rf.iter_count and rh.iter_count % 64
    assert rh.gmres_restart_count == rf.gmres_restart_count
    if case["method"] == "gm":
        assert rh.gmres_restart_count > 0
        assert rh.iter_count % case["restart_length"]
    np.testing.assert_array_equal(rh.residual_norms[:-1],
                                  rf.residual_norms[:-1])
    assert rh.final_residual_norm == rf.final_residual_norm
    assert torch.equal(rh.x_star, rf.x_star)


@pytest.mark.parametrize("debug_checks", [True, False])
def test_host_harness_calls_debug_check(monkeypatch, debug_checks):
    """With config.debug_checks the host harness calls the method's
    debug_check after every iteration (the JAX package's
    solvers/base.py:1006-1015): a check that raises makes solve raise."""
    calls = []

    def failing_check(self, state, iter_count):
        calls.append(iter_count)
        raise AssertionError("debug check fired")

    monkeypatch.setattr(GMRESMethod, "debug_check", failing_check)
    run = lambda: bt.solve_system("hpcg:8x8x8", "gm",  # noqa: E731
                                  debug_checks=debug_checks, tolerance=1e-8,
                                  device=CPU)
    if debug_checks:
        with pytest.raises(AssertionError, match="debug check fired"):
            run()
        assert calls == [1]
    else:
        assert run().converged and not calls


@pytest.mark.parametrize("mode", ["mgs", "cgs2", "lowsync"])
def test_debug_checks_pass(mode):
    """The real checks pass on a float64 solve with restarts."""
    res = bt.solve_system("fdm:16", "gm", restart_length=10, orthog_mode=mode,
                          debug_checks=True, tolerance=1e-8, device=CPU)
    assert res.converged and res.gmres_restart_count > 0


def test_debug_check_catches_lost_orthogonality():
    A = bt.stencil_op.from_source_operator("hpcg:8x8x8", torch.float64,
                                           device=CPU)
    method = make_method(bt.preprocessing_device(A, bt.SolverConfig(
        method=bt.SolverType.GMRES)))
    state = method.init_state()
    for _ in range(3):
        state = method.iterate(state)
    method.debug_check(state, 3)
    state["V"][1] = state["V"][0]
    with pytest.raises(AssertionError, match="orthonormality"):
        method.debug_check(state, 3)


@pytest.mark.parametrize("layout,spec,ok", [
    ("auto", "fdm:10", True), ("flat", "fdm:10", True),
    ("tiled", "hpcg:8x8x8", True), ("tiled", "fdm:10", False),
    ("rows", "fdm:10", False)])
def test_basis_layout_values(layout, spec, ok):
    """gmres_basis_layout takes the JAX package's values and checks them as
    it does; every value stores V flat."""
    A = bt.stencil_op.from_source_operator(spec, torch.float64, device=CPU)
    setup = bt.preprocessing_device(A, bt.SolverConfig(
        method=bt.SolverType.GMRES, gmres_basis_layout=layout))
    if ok:
        assert make_method(setup).init_state()["V"].dim() == 2
    else:
        with pytest.raises(ValueError):
            make_method(setup)
