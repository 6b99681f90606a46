"""Matrix data stored in bfloat16 (matrix_dtype="bfloat16") in the port
against the JAX package: the three cases of tests/test_mixed_precision.py
(DIA CG + Jacobi and BiCGSTAB + s2st on the device path, BiCGSTAB + 2st on
the host path), the plain versions of kernels #4 (DIA), #5 (lane-ELL) and
the stencil SpMV with a bf16 diagonal on the same bf16 data, the stored
dtypes, and HPCG, whose values are exact in bf16, bit for bit against
float32 storage.

Tolerances: with float32 vectors the two packages' histories differ by
their reduction orders alone, ~1e-4 relative after a few CG iterations
and more in BiCGSTAB (which amplifies it), with or without bf16 storage;
so each case runs twice, with float32 vectors (equal counts and stored
dtypes; CG's history at the repo's float32 parity rtol 1e-4) and with
float64 vectors over the same bf16 data, where the histories must agree
to rtol 1e-8.  The SpMVs agree to rtol 1e-6 in float32 (XLA and torch may
round the sums alike or not) and bit for bit where both sides are the
port's own.
"""
import numpy as np
import pytest
import torch

import ml_dtypes

import basic_iterative_solvers_tpu as bis
from basic_iterative_solvers_tpu import dia as jdia
from basic_iterative_solvers_tpu import stencil_op as jso
from basic_iterative_solvers_tpu.ops import lane_ell as jle
from basic_iterative_solvers_tpu.ops.spmv import spmv_dia as jspmv_dia

import basic_iterative_solvers_tpu_torch as bt
from basic_iterative_solvers_tpu_torch import convert
from basic_iterative_solvers_tpu_torch import generators as tgen
from basic_iterative_solvers_tpu_torch.ops import dia_spmv as tds
from basic_iterative_solvers_tpu_torch.ops import lane_ell as tle

CPU = "cpu"
JBF16 = np.dtype(ml_dtypes.bfloat16)
VEC = {"f32": (np.float32, torch.float32), "f64": (np.float64, torch.float64)}
ANDERSON = "anderson:Lx=6,Ly=5,Lz=4,t=1.0,ranpot=4.0,seed=1"


def _histories(rj, rt, vec):
    """Equal counts; histories (the explicit final entry left out: it sits
    at the rounding floor of b − A·x) at rtol 1e-8 with float64 vectors,
    1e-4 with float32 ones."""
    assert rt.iter_count == rj.iter_count and rt.converged == rj.converged
    hj = np.asarray(rj.residual_norms, dtype=np.float64)
    assert len(rt.residual_norms) == len(hj)
    np.testing.assert_allclose(rt.residual_norms[:-1], hj[:-1],
                               rtol=1e-8 if vec == "f64" else 1e-4)


@pytest.mark.parametrize("vec", ["f32", "f64"])
@pytest.mark.parametrize("method,precond", [
    ("CONJUGATE_GRADIENT", "JACOBI"),
    ("BICGSTAB", "SYMMETRIC_TWO_STAGE_GS")], ids=["cg_j", "bi_s2st"])
def test_bf16_device_path(method, precond, vec):
    """dia.stencil_27pt_device(6, 6, 6) solved with its data in bf16
    (tests/test_mixed_precision.py::test_bf16_matrix_device_path): the
    data stored bf16, b and every diagonal of M in the vector dtype, as
    the JAX package stores them; the same counts and histories."""
    np_dt, t_dt = VEC[vec]
    kw = dict(matrix_dtype="bfloat16", precond_inner_iters=1,
              tolerance=1e-4, harness="fused")
    sj = bis.preprocessing_device(
        jdia.stencil_27pt_device(6, 6, 6, dtype=np.float32),
        bis.SolverConfig(method=bis.SolverType[method],
                         preconditioner=bis.PrecondType[precond],
                         dtype=np_dt, **kw))
    st = bt.preprocessing_device(
        bt.dia.stencil_27pt_device(6, 6, 6, dtype=torch.float32, device=CPU),
        bt.SolverConfig(method=bt.SolverType[method],
                        preconditioner=bt.PrecondType[precond],
                        dtype=t_dt, **kw))
    assert sj.A.data.dtype == JBF16 and st.A.data.dtype == torch.bfloat16
    assert st.b.dtype == st.x0.dtype == t_dt
    for name in ("A_D", "A_D_inv"):
        assert getattr(st.M, name).dtype == t_dt
        assert getattr(sj.M, name).dtype == np_dt
    if precond == "SYMMETRIC_TWO_STAGE_GS":
        assert sj.M.L_strict_dev.data.dtype == JBF16
        assert st.M.L_strict_dev.data.dtype == torch.bfloat16
    rj, rt = bis.solve(sj), bt.solve(st)
    assert rt.converged
    if method == "CONJUGATE_GRADIENT" or vec == "f64":
        _histories(rj, rt, vec)
    else:
        assert rt.iter_count == rj.iter_count


@pytest.mark.parametrize("vec", ["f32", "f64"])
def test_bf16_host_path(vec):
    """BiCGSTAB + 2st on fdm_2d(12) through the host CSR
    (test_bf16_matrix_host_path): setup.A and the preconditioner's strict
    part stored bf16, as the JAX package stores them; the same count, and
    with float64 vectors the same history."""
    np_dt, t_dt = VEC[vec]
    kw = dict(precond_inner_iters=1, matrix_dtype="bfloat16",
              tolerance=1e-4, harness="fused")
    sj = bis.preprocessing(bis.generators.fdm_2d(12), bis.SolverConfig(
        method=bis.SolverType.BICGSTAB,
        preconditioner=bis.PrecondType.TWO_STAGE_GS, dtype=np_dt, **kw))
    st = bt.preprocessing(tgen.fdm_2d(12), bt.SolverConfig(
        method=bt.SolverType.BICGSTAB,
        preconditioner=bt.PrecondType.TWO_STAGE_GS, dtype=t_dt, **kw),
        device=CPU)
    assert sj.A.data.dtype == JBF16 and st.A.data.dtype == torch.bfloat16
    assert sj.M.L_strict_dev.data.dtype == JBF16
    assert st.M.L_strict_dev.data.dtype == torch.bfloat16
    assert st.b.dtype == t_dt and st.M.A_D_inv.dtype == t_dt
    rj, rt = bis.solve(sj), bt.solve(st)
    assert rt.converged
    if vec == "f64":
        _histories(rj, rt, vec)
    else:
        assert rt.iter_count == rj.iter_count


def test_hpcg_bf16_equals_f32_bit_for_bit():
    """HPCG's values (26, −1, 0) are exact in bf16: DIA CG with bf16
    storage gives float32 storage's history and x bit for bit."""
    runs = []
    for md in (None, "bfloat16"):
        res = bt.solve_system("hpcg:12x10x8", "cg", dtype=torch.float32,
                              harness="fused", tolerance=0, max_iters=40,
                              matrix_dtype=md, device=CPU)
        runs.append(res)
    f32, bf16 = runs
    assert bf16.iter_count == f32.iter_count == 40
    np.testing.assert_array_equal(bf16.residual_norms, f32.residual_norms)
    assert torch.equal(bf16.x_star, f32.x_star)


def _rand(n, rng):
    return rng.standard_normal(n).astype(np.float32)


@pytest.mark.parametrize("spec", ["hpcg:8x6x4", ANDERSON, "band:700,2"])
def test_dia_plain_bf16_matches_jax(spec, rng):
    """Kernel #4's plain version on bf16 data against the JAX package's
    spmv on the same bf16 data (carried across bit for bit), float32
    vectors, rtol 1e-6; on HPCG, whose values are exact in bf16, equal to
    the float32-data product bit for bit."""
    Aj = jdia.from_source_device(spec, dtype=JBF16)
    At = convert.dia_from_numpy(np.asarray(Aj.data), Aj.offsets, Aj.n_rows,
                                Aj.n_cols, dtype=torch.bfloat16, device=CPU)
    k, n = len(Aj.offsets), Aj.n_rows
    np.testing.assert_array_equal(
        At.data.float().numpy(),
        np.asarray(Aj.data)[:k, :n].astype(np.float32))
    x = _rand(n, rng)
    yj = np.asarray(jspmv_dia(Aj, x))
    yt = tds.dia_spmv(At, torch.from_numpy(x))
    assert yt.dtype == torch.float32 and tds.dia_spmv.bf16_launches == 0
    np.testing.assert_allclose(yt.numpy(), yj, rtol=1e-6,
                               atol=1e-6 * np.abs(yj).max())
    if spec.startswith("hpcg"):
        A32 = bt.dia.from_source_device(spec, torch.float32, device=CPU)
        assert torch.equal(yt, tds.dia_spmv_plain(A32, torch.from_numpy(x)))


def test_lane_ell_plain_bf16_matches_jax(rng):
    """Kernel #5's plain version on bf16 values: the port's planes equal
    the JAX package's (values rounded alike, the pad rule read after the
    rounding) and the product agrees with its XLA form, rtol 1e-6."""
    spec = "sband:1500,6,260"
    Mj = jle.csr_to_lane_ell(bis.generators.from_source(spec), dtype=JBF16)
    Mt = tle.csr_to_lane_ell(tgen.from_source(spec), torch.bfloat16,
                             device=CPU)
    assert Mt.vals.dtype == torch.bfloat16 and (Mt.K, Mt.S, Mt.R) == (
        Mj.K, Mj.S, Mj.R)
    np.testing.assert_array_equal(Mt.vals.float().numpy(),
                                  np.asarray(Mj.vals).astype(np.float32))
    np.testing.assert_array_equal(Mt.idx.numpy(), np.asarray(Mj.idx))
    x = _rand(Mt.n_rows, rng)
    yj = np.asarray(jle.lane_ell_spmv_xla(Mj, x))
    yt = tle.lane_ell_spmv(Mt, torch.from_numpy(x))
    assert yt.dtype == torch.float32
    np.testing.assert_allclose(yt.numpy(), yj, rtol=1e-6,
                               atol=1e-6 * np.abs(yj).max())


@pytest.mark.parametrize("vec", ["f32", "f64"])
def test_stencil_bf16_diagonal_matches_jax(vec, rng):
    """The stencil SpMV's plain version with Anderson's diagonal in bf16
    (the coefficients −t exact) against the JAX package's XLA stencil
    SpMV on the same operator: the diagonals equal bit for bit, y within
    rtol 1e-6 (f32) or 1e-15 (f64)."""
    np_dt, t_dt = VEC[vec]
    Aj = jso.from_source_operator(ANDERSON, dtype=JBF16)
    At = bt.stencil_op.from_source_operator(ANDERSON, torch.bfloat16,
                                            device=CPU)
    assert At.dtype == At.diag.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        At.diag.double().numpy(),
        np.asarray(Aj.diag)[:At.n_rows].astype(np.float64))
    x = rng.standard_normal(At.n_rows).astype(np_dt)
    yj = np.asarray(jso.stencil_spmv_xla(Aj, x))
    yt = bt.stencil_op.stencil_spmv(At, torch.from_numpy(x))
    assert yt.dtype == t_dt
    rtol = 1e-6 if vec == "f32" else 1e-15
    np.testing.assert_allclose(yt.numpy(), yj, rtol=rtol,
                               atol=rtol * np.abs(yj).max())


def test_anderson_stencil_solve_bf16_matches_jax():
    """GMRES(20) + Jacobi on the Anderson stencil with its diagonal in bf16,
    float64 vectors, fused, 200 iterations: the JAX package's counts and
    history (rtol 1e-8; Anderson's random diagonal is not exact in bf16,
    so it is held against the JAX package run in bf16, not against
    float32; the operator is indefinite, and CG and BiCGSTAB there amplify
    reduction-order differences past any tolerance, in float64 storage
    too)."""
    spec = "anderson:Lx=6,Ly=6,Lz=6,t=1.0,ranpot=4.0,seed=1"
    kw = dict(matrix_dtype="bfloat16", tolerance=1e-8, harness="fused",
              matrix_format="stencil", restart_length=20, max_iters=200)
    rj = bis.solve_system(spec, "gm", "j", dtype=np.float64, **kw)
    rt = bt.solve_system(spec, "gm", "j", dtype=torch.float64, device=CPU,
                         **kw)
    assert rt.gmres_restart_count == rj.gmres_restart_count > 0
    _histories(rj, rt, "f64")


@pytest.mark.parametrize("kind", ["dia", "stencil"])
def test_bf16_rejected_beside_other_vectors(kind):
    """bf16 data serves float32 and float64 vectors; a float64 operator
    still refuses float32 vectors, and the CUDA form refuses bf16
    vectors (no kernel takes them)."""
    from basic_iterative_solvers_tpu_torch.config import kernel_suffix
    from basic_iterative_solvers_tpu_torch.ops.spmv import spmv
    src = "hpcg:6x5x4"
    A64 = (bt.dia.from_source_device(src, torch.float64, device=CPU)
           if kind == "dia" else bt.stencil_op.from_source_operator(
               src, torch.float64, device=CPU))
    with pytest.raises(TypeError):
        spmv(A64, torch.ones(A64.n_rows, dtype=torch.float32))
    assert kernel_suffix(torch.float32, torch.bfloat16) == "f32_bf16"
    assert kernel_suffix(torch.float64, torch.float64) == "f64"
    with pytest.raises(TypeError):
        kernel_suffix(torch.bfloat16, torch.bfloat16)
