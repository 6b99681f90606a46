"""The port's reports and observability against the JAX package's:
summary_output/print_residuals text, the host harness's kernel-timer table
(its rows for CG and GMRES), the L/U split audit, the roofline's traffic
estimate, and utils/profile.py: the bucket of every kernel the port
defines, trace parsing on synthetic torch.profiler traces, and None on the
CPU (the JAX xprof module's off-TPU behaviour).
"""
import io
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from basic_iterative_solvers_tpu import cli as jcli
from basic_iterative_solvers_tpu.solvers.base import SolveResult as JResult
from basic_iterative_solvers_tpu.types import (PrecondType as JP,
                                               SolverType as JS)
from basic_iterative_solvers_tpu.utils import report as jreport

import basic_iterative_solvers_tpu_torch as bt
from basic_iterative_solvers_tpu_torch import cli as tcli
from basic_iterative_solvers_tpu_torch.solvers import make_method
from basic_iterative_solvers_tpu_torch.solvers.base import SolveResult
from basic_iterative_solvers_tpu_torch.utils import profile, report, sanity

CPU = "cpu"
CSRC = Path(bt.__file__).parent / "csrc"


@pytest.mark.parametrize("case", [
    dict(method="CONJUGATE_GRADIENT", precond="NONE", converged=True),
    dict(method="GMRES", precond="JACOBI", converged=True, restarts=2,
         restart_length=20),
    dict(method="BICGSTAB", precond="ILU0", converged=False, uniform=True),
    dict(method="JACOBI", precond="NONE", converged=True, k=3)],
    ids=["cg", "gmres", "bicgstab_fused", "jacobi_k3"])
def test_summary_text_matches_jax(case, rng):
    """summary_output (with print_residuals) prints the JAX module's text
    for the same SolveResult fields."""
    norms = np.abs(rng.standard_normal(7)) * 10.0 ** -np.arange(7)
    times = np.abs(rng.standard_normal(7)) * 1e-3
    common = dict(iter_count=17, converged=case["converged"],
                  stopping_criteria=1.25e-9, residual_norms=norms,
                  time_per_iteration=times, final_residual_norm=3.5e-10,
                  gmres_restart_count=case.get("restarts", 0),
                  restart_length=case.get("restart_length", 0),
                  res_check_len=case.get("k", 1),
                  uniform_iteration_times=case.get("uniform", False))
    rt = SolveResult(x_star=torch.zeros(3),
                     method=bt.SolverType[case["method"]],
                     preconditioner=bt.PrecondType[case["precond"]], **common)
    rj = JResult(x_star=np.zeros(3), method=JS[case["method"]],
                 preconditioner=JP[case["precond"]], **common)
    out_t, out_j = io.StringIO(), io.StringIO()
    report.summary_output(rt, out=out_t)
    jreport.summary_output(rj, out=out_j)
    assert out_t.getvalue() == out_j.getvalue()


def _table_rows(text):
    return {m.group(1) for m in re.finditer(r"^\|[| ]*([a-z_]+) +[0-9.]+ s \|",
                                            text, re.M)}


@pytest.mark.parametrize("argv", [
    ["fdm:10", "-cg", "-p", "ilu0"], ["fdm:10", "-gm", "-rl", "15"]],
    ids=["cg_ilu0", "gmres"])
def test_host_kernel_timer_table_has_the_jax_rows(argv, capsys):
    """--kernel-timers --harness host: the table holds the JAX table's
    rows (spmv, precond, sptrsv, dot, norm, sum for CG + ILU(0); orthog,
    least_sq, update_g for GMRES).  The port's GMRES table also has a dot
    row: its MGS projections call ops.blas1.dot inside orthog, where the
    JAX package's run inside a traced loop that its timers skip."""
    tail = ["--platform", "cpu", "--dtype", "float64", "--kernel-timers",
            "--harness", "host", "--tol", "1e-8"]
    assert tcli.run(argv + tail) == 0
    rows_t = _table_rows(capsys.readouterr().err)
    assert jcli.run(argv + tail) == 0
    rows_j = _table_rows(capsys.readouterr().err)
    assert rows_j <= rows_t
    assert rows_t - rows_j <= {"dot"}
    want = ({"orthog", "least_sq", "update_g", "spmv"} if "-gm" in argv
            else {"spmv", "precond", "sptrsv", "dot", "norm", "sum"})
    assert want <= rows_t


def test_kernel_timers_fill_the_registry_and_clear():
    """kernel_timers=True in the host harness charges each instrumented
    call site and leaves no registry behind; off, no timer is touched."""
    from basic_iterative_solvers_tpu_torch.utils import ktimers
    from basic_iterative_solvers_tpu_torch.utils.timers import Timers
    A = bt.generators.from_source("fdm:10")
    for on in (True, False):
        cfg = bt.SolverConfig(method=bt.SolverType.CONJUGATE_GRADIENT,
                              preconditioner=bt.PrecondType.JACOBI,
                              kernel_timers=on, tolerance=1e-8)
        timers = Timers()
        res = bt.solve(bt.preprocessing(A, cfg, device=CPU), timers=timers)
        assert res.converged and ktimers.active() is None
        got = set(timers.names())
        assert got == ({"spmv", "precond", "dot", "sum", "norm"} if on
                       else set())


def test_lu_split_audit():
    """check_lu_split_counts passes the real split and raises LUSplitError
    on a broken one (a part missing an entry, a part of the wrong size)."""
    from basic_iterative_solvers_tpu_torch import factor
    A = bt.generators.from_source("fdm:6")
    f = factor.factor_LU(A)
    sanity.check_lu_split_counts(A, f.L, f.L_strict, f.U, f.U_strict)
    with pytest.raises(sanity.LUSplitError, match="element count"):
        sanity.check_lu_split_counts(A, f.L_strict, f.L_strict, f.U,
                                     f.U_strict)
    small = bt.generators.from_source("fdm:5")
    with pytest.raises(sanity.LUSplitError):
        sanity.check_lu_split_counts(A, f.L, f.L_strict, f.U, small)
    # the CLI's --debug-checks runs it on the host path
    cfg = bt.SolverConfig(method=bt.SolverType.JACOBI, debug_checks=True,
                          max_iters=3)
    bt.preprocessing(A, cfg, device=CPU)


def test_dumps():
    out = io.StringIO()
    sanity.print_vector(torch.arange(70.0), "v", out=out)
    sanity.print_matrix(bt.generators.from_source("fdm:3"), "A", out=out)
    sanity.print_matrix(bt.generators.from_source("fdm:6"), "B", out=out)
    text = out.getvalue()
    assert "(70 entries)" in text and "A (9x9, nnz=33)" in text
    assert "B: 36x36 CSR, nnz=156" in text


def test_traffic_counts_bf16_data_at_two_bytes():
    """iteration_traffic_bytes: the bf16 DIA moves 2 bytes a stored value
    where float32 moves 4, every vector pass unchanged."""
    got = {}
    for md in (None, "bfloat16"):
        A = bt.dia.from_source_device("hpcg:8x8x8", torch.float32, device=CPU)
        cfg = bt.SolverConfig(dtype=torch.float32, matrix_dtype=md)
        got[md] = report.iteration_traffic_bytes(
            bt.preprocessing_device(A, cfg))
    assert got[None] - got["bfloat16"] == 27 * 512 * 2
    out = io.StringIO()
    setup = bt.preprocessing_device(
        bt.dia.from_source_device("hpcg:8x8x8", torch.float32, device=CPU),
        bt.SolverConfig(dtype=torch.float32, max_iters=3))
    report.roofline_report(setup, bt.solve(setup), hbm_gbps=100.0, out=out)
    assert out.getvalue().startswith("[roofline] 3 iters")
    assert "of 100 GB/s, the given rate" in out.getvalue()


def _kernel_names():
    names = set()
    for src in CSRC.glob("*.cu"):
        names |= set(re.findall(r"__global__ void[^\n]*\n(\w+)\(",
                                src.read_text()))
        names |= set(re.findall(r"__global__ void (?:__launch_bounds__\([^)]*"
                                r"\)\s*)?(\w+)\(", src.read_text()))
    return names


def test_bucket_of_maps_every_kernel_of_the_port():
    """Each __global__ kernel in csrc/ falls in its phase bucket: the
    SpMVs and the GS colour step in spmv (the JAX package names that step
    spmv_stencil_gs_color), the level kernels in sptrsv, the basis
    kernels in orthog; PyTorch's own kernels in blas1 and layout_glue."""
    want = {"stencil_spmv_kernel": "spmv",
            "stencil_spmv_stream_kernel": "spmv",
            "stencil_spmv_box_kernel": "spmv",
            "stencil_spmv_stream_box_kernel": "spmv",
            "stencil_gs_color_step_kernel": "spmv",
            "stencil_gs_color_step_box_kernel": "spmv",
            "dia_spmv_kernel": "spmv", "lane_ell_spmv_kernel": "spmv",
            "stencil_spmv_halo_kernel": "spmv",
            "stencil_spmv_halo_box_kernel": "spmv",
            "stencil_gs_color_step_halo_kernel": "spmv",
            "dia_spmv_halo_kernel": "spmv",
            "lane_ell_spmv_halo_kernel": "spmv",
            "lane_ell_spmv_halo_padded_kernel": "spmv",
            "super_level_kernel": "sptrsv",
            "super_level_staged_kernel": "sptrsv",
            "super_level_line_kernel": "sptrsv",
            "super_acc_kernel": "sptrsv",
            "super_acc_staged_kernel": "sptrsv",
            "super_acc_line_kernel": "sptrsv",
            "super_parity_kernel": "sptrsv",
            "super_parity_staged_kernel": "sptrsv",
            "super_parity_line_kernel": "sptrsv",
            "super_solve_mega_kernel": "sptrsv",
            "super_solve_brick_kernel": "sptrsv",
            "rank_level_kernel": "sptrsv",
            "rank_level_vec_kernel": "sptrsv",
            "project_gram_kernel_strided": "orthog",
            "project_gram_kernel_ring": "orthog",
            "correct_write_kernel_strided": "orthog",
            "correct_write_kernel_ring": "orthog"}
    assert _kernel_names() == set(want)
    for name, bucket in want.items():
        # the trace's demangled form: "void name<float, float>(args...)"
        assert profile.bucket_of(f"void {name}<float, __nv_bfloat16>("
                                 "BisDiaArgs, float const*)") == bucket
    assert profile.bucket_of(
        "void at::native::vectorized_elementwise_kernel<4, "
        "at::native::CUDAFunctor_add<float>>(int, float*)") == "blas1"
    assert profile.bucket_of("void at::native::reduce_kernel<512, 1>(R)") \
        == "blas1"
    assert profile.bucket_of("Memcpy DtoD (Device -> Device)") \
        == "layout_glue"
    assert profile.bucket_of("something_else") == "other"


def _trace(tmp_path, events):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def _k(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_trace_parsing(tmp_path):
    """Iteration walls from the marker's starts (the earliest-starting
    name seen exactly n times; a CPU op never counts), and the phase table
    from the kernels' durations."""
    ev = [_k("void dia_spmv_kernel<float, float>(...)", 0.0, 10.0),  # init
          {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 1.0,
           "dur": 5.0}]
    starts = [100.0, 150.0, 260.0]
    for t in starts:
        ev += [_k("void dia_spmv_kernel<float, float>(...)", t, 20.0),
               _k("void at::native::reduce_kernel<512, 1>(...)", t + 20, 5.0),
               _k("Memset (Device)", t + 25, 1.0, cat="gpu_memset")]
    path = _trace(tmp_path, ev)
    walls = profile.iteration_times_from_trace(path, 3)
    # the SpMV occurs 4 times: the marker is the reduction
    np.testing.assert_allclose(walls * 1e6, [50.0, 110.0, 286.0 - 280.0])
    assert profile.iteration_times_from_trace(path, 5) is None
    table, meta = profile.phase_table_from_trace(path)
    np.testing.assert_allclose([table["spmv"], table["blas1"],
                                table["layout_glue"]],
                               [70e-6, 15e-6, 3e-6])
    assert meta["n_ops"] == 10 and meta["device_wall"] == pytest.approx(
        286e-6)
    out = io.StringIO()
    profile.print_phase_table(table, meta, n_iters=3, out=out)
    assert "| spmv" in out.getvalue() and "ms/iter" in out.getvalue()


def test_profile_functions_return_none_on_the_cpu():
    """Off the card there is no device trace: None, and the CLI keeps the
    host times (the JAX module's False/None off the TPU)."""
    A = bt.generators.from_source("fdm:8")
    cfg = bt.SolverConfig(method=bt.SolverType.CONJUGATE_GRADIENT,
                          harness="fused", tolerance=0.0, max_iters=5)
    setup = bt.preprocessing(A, cfg, device=CPU)
    method = make_method(setup)
    res = bt.solve(setup, method=method)
    assert profile.measure_iteration_times(method, 5) is None
    assert profile.measure_phase_table(method, 5) is None
    assert profile.attach_iteration_times(res, method) is False
    assert res.uniform_iteration_times


def test_lost_launches_and_the_miss_report(tmp_path):
    """lost_launches counts the host's kernel launches whose device record
    a trace lacks (copies and other runtime calls aside); a trace with no
    name exactly n_iters times reports its device events, the nearest
    counts and those lost launches."""
    events = [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
               "ts": i, "dur": 1, "args": {"correlation": i}}
              for i in range(5)]
    events += [{"ph": "X", "cat": "kernel", "name": "k", "ts": 10 + i,
                "dur": 1, "args": {"correlation": i}} for i in (0, 2, 3)]
    events.append({"ph": "X", "cat": "cuda_runtime",
                   "name": "cudaMemcpyAsync", "ts": 0, "dur": 1,
                   "args": {"correlation": 9}})
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    assert profile.lost_launches(str(path)) == 2
    why = []
    assert profile.iteration_times_from_trace(str(path), 4, why) is None
    assert why == ["3 device events, n_iters=4, nearest counts: 3 x k; "
                   "2 launches without a device record"]
    assert profile.iteration_times_from_trace(str(path), 3).size == 3
