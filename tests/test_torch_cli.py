"""The port's command line (basic_iterative_solvers_tpu_torch.cli) against
the JAX package's (basic_iterative_solvers_tpu.cli): parse_cli over every
flag with the same results and exit codes, `run` printing the same summary
and residual table (norms within rtol 1e-10 in float64 and 1e-5 in
float32; the timing column and the [roofline] line exempt), the module
entry point in a subprocess that never imports jax, and the default device
(the card) with no card raising, naming it.
"""
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from basic_iterative_solvers_tpu import cli as jcli

import basic_iterative_solvers_tpu_torch as bt
from basic_iterative_solvers_tpu_torch import cli as tcli

#: argv tails covering every option and switch of the JAX parser
PARSE_CASES = [
    ["m.mtx", "-cg", "-p", "ilu0", "-rl", "25", "-scale", "1"],
    ["x", "-bi", "--dtype", "float32", "--harness", "fused", "--max-iters",
     "7", "--tol", "1e-9", "--format", "ell"],
    ["x", "-gm", "-perm", "rcm", "--gs-mode", "colored", "--orthog",
     "lowsync", "--gmres-basis", "bfloat16", "--matrix-dtype", "bfloat16"],
    ["x", "-cg", "--cg-flavor", "pipelined", "--cg-rr", "10",
     "--cg-rr-theta", "0.05", "--refine", "4", "--refine-inner-tol", "1e-5"],
    ["x", "-cg", "-p", "mg", "--mg-levels", "3", "--mg-smooth", "2",
     "--mg-coarse", "8", "--mg-transfer", "injection", "--mg-coarse-op",
     "rediscretize"],
    ["x", "-cg", "-p", "cheby", "--cheby-degree", "6", "--cheby-ratio",
     "20", "--inner", "2", "--outer", "3"],
    ["x", "-sgs", "--platform", "cpu", "--profile", "d", "--dump-matrix",
     "o.mtx", "--debug-checks", "--kernel-timers", "--iter-times"],
    ["x", "-j", "--unknown", "-p", "s2st"],
    ["x", "-gs", "-p", "2st"], ["x", "-gs", "-p", "bgs"],
    ["x", "-gs", "-p", "j"], ["x", "-gs", "-p", "gs"],
    ["x", "-gs", "-p", "sgs"], ["x", "-gs", "-p", "none"],
]


def _plain(parsed):
    """(source, opts, extras) with the enums as their names, so the two
    packages' results compare."""
    src, opts, extras = parsed
    return src, {k: getattr(v, "name", v) for k, v in opts.items()}, extras


@pytest.mark.parametrize("bench", [False, True])
@pytest.mark.parametrize("argv", PARSE_CASES,
                         ids=[" ".join(a[1:3]) for a in PARSE_CASES])
def test_parse_cli_matches_jax(argv, bench, capsys):
    """The same (source, opts, extras) and the same messages; bench_mode
    reads no method flag (argv without it)."""
    if bench:
        argv = argv[:1] + argv[2:]
    got = _plain(tcli.parse_cli(argv, bench_mode=bench))
    err_t = capsys.readouterr().err
    want = _plain(jcli.parse_cli(argv, bench_mode=bench))
    err_j = capsys.readouterr().err
    assert got == want
    assert err_t == err_j


@pytest.mark.parametrize("argv,bench", [
    (["only_matrix"], False), (["m.mtx", "-zz"], False),
    (["m.mtx", "-cg", "-p", "nope"], False), (["m.mtx", "-cg", "-rl"], False),
    (["m.mtx", "-cg", "-p"], False), ([], True), (["m.mtx", "--tol"], True)])
def test_parse_cli_exit_codes_match_jax(argv, bench, capsys):
    """SystemExit with the JAX parser's code and message (the usage line
    names each package's own module)."""
    with pytest.raises(SystemExit) as et:
        tcli.parse_cli(argv, bench_mode=bench)
    err_t = capsys.readouterr().err
    with pytest.raises(SystemExit) as ej:
        jcli.parse_cli(argv, bench_mode=bench)
    err_j = capsys.readouterr().err
    assert et.value.code == ej.value.code == 2
    assert err_t == err_j.replace("basic_iterative_solvers_tpu ",
                                  "basic_iterative_solvers_tpu_torch ")


_NORM = re.compile(r"^\|\|A\*x_(\d+) - b\|\|_2 = ([0-9.e+-]+)")


def _report(text):
    """(table rows [(k, norm)], summary lines with their numbers split
    off [(words, numbers)]) of a run's standard output."""
    rows, summary = [], []
    for line in text.splitlines():
        m = _NORM.match(line)
        if m:
            rows.append((int(m.group(1)), float(m.group(2))))
        elif line.startswith(("Solver:", "With the stopping", "The residual",
                              "(fused harness", "+", " ")):
            nums = re.findall(r"\d\.\d+e[+-]\d+", line)
            summary.append((re.sub(r"\d\.\d+e[+-]\d+", "#", line),
                            [float(v) for v in nums]))
    return rows, summary


def _run_both(run_argv, capsys):
    assert tcli.run(run_argv + ["--platform", "cpu"]) == 0
    t = capsys.readouterr().out
    assert jcli.run(run_argv + ["--platform", "cpu"]) == 0
    j = capsys.readouterr().out
    return _report(t), _report(j)


@pytest.mark.parametrize("argv,rtol,floor", [
    (["fdm:8", "-cg", "-p", "j", "--dtype", "float64", "--harness", "host"],
     1e-10, 1e-14),
    (["hpcg:8x8x8", "-gm", "-rl", "20"], 1e-10, 1e-14),
    (["hpcg:8x8x8", "-cg", "--dtype", "float32", "--matrix-dtype",
      "bfloat16", "--harness", "fused", "--tol", "1e-6"], 1e-5, 1e-6)],
    ids=["fdm_cg_j_f64_host", "hpcg_gm_rl20", "hpcg_cg_f32_bf16_fused"])
def test_run_prints_the_jax_report(argv, rtol, floor, capsys):
    """The summary lines word for word and the residual table row for row,
    norms within `rtol` above the dtype's rounding floor (atol
    floor·||r0||: the float64 solves end at ~1e-15·||r0||, where
    reduction order alone moves a norm by 2-3x; in float32 the packages'
    dots differ, XLA's by 20 ulps from the correctly rounded one on this
    very r0, torch's not at all, and CG carries that ~1e-6·||r0||).  The
    float32 row stops at --tol 1e-6: at the default 1e-14 a float32 CG runs
    into its rounding floor, where those dots decide the count.  The
    explicit final residual ||b − A·x*|| at the rounding floor (below
    100·floor·||r0||) is compared to rtol 0.5."""
    (rows_t, sum_t), (rows_j, sum_j) = _run_both(argv, capsys)
    assert [k for k, _ in rows_t] == [k for k, _ in rows_j]
    nt = np.array([v for _, v in rows_t])
    nj = np.array([v for _, v in rows_j])
    np.testing.assert_allclose(nt[:-1], nj[:-1], rtol=rtol,
                               atol=floor * nj[0])
    assert [w for w, _ in sum_t] == [w for w, _ in sum_j]
    at_floor = nj[-1] < 100 * floor * nj[0]
    for (w, vt), (_, vj) in zip(sum_t, sum_j):
        final = w.startswith("The residual") and at_floor
        np.testing.assert_allclose(vt, vj, rtol=0.5 if final else rtol)
    np.testing.assert_allclose(nt[-1], nj[-1], rtol=0.5 if at_floor else rtol)


def test_module_entry_point_runs_without_jax():
    """`python -m basic_iterative_solvers_tpu_torch ... --platform cpu`
    exits 0, prints the summary, and never imports jax."""
    code = ("import runpy, sys; sys.argv = ['x', 'fdm:8', '-cg', '-p', 'j', "
            "'--platform', 'cpu'];\n"
            "try:\n"
            "    runpy.run_module('basic_iterative_solvers_tpu_torch', "
            "run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    print('jax imported:', 'jax' in sys.modules)\n"
            "    raise")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "converged in:" in out.stdout
    assert "conjugate-gradient with preconditioner: jacobi" in out.stdout
    assert "jax imported: False" in out.stdout


def test_run_defaults_to_the_card(monkeypatch):
    """Without --platform the command line runs on the card; with no card
    it raises, naming the device, and runs nothing on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="'cuda'.*--platform cpu"):
        tcli.run(["fdm:8", "-cg"])


def test_args_to_config():
    """Args resolves "auto" by the device: float32 and fused on a card,
    float64 and host on the CPU; explicit values pass through."""
    a = bt.Args(matrix_source="fdm:8", method=bt.SolverType.BICGSTAB,
                preconditioner=bt.PrecondType.JACOBI, perm_mode="rcm",
                gs_mode="colored", orthog_mode="lowsync",
                gmres_basis_dtype="bfloat16", matrix_dtype="bfloat16")
    cpu = a.to_config(device="cpu")
    assert (cpu.spec_dtype(), cpu.harness) == (torch.float64, "host")
    assert cpu.mat_dtype() == torch.bfloat16
    card = a.to_config()
    assert (card.spec_dtype(), card.harness) == (torch.float32, "fused")
    assert (card.method, card.perm_mode, card.gs_mode, card.orthog_mode,
            card.gmres_basis_dtype) == (bt.SolverType.BICGSTAB, "rcm",
                                        "colored", "lowsync", "bfloat16")
    b = bt.Args(dtype="float64", harness="host").to_config()
    assert (b.spec_dtype(), b.harness) == (torch.float64, "host")


def test_dump_matrix_and_profile(tmp_path, capsys):
    """--dump-matrix writes the solve-ordering matrix (read back equal);
    --profile writes a torch.profiler trace; --debug-checks runs the L/U
    split audit."""
    out = tmp_path / "a.mtx"
    rc = tcli.run(["sband:300,6,40", "-gs", "--platform", "cpu",
                   "--dump-matrix", str(out), "--profile",
                   str(tmp_path / "trace"), "--debug-checks",
                   "--max-iters", "20"])
    assert rc == 0
    A = bt.read_mtx(str(out))
    B = bt.generators.from_source("sband:300,6,40")
    np.testing.assert_array_equal(A.col, B.col)
    np.testing.assert_allclose(A.val, B.val, rtol=1e-15)
    assert (tmp_path / "trace" / "trace.json").exists()
    err = capsys.readouterr().err
    assert "[profile] trace written to" in err and "wrote" in err
