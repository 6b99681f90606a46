"""Whole runs of tiny cells on the CPU through the port's plain paths:
a sound run is correct, the control and each fault the cells can have
are not; main's refusals; the traced slice read from a synthetic trace."""
import json
import time

import pytest
import torch

from solverbench import calibrate, cells, check, reference, run
from solverbench import trace as tr
from solverbench.program import Program

GRID = 12


def tiny(name="hpcg384-stencil.cg", max_iters=None):
    c = cells.load_cell(name)
    c.config.update(grid=[GRID] * 3, generator=f"hpcg:{GRID}x{GRID}x{GRID}",
                    rows=GRID ** 3)
    if max_iters:
        c.traffic["max_iters"] = max_iters
    return c


def measure(cell, trace=False, seconds=0.3, seed=2**40 + 11):
    return run.measure(cell, seed, seconds, trace, "cpu", time.perf_counter())


@pytest.mark.parametrize("name", ["hpcg384-stencil.cg", "hpcg384-dia.cg",
                                  "hpcg384-stencil.pcg_ilu0"])
def test_sound_run_is_correct(name):
    r = measure(tiny(name))
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "checks"
    assert set(r["checks"]) == {"failed", "resid", "err"}
    assert {"solve_s", "setup_s"} <= set(r["metrics"])
    assert r["metrics"]["solve_s"]["unit"] == "s"


def test_traced_run_reports_per_layer_metrics():
    r = measure(tiny(), trace=True, seconds=0.6)
    assert r["correct"]
    m = r["metrics"]
    assert {"iters_per_solve", "ms_per_iter"} <= set(m)
    assert "solve_s" not in m
    # the CPU has no device trace: nothing is made up for it
    assert "spmv.roofline" not in m and "device_idle_share" not in m
    assert r["device"]["window_s"] > 0 and "breakdown" in r


def test_control_is_not_correct():
    """The reference's CG in bfloat16 in the program's place."""
    cell = tiny()

    def control(self, b, x0):
        op = reference.operator(cell.config, calibrate.CONTROL_DTYPE)
        x, k, ok = reference.cg(op, b, x0, cell.traffic["tolerance"],
                                cell.traffic["max_iters"],
                                calibrate.CONTROL_DTYPE)
        return _Result(x.to(b.dtype), k, ok)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Program, "solve", control)
        r = measure(cell)
    assert not r["correct"]
    assert r["checks"]["resid"]["value"] > r["checks"]["resid"]["limit"]


class _Result:
    def __init__(self, x, k, ok):
        self.x_star, self.iter_count, self.converged = x, k, ok
        self.final_residual_norm = 0.0


def _altered(alter):
    orig = Program.solve

    def solve(self, b, x0):
        res = orig(self, b, x0)
        res.x_star = alter(res.x_star.clone())
        return res
    return solve


def _half_left_out(x):
    x[: x.numel() // 2] = 0
    return x


def _stops_early(init):
    def build(self, config, traffic, device):
        init(self, config, {**traffic, "tolerance": 1e-4}, device)
    return build


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out",
                                   "answer_altered", "stops_early"])
def test_faults_are_not_correct(fault):
    cell = tiny(max_iters=60)
    with pytest.MonkeyPatch.context() as mp:
        if fault == "stops_early":
            # a solve to 1e-4 where the traffic asks for 1e-6
            mp.setattr(Program, "__init__", _stops_early(Program.__init__))
        elif fault == "state_unchanged":
            from basic_iterative_solvers_tpu_torch.solvers import cg
            mp.setattr(cg.ConjugateGradientMethod, "iterate",
                       lambda self, state, active=None: state)
        elif fault == "half_left_out":
            mp.setattr(Program, "solve", _altered(_half_left_out))
        else:
            mp.setattr(Program, "solve", _altered(lambda x: x * (1 + 1e-2)))
        r = measure(cell)
    assert not r["correct"]
    if fault == "state_unchanged":
        assert r["failed"] == r["attempted"]


def test_judge_without_samples_is_not_correct():
    cell = tiny()
    ok, checks = check.judge(cell.config, cell.traffic, 1, [], 0,
                             cell.limits, "cpu")
    assert not ok and checks["resid"]["value"] is None


def test_reservoir_keeps_a_seeded_sample():
    a = check.Reservoir(3, 4, torch.float32, 9, "cpu")
    b = check.Reservoir(3, 4, torch.float32, 9, "cpu")
    for i in range(50):
        a.offer(i, torch.full((4,), float(i)))
        b.offer(i, torch.full((4,), float(i)))
    assert [i for i, _ in a.samples()] == [i for i, _ in b.samples()]
    assert all(float(x[0]) == i for i, x in a.samples())


def test_main_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "hpcg384-stencil.cg", "--seed",
                     "3000000000", "--seconds", "1"]) == 2
    out = capsys.readouterr().out.strip().splitlines()
    assert not any(line.startswith("{") for line in out)


def test_main_refuses_with_a_bis_switch(monkeypatch, capsys):
    monkeypatch.setenv("BIS_SB_MEGA", "1")
    assert run.main(["--workload", "hpcg384-stencil.cg", "--seed", "1",
                     "--seconds", "1"]) == 2
    assert '"BIS_SB_MEGA"' in capsys.readouterr().out


def test_trace_slice_from_a_synthetic_trace(tmp_path):
    ev = [{"ph": "X", "cat": "user_annotation", "name": tr.SPAN,
           "ts": 0, "dur": 1000},
          {"ph": "X", "cat": "user_annotation", "name": tr.SPAN,
           "ts": 1500, "dur": 500},
          {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 20,
           "dur": 100},
          {"ph": "X", "cat": "kernel", "name": "stencil_spmv_box_kernel",
           "ts": 100, "dur": 300},
          {"ph": "X", "cat": "kernel", "name": "void at::native::"
           "reduce_kernel<512>", "ts": 350, "dur": 150},
          {"ph": "X", "cat": "kernel", "name": "stencil_spmv_box_kernel",
           "ts": 700, "dur": 100},
          # the benchmark's own work between two calls: left out
          {"ph": "X", "cat": "kernel", "name": "rhs_kernel", "ts": 1100,
           "dur": 200},
          {"ph": "X", "cat": "kernel", "name": "stencil_spmv_box_kernel",
           "ts": 1600, "dur": 100},
          {"ph": "X", "cat": "kernel", "name": "late_kernel", "ts": 2500,
           "dur": 10}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    s = tr.TraceSlice.from_file(path)
    assert s.window_s == pytest.approx(1.5e-3)
    # [100, 500] ∪ [700, 800] ∪ [1600, 1700]
    assert s.busy_s == pytest.approx(600e-6)
    assert s.kernel_launches == 4
    layers = s.layer_seconds()
    assert layers["spmv"] == pytest.approx(500e-6)
    assert layers["blas1"] == pytest.approx(150e-6)
    assert "other" not in layers
    gaps = dict(s.idle_gaps())
    assert gaps["aten::add"] == pytest.approx(100e-6)   # [0, 100]
    # [500, 700], [800, 1000], [1500, 1600] and [1700, 2000]
    assert gaps["python"] == pytest.approx(800e-6)
    top = s.device_ops()[0]
    assert top[0] == "stencil_spmv_box_kernel"
    assert top[1] == pytest.approx(500e-6)


@pytest.mark.cuda
def test_small_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the port's kernels run only on the card")
    c = cells.load_cell("hpcg384-stencil.cg")
    c.config.update(grid=[64] * 3, generator="hpcg:64x64x64", rows=64 ** 3)
    r = run.measure(c, 2**33 + 1, 1.0, True, "cuda", time.perf_counter())
    assert r["correct"] and r["device"]["busy_s"] > 0
    assert "spmv.roofline" in r["metrics"]
