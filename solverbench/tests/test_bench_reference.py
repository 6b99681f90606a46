"""The plain reference: its two operators against each other and against
the port at small sizes, its CG, and what it and a run may import."""
import ast
import json
import subprocess
import sys

import pytest
import torch

from solverbench import reference, traffic
from solverbench.cells import HERE, ROOT

HPCG = {"shape": "box", "radius": 1, "diagonal": 26.0, "off_diagonal": -1.0}


@pytest.mark.parametrize("grid", [(16, 16, 16), (8, 6, 5)])
def test_stencil_and_dia_apply_agree(grid):
    op = reference.StencilOp(grid, HPCG, planes=3)
    dia = reference.DiaOp(op)
    x = torch.rand(op.n, dtype=torch.float64, generator=torch.Generator()
                   .manual_seed(1))
    assert torch.equal(op.apply(x), dia.apply(x))
    assert len(dia.offsets) == 27


def test_stencil_apply_by_hand():
    op = reference.StencilOp((3, 3, 3), HPCG)
    y = op.apply(torch.ones(27, dtype=torch.float64))
    # a corner row has 7 neighbours, an edge row 11, a face row 17, the
    # centre 26 (row = x + 3·(y + 3·z))
    assert y[0] == 19 and y[1] == 15 and y[4] == 9 and y[13] == 0


def test_unknown_stencil_is_refused():
    with pytest.raises(ValueError):
        reference.StencilOp((5, 4, 3), {"diagonal": 26.0, "shape": "star"})


def test_reference_matches_the_port_row_order():
    import basic_iterative_solvers_tpu_torch as bis
    from basic_iterative_solvers_tpu_torch.ops.spmv import spmv
    A = bis.stencil_op.from_source_operator("hpcg:8x6x5", torch.float64,
                                            device="cpu")
    op = reference.StencilOp((8, 6, 5), HPCG)
    x = torch.rand(op.n, dtype=torch.float64)
    assert torch.allclose(spmv(A, x), op.apply(x), rtol=0, atol=1e-12)


def test_float64_cg_reaches_x_true():
    cfg = {"x_true": {"center": 1.0, "half_width": 0.5}}
    op = reference.StencilOp((12, 12, 12), HPCG)
    xt, b = traffic.rhs(op, cfg, 2**40 + 3, 0, torch.float64, "cpu")
    x, k, ok = reference.cg(op, b, torch.zeros_like(b), 1e-12, 500)
    assert ok and 0 < k < 500
    assert reference.relative_error(x, xt) < 1e-9
    assert reference.relative_residual(op, b, x) < 1e-11


def test_rhs_repeats_and_differs_by_index():
    cfg = {"x_true": {"center": 1.0, "half_width": 0.5}}
    op = reference.StencilOp((6, 6, 6), HPCG)
    big = 2**33 + 7                      # more than 32 signed bits hold
    x1, b1 = traffic.rhs(op, cfg, big, 4, torch.float32, "cpu")
    x2, b2 = traffic.rhs(op, cfg, big, 4, torch.float32, "cpu")
    x3, _ = traffic.rhs(op, cfg, big, 5, torch.float32, "cpu")
    assert torch.equal(x1, x2) and torch.equal(b1, b2)
    assert not torch.equal(x1, x3)
    assert 0.5 <= float(x1.min()) and float(x1.max()) < 1.5


def test_reference_imports_torch_alone():
    tree = ast.parse((HERE / "reference.py").read_text())
    mods = {a.name.split(".")[0] for node in ast.walk(tree)
            if isinstance(node, ast.Import) for a in node.names}
    mods |= {node.module.split(".")[0] for node in ast.walk(tree)
             if isinstance(node, ast.ImportFrom) and node.level == 0}
    assert mods <= {"__future__", "itertools", "torch"}


def _loaded_after(code: str):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_yardstick_loads_nothing_of_the_port_or_jax():
    top = _loaded_after("import solverbench.reference, solverbench.check, "
                        "solverbench.roofline, solverbench.traffic, "
                        "solverbench.trace, solverbench.cells")
    assert not top & {"basic_iterative_solvers_tpu_torch",
                      "basic_iterative_solvers_tpu", "jax", "jaxlib", "flax"}


def test_a_run_loads_no_jax():
    code = ("import sys, time; sys.argv = ['x']\n"
            "from solverbench import cells, run\n"
            "c = cells.load_cell('hpcg384-stencil.cg')\n"
            "c.config.update(grid=[8, 8, 8], generator='hpcg:8x8x8')\n"
            "r = run.measure(c, 5, 0.2, False, 'cpu', time.perf_counter())\n"
            "assert r['correct'], r\n"
            "assert run.forbidden_modules() == []")
    top = _loaded_after(code)
    assert "basic_iterative_solvers_tpu_torch" in top
    assert not top & {"basic_iterative_solvers_tpu", "jax", "jaxlib", "flax"}


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    from solverbench import run
    monkeypatch.setitem(sys.modules, "basic_iterative_solvers_tpu_torch_x",
                        sys)
    assert "basic_iterative_solvers_tpu_torch_x" not in \
        run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "basic_iterative_solvers_tpu.config",
                        sys)
    assert "basic_iterative_solvers_tpu.config" in run.forbidden_modules()
