"""BENCHMARK.json and the files it names, parsed as data, against the
benchmark's contract; the layer map."""
import json
import re

import pytest

from solverbench import cells, roofline, trace
from solverbench.cells import HERE, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["solverbench"]
    assert BENCH["command"] == ["python3", "solverbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_lines():
    entries = (BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
               + BENCH["per_layer"])
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k], e
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert set(e2e) == {"solve_s", "peak_mem_gb", "setup_s"}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load(cell):
    c = cells.load_cell(cell)
    assert c.chips == 1
    assert {m["name"] for m in c.end_to_end} == {"solve_s", "peak_mem_gb",
                                                  "setup_s"}
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.end_to_end + c.per_layer:
        assert callable(cells.reader(m["name"]))
    assert set(c.limits) >= {"failed", "resid", "err"}
    nx, ny, nz = c.config["grid"]
    assert c.config["rows"] == nx * ny * nz
    assert c.config["reduced"] == []
    assert c.traffic["tolerance"] > 0 and c.traffic["checked_solves"] >= 1


def test_per_layer_metrics_name_real_cells_and_layers():
    for m in BENCH["per_layer"]:
        assert m["moves"] == "solve_s"
        assert set(m["workloads"]) <= set(CELLS)
        if m["name"].endswith(".roofline"):
            assert m["unit"] == "%"


def test_configs_are_files_of_their_own():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]


def test_layer_map_seeded_and_matched():
    frags = trace.layer_map()
    layers = {layer for _, layer in frags}
    assert {"spmv", "sptrsv", "blas1", "layout_glue"} <= layers
    assert all((HERE / "layers" / lay).is_dir() for lay in layers)
    of = lambda n: trace.layer_of(n, frags)  # noqa: E731
    assert of("void stencil_spmv_box_kernel<float>(BisStencilArgs)") == "spmv"
    assert of("dia_spmv_kernel(BisDiaArgs, float const*)") == "spmv"
    assert of("super_level_staged_kernel(BisSuperLevelArgs)") == "sptrsv"
    assert of("void at::native::reduce_kernel<512, 1, at::native::ReduceOp"
              "<float, at::native::func_wrapper_t<float>>>") == "blas1"
    assert of("void at::native::elementwise_kernel<128, 4, at::native::"
              "gpu_kernel_impl_nocast<at::native::direct_copy_kernel_cuda("
              "at::TensorIteratorBase&)>>") == "layout_glue"
    assert of("void at::native::vectorized_elementwise_kernel<4, at::"
              "native::FillFunctor<float>>") == "layout_glue"
    assert of("Memcpy DtoH (Device -> Pinned)") == "layout_glue"
    assert of("some_other_kernel") == "other"


def test_byte_rules_by_hand():
    cfg = cells.load_cell("hpcg384-stencil.cg").config
    n = 384 ** 3
    assert roofline.rows(cfg) == n == 56_623_104
    assert roofline.points(cfg) == 27
    assert roofline.spmv_bytes(cfg, 4) == 452_984_832
    assert roofline.spmv_ops(cfg) == 2 * 27 * n
    assert roofline.trisolve_apply_bytes(cfg, 4) == 905_969_664
    dia = cells.load_cell("hpcg384-dia.cg").config
    assert roofline.spmv_bytes(dia, 4) == 27 * (n * 4 + 8) + 2 * n * 4
    # the float64 residual: x and y in float64, the diagonals as stored
    assert roofline.spmv_bytes(dia, 8) == 27 * (n * 4 + 8) + 2 * n * 8
    assert roofline.bound_seconds(3.35e12) == 1.0
    assert roofline.bound_seconds(1.0, 67e12) == 1.0
