"""The port's GSPMD mode (`shard_setup` on a torch.distributed DeviceMesh)
against the JAX package, the cases of tests/test_gspmd.py,
test_mixed_precision.py:63 (refinement), test_stencil_op.py:87 and
test_mesh_pallas.py:293-310 (multigrid).

The port runs on 4 gloo ranks on the CPU, one process a rank, started once
for this file (tests/torch_gspmd_ranks.py; a FileStore under tmp_path, no
port): `make_device_mesh()`, then every solve case in mode "gspmd" and in
mode "auto", each rank handing back the whole x.  Each is held against the
JAX package's single-device solve with the JAX test's tolerances (equal
`converged` and `iter_count`, x* within rtol/atol) and, where the JAX test
runs in the default lane, against its 8-virtual-device GSPMD solve too.
"""
import concurrent.futures

import numpy as np
import pytest
import torch

import basic_iterative_solvers_tpu as bis
from basic_iterative_solvers_tpu import dia as jdia
from basic_iterative_solvers_tpu import stencil_op as jst
from basic_iterative_solvers_tpu.parallel import make_mesh as jmake_mesh
from basic_iterative_solvers_tpu.parallel import shard_setup as jshard_setup
from basic_iterative_solvers_tpu.types import PrecondType as JP
from basic_iterative_solvers_tpu.types import SolverType as JS

import basic_iterative_solvers_tpu_torch as bt
from torch_gspmd_ranks import PAIRS, RankGroups

MODES = ("gspmd", "auto")
#: three rank groups, run at once, of about equal work (the GS solver's
#: ~400 sweeps a mode the largest case)
GROUPS = (
    ["colored_gs_solver:gspmd", "pair_jacobi:gspmd", "pair_jacobi:auto",
     "mg:gspmd", "mg:auto"],
    ["colored_gs_solver:auto", "colored_sgs:gspmd", "colored_sgs:auto",
     "refine:gspmd", "refine:auto", "refine_one"],
    [f"pair_{k}:{m}" for k in PAIRS if k != "jacobi" for m in MODES]
    + [f"{c}:{m}" for c in ("planar", "ilu0", "wide_halo", "wide_halo_gs")
       for m in MODES]
    + ["sharding", "refusals", "lane_ell", "gmres_fused", "host_harness",
       "item_trap", "counts"])


def _jcfg(method, precond, **kw):
    kw.setdefault("dtype", np.float64)
    kw.setdefault("tolerance", 1e-11)
    kw.setdefault("harness", "fused")
    return bis.SolverConfig(method=method, preconditioner=precond, **kw)


def _one(A, cfg, host=False):
    """The JAX package's single-device solve."""
    prep = bis.preprocessing if host else bis.preprocessing_device
    return lambda: bis.solve(prep(A, cfg))


def _gspmd8(A, cfg, host=False):
    """The JAX package's GSPMD solve on its 8 virtual devices."""
    prep = bis.preprocessing if host else bis.preprocessing_device
    return lambda: bis.solve(jshard_setup(prep(A, cfg), jmake_mesh(8),
                                          mode="gspmd"))


def _jax_refs():
    """Every JAX reference of this file, by name, not yet run."""
    dia8 = jdia.stencil_27pt_device(8, 8, 8, dtype=np.float64)
    st8 = jst.stencil_27pt_operator(8, 8, 8, dtype=np.float64)
    st884 = jst.stencil_27pt_operator(8, 8, 4, dtype=np.float64)
    refs = {}
    for k, (m, p) in PAIRS.items():
        cfg = _jcfg(JS[m], JP[p], precond_inner_iters=1)
        refs[f"pair_{k}"] = _one(dia8, cfg)
        refs[f"pair_{k}@8"] = _gspmd8(dia8, cfg)
    cfg = _jcfg(JS.CONJUGATE_GRADIENT, JP.JACOBI, planar_vectors="on")
    refs["planar"], refs["planar@8"] = _one(st8, cfg), _gspmd8(st8, cfg)
    cfg = _jcfg(JS.CONJUGATE_GRADIENT, JP.NONE, matrix_format="lane_ell")
    for spec in ("sband:1024,6,40", "sband:1000,6,40"):
        A = bis.generators.from_source(spec)
        refs[spec] = _one(A, cfg, host=True)
    refs["sband:1024,6,40@8"] = _gspmd8(
        bis.generators.from_source("sband:1024,6,40"), cfg, host=True)
    refs["refine@8"] = _gspmd8(
        jdia.stencil_27pt_device(8, 16, 8, dtype=np.float32),
        _jcfg(JS.CONJUGATE_GRADIENT, JP.JACOBI, dtype=np.float32,
              tolerance=1e-12, refine_outer=5))
    refs["mg"] = _one(st8, _jcfg(JS.CONJUGATE_GRADIENT, JP.MULTIGRID,
                                 planar_vectors="on"))
    refs["colored_sgs"] = _one(dia8, _jcfg(
        JS.CONJUGATE_GRADIENT, JP.SYMMETRIC_GAUSS_SEIDEL,
        precond_inner_iters=1))
    refs["colored_gs_solver"] = _one(
        jdia.fdm_2d_device(16, dtype=np.float64),
        _jcfg(JS.SYMMETRIC_GAUSS_SEIDEL, JP.NONE, tolerance=1e-7,
              max_iters=2000))
    src = "hpcg:8x8x8"
    refs["ilu0"] = _one(bis.generators.from_source(src), _jcfg(
        JS.CONJUGATE_GRADIENT, JP.ILU0, gs_mode="colored", tolerance=1e-10,
        color_spec=bis.generators.color_spec_for_source(src)), host=True)
    refs["wide_halo"] = _one(st884, _jcfg(JS.CONJUGATE_GRADIENT,
                                          JP.JACOBI))
    refs["wide_halo_gs"] = _one(st884, _jcfg(
        JS.CONJUGATE_GRADIENT, JP.SYMMETRIC_GAUSS_SEIDEL,
        planar_vectors="on"))
    return refs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    run = RankGroups("gspmd", GROUPS, tmp_path_factory.mktemp("gspmd"))
    yield run
    run.close()


@pytest.fixture(scope="module")
def refs(ranks):
    """The JAX references, solved on two threads of this process while
    the ranks run (XLA's compiles here, gloo's latency there): a future a
    name."""
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=2)
    futures = {k: pool.submit(f) for k, f in _jax_refs().items()}
    yield {k: f.result for k, f in futures.items()}
    pool.shutdown(cancel_futures=True)


def _check(port, ref, rtol=1e-8, atol=1e-10):
    """Every rank's result of a case against a JAX result."""
    for res in port:
        assert res["converged"] == ref.converged
        assert res["iter_count"] == ref.iter_count
        np.testing.assert_allclose(res["x"], np.asarray(ref.x_star),
                                   rtol=rtol, atol=atol)


def _modes(ranks, name, ref, **tol):
    for mode in MODES:
        _check(ranks.case(f"{name}:{mode}"), ref, **tol)


def test_gspmd_halo_wider_than_a_rank(ranks, refs):
    """hpcg:8x8x4 on 4 ranks: a 73-row halo over 64 rows a rank, fetched
    from two neighbours a side, for the SpMV (CG + Jacobi) and the GS
    colour step (CG + coloured SGS, masked sweeps)."""
    for name in ("wide_halo", "wide_halo_gs"):
        _modes(ranks, name, refs[name]())


def test_gspmd_multigrid(ranks, refs):
    """CG + the multigrid V-cycle, the hierarchy whole on every rank
    (test_mesh_pallas.py:293-310: "auto" takes the GSPMD path)."""
    _modes(ranks, "mg", refs["mg"]())


def test_gspmd_colored_sgs_precond(ranks, refs):
    ref = refs["colored_sgs"]()
    assert ref.converged
    _modes(ranks, "colored_sgs", ref, rtol=1e-7, atol=1e-9)


def test_gspmd_blocked_ilu0(ranks, refs):
    """Exact coloured ILU(0) through the superblock pair, replicated on
    every rank."""
    _modes(ranks, "ilu0", refs["ilu0"]())


@pytest.mark.parametrize("pair", list(PAIRS))
def test_gspmd_matches_single_device(ranks, refs, pair):
    res1, res8 = refs[f"pair_{pair}"](), refs[f"pair_{pair}@8"]()
    _modes(ranks, f"pair_{pair}", res1)
    _modes(ranks, f"pair_{pair}", res8)
    if pair == "gm_2st":
        for mode in MODES:
            assert all(r["restarts"] == res1.gmres_restart_count
                       for r in ranks.case(f"pair_{pair}:{mode}"))


def test_gspmd_sharding_is_applied(ranks):
    """The DIA data cut into the ranks' columns, the vectors Shard(0) of
    n / 4 rows a rank (the JAX test's addressable shards)."""
    for r, res in enumerate(ranks.case("sharding")):
        assert res["rank"] == r and res["A"] == "DistDIA"
        k, n = res["data"]
        assert res["data_local"] == (k, n // 4)
        assert res["b_local"] == (n // 4,)
        assert res["placements"] == ["S(0)"] * 3


def test_gspmd_refusals(ranks):
    """The JAX package's refusals in its order, and the port's own."""
    for res in ranks.case("refusals"):
        assert res["indivisible"] == ("vector length 102 not divisible "
                                      "by 4 devices")
        assert res["lines"] == ("stencil rows per rank 25 are not whole "
                                "x-lines of 10")
        assert res["format"] == ("shard_setup supports DIA, stencil and "
                                 "lane-ELL matrices")
        assert "shard_map mode runs on the single-controller Mesh" in (
            res["shard_map"])


def test_gspmd_planar_stencil(ranks, refs):
    for ref in (refs["planar"](), refs["planar@8"]()):
        _modes(ranks, "planar", ref, rtol=1e-9, atol=1e-11)


def test_gspmd_lane_ell(ranks, refs):
    """sband:1024 (256 rows a rank: whole x2-rows, the halo form) against
    the JAX package's single-device and GSPMD solves; sband:1000 (250 rows
    a rank: the gather form) against its single-device solve."""
    out = ranks.case("lane_ell")
    for spec, gather in (("sband:1024,6,40", False),
                         ("sband:1000,6,40", True)):
        port = [res[spec] for res in out]
        assert all(p["op"] == "DistLaneELL" and p["gather"] == gather
                   for p in port)
        for ref in [refs[spec]()] + ([] if gather
                                     else [refs[spec + "@8"]()]):
            assert ref.converged
            _check(port, ref)


def test_refinement_over_gspmd(ranks, refs):
    """float64 refinement around float32 CG + Jacobi on the DTensor
    operator (test_mixed_precision.py:63): converged in at least two
    outers, the outer and inner counts of the port's single-device
    refinement, x held against the JAX package's GSPMD refinement."""
    ref = refs["refine@8"]()
    assert ref.converged and ref.refine_outer_count >= 2
    ones = ranks.case("refine_one")
    for mode in MODES:
        for res, one in zip(ranks.case(f"refine:{mode}"), ones):
            assert res["converged"] and res["outers"] >= 2
            assert res["final"] <= res["stop"]
            assert res["outers"] == one["outers"]
            assert res["iter_count"] == one["iter_count"]
            np.testing.assert_allclose(res["x"], np.asarray(ref.x_star),
                                       rtol=1e-8, atol=1e-10)


def test_gspmd_colored_gs_solver(ranks, refs):
    ref = refs["colored_gs_solver"]()
    assert ref.converged
    _modes(ranks, "colored_gs_solver", ref, rtol=0, atol=1e-8)


def test_gspmd_gmres_fused_basis(ranks):
    """f32 fused-mode GMRES: #6 and #7 on each rank's columns of V, one
    all-reduce of their partial products, against the port's
    single-device solve."""
    for res in ranks.case("gmres_fused"):
        one, sh = res["one"], res["gspmd"]
        assert sh["converged"] == one["converged"]
        assert sh["iter_count"] == one["iter_count"]
        np.testing.assert_allclose(sh["x"], one["x"], rtol=1e-4, atol=1e-5)


def test_gspmd_host_harness(ranks):
    """The host harness reads the sampled norm through the host helper."""
    for res in ranks.case("host_harness"):
        one, sh = res["one"], res["gspmd"]
        assert sh["iter_count"] == one["iter_count"] and sh["converged"]
        np.testing.assert_allclose(sh["norms"], one["norms"], rtol=1e-8,
                                   atol=1e-14 * one["norms"][0])
        np.testing.assert_allclose(sh["x"], one["x"], rtol=1e-10,
                                   atol=1e-12)


def test_item_of_a_partial_dot_is_the_ranks_own(ranks):
    """The trap: `.item()` of a Partial DTensor is the rank's partial sum;
    the host helper and `dot` give the global value on every rank."""
    out = ranks.case("item_trap")
    assert any(res["partial_item"] != res["global"] for res in out)
    for res in out:
        assert res["full"] == res["global"] == res["dot"]
        assert res["dot_placements"] == ["R"]


def test_gspmd_operators_call_the_halo_kernels(ranks):
    """One stencil SpMV is one halo exchange (two shifts) and equals the
    single-device SpMV; the DTensor operators go through the halo-form
    kernels' entry points (the GS step's on the masked sweep)."""
    A = bt.stencil_op.from_source_operator("hpcg:8x8x8", torch.float64,
                                           device="cpu")
    y1 = bt.ops.spmv(A, torch.ones(A.n_rows, dtype=torch.float64)).numpy()
    for res in ranks.case("counts"):
        assert res["op"] == "DistStencil" and res["permutes"] == 2
        assert res["bytes"] > 0
        np.testing.assert_array_equal(res["y"], y1)
        assert all(c >= 1 for c in res["calls"].values()), res["calls"]


def test_ranks_load_no_jax(ranks):
    assert not any(res["_jax_loaded"] for group in ranks.results()
                   for res in group)


def test_make_device_mesh_needs_a_group():
    """No process group, no mesh: nothing makes a one-rank group behind
    the caller's back."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialised default process"):
        bt.parallel.make_device_mesh()
