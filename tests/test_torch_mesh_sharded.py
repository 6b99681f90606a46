"""The port's distributed CG (`make_sharded_cg`, the JAX package's
standalone shard_map CG) against the JAX package's, the halo guard, the
mesh itself (`make_mesh`, `ppermute`, `psum`) and `shard_setup`'s
refusals: the JAX package's, in its order and with its messages, and the
port's own (the GSPMD mode, which needs a DeviceMesh); a Mesh over
several devices places each shard on its own; superblock solves shard
(slice 8b).  8 shards on the CPU; the JAX side on its 8 virtual devices.
"""
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import basic_iterative_solvers_tpu as bis
from basic_iterative_solvers_tpu.device_matrix import csr_to_dia
from basic_iterative_solvers_tpu.parallel import make_mesh as jmake_mesh
from basic_iterative_solvers_tpu.parallel import (
    make_sharded_cg as jmake_sharded_cg)

import basic_iterative_solvers_tpu_torch as bt
from basic_iterative_solvers_tpu_torch.device_matrix import from_csr
from basic_iterative_solvers_tpu_torch.factor import peel_diag
from basic_iterative_solvers_tpu_torch.parallel import (Mesh, make_mesh,
                                                        make_sharded_cg,
                                                        shard_dia,
                                                        shard_setup)
from basic_iterative_solvers_tpu_torch.parallel import mesh_ops as tmo
from tests.test_torch_ilu0_factor import numpy_branch  # noqa: F401
from tests.test_torch_mesh_solve import mesh_x

CPU = "cpu"


@pytest.fixture(scope="module")
def mesh8():
    return make_mesh(8, device=CPU)


def _fdm16():
    return bt.generators.fdm_2d(16), bis.generators.fdm_2d(16)


def _run(cg, steps):
    state = cg.init_state(cg.b * 0.0)
    step = cg.step_fn()
    norms = [float(state["residual_norm"])]
    for _ in range(steps):
        state = step(state)
        norms.append(float(state["residual_norm"]))
    return state, np.asarray(norms)


def test_sharded_cg_matches_jax(mesh8):
    """The JAX test_sharded_cg_matches_single_device case: Jacobi CG on
    fdm:16 over 8 shards, 60 steps, the port's history against the JAX
    package's sharded history within rtol 1e-9 (atol 1e-15, the psum's
    round-off), and x* within 1e-6."""
    A, Aj = _fdm16()
    x_star = np.linspace(1.0, 2.0, 256)
    b = A.spmv(x_star)
    D, D_inv = peel_diag(A)
    cgj = jmake_sharded_cg(csr_to_dia(Aj, np.float64), jnp.asarray(b),
                           jmake_mesh(8), D_inv=jnp.asarray(D_inv))
    sj = cgj.init_state(cgj.b * 0.0)
    stepj = cgj.step_fn()
    nj = [float(sj["residual_norm"])]
    for _ in range(60):
        sj = stepj(sj)
        nj.append(float(sj["residual_norm"]))
    cg = make_sharded_cg(from_csr(A, torch.float64, "dia", device=CPU),
                         torch.from_numpy(b), mesh8,
                         D_inv=torch.from_numpy(D_inv))
    assert cg.npad == cgj.npad == 8192
    state, nt = _run(cg, 60)
    np.testing.assert_allclose(nt, nj, rtol=1e-9, atol=1e-15)
    np.testing.assert_allclose(mesh_x(state["x"])[:256].numpy(), x_star,
                               atol=1e-6)


def test_sharded_spmv_matches_host(mesh8):
    """The JAX test_sharded_spmv_matches_host case: one halo-exchanged
    SpMV through the sharded CG's init (r = b − A·x, b = 0) on HPCG 16^3,
    halo 273 rows under 1024 local, against the host CSR SpMV."""
    A = bt.generators.stencil_27pt(16, 16, 16)
    x = np.random.default_rng(0).uniform(-1, 1, A.n_rows)
    cg = make_sharded_cg(from_csr(A, torch.float64, "dia", device=CPU),
                         torch.zeros(A.n_rows, dtype=torch.float64), mesh8)
    state = cg.init_state(torch.nn.functional.pad(
        torch.from_numpy(x), (0, cg.npad - A.n_rows)))
    np.testing.assert_allclose(-mesh_x(state["r"])[:A.n_rows].numpy(),
                               A.spmv(x), rtol=1e-12, atol=1e-12)


def test_sharded_cg_two_stage_matches_jax(mesh8, numpy_branch):  # noqa: F811
    """The JAX test_sharded_cg_two_stage_matches_single_device case: the
    symmetric two-stage preconditioner (each inner sweep one more halo
    exchange), 40 steps, against the JAX package's single-device host
    solve within rtol 1e-9."""
    A, Aj = _fdm16()
    x_star = np.linspace(1.0, 2.0, 256)
    b = A.spmv(x_star)
    D, D_inv = peel_diag(A)
    cg = make_sharded_cg(from_csr(A, torch.float64, "dia", device=CPU),
                         torch.from_numpy(b), mesh8,
                         D_inv=torch.from_numpy(D_inv), two_stage=True,
                         inner_iters=2)
    state, nt = _run(cg, 40)
    cfg = bis.SolverConfig(method=bis.SolverType.CONJUGATE_GRADIENT,
                           preconditioner=(
                               bis.PrecondType.SYMMETRIC_TWO_STAGE_GS),
                           precond_inner_iters=2, dtype=np.float64,
                           harness="host", max_iters=40, tolerance=0.0)
    r1 = bis.solve(bis.preprocessing(Aj, cfg, b=b, x0=np.zeros(256)))
    np.testing.assert_allclose(nt[:len(r1.residual_norms) - 1],
                               r1.residual_norms[:41], rtol=1e-9,
                               atol=1e-15)
    np.testing.assert_allclose(mesh_x(state["x"])[:256].numpy(), x_star,
                               atol=1e-6)
    with pytest.raises(ValueError, match="two_stage needs D_inv"):
        make_sharded_cg(from_csr(A, torch.float64, "dia", device=CPU),
                        torch.from_numpy(b), mesh8, two_stage=True)


def test_halo_widths_guarded(mesh8):
    """The JAX test_halo_widths_guarded case: fdm:96 shards (its ±96 halo
    under a 2048-row shard of the JAX package's 16384 padded rows); a
    matrix with a 4096 offset over 1024-row shards is refused."""
    S = shard_dia(from_csr(bt.generators.fdm_2d(96), torch.float64, "dia",
                           device=CPU), mesh8)
    assert S.npad == 16384
    n = 8192
    I = np.arange(n)
    coo = bt.MatrixCOO.from_arrays(
        np.concatenate([I, I[:-4096]]), np.concatenate([I, I[:-4096] + 4096]),
        np.ones(2 * n - 4096), n_rows=n, n_cols=n)
    from basic_iterative_solvers_tpu_torch.matrix import convert_coo_to_csr
    Aw = from_csr(convert_coo_to_csr(coo), torch.float64, "dia", device=CPU)
    with pytest.raises(ValueError, match=r"halo \(0,4096\) exceeds local "
                                         "shard length 1024"):
        shard_dia(Aw, mesh8)


def test_mesh_and_collectives():
    """make_mesh binds n shards to one device when asked, takes the cards
    otherwise and raises when there are too few (none here); ppermute
    sends slab k to shard k + shift with zeros off the mesh; psum adds in
    a fixed order; scatter and gather move a vector between one device and
    the shards; all are counted."""
    mesh = make_mesh(4, device=CPU)
    assert mesh.size == 4 and mesh.axis == "rows"
    assert set(mesh.devices) == {torch.device("cpu")}
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="requested 8 devices, only 0"):
            make_mesh(8)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(8, device="cuda")
    slabs = [torch.full((3,), float(k)) for k in range(4)]
    right = mesh.ppermute(slabs, 1)
    assert [float(s[0]) for s in right] == [0.0, 0.0, 1.0, 2.0]
    left = mesh.ppermute(slabs, -1)
    assert [float(s[0]) for s in left] == [1.0, 2.0, 3.0, 0.0]
    total = mesh.psum([torch.tensor([1.0, 2.0])] * 4)
    assert total.tolist() == [4.0, 8.0]
    v = mesh.scatter(torch.arange(10.0), 3)
    assert [tuple(s.tolist()) for s in v.shards] == [
        (0.0, 1.0, 2.0), (3.0, 4.0, 5.0), (6.0, 7.0, 8.0), (9.0,)]
    assert torch.equal(mesh.gather(v), torch.arange(10.0))
    assert mesh.counts == {"ppermute": 2, "ppermute_bytes": 2 * 3 * 3 * 4,
                           "psum": 1, "psum_bytes": 4 * 2 * 4,
                           "gather": 1, "gather_bytes": 40,
                           "scatter": 1, "scatter_bytes": 40}
    mesh.reset_counts()
    assert not any(mesh.counts.values())


def _cfg(method="CONJUGATE_GRADIENT", precond="NONE", **kw):
    kw = {"dtype": torch.float64, "tolerance": 1e-10, **kw}
    return bt.SolverConfig(method=bt.SolverType[method],
                           preconditioner=bt.PrecondType[precond], **kw)


def _stencil(spec="hpcg:8x8x8"):
    return bt.stencil_op.from_source_operator(spec, torch.float64,
                                              device=CPU)


def test_shard_setup_refusals(mesh8):
    """The JAX package's refusals, in its order and with its messages:
    rank-space blocks, level-scan trisolves (preconditioner, then the GS
    method's own), multigrid (`multigrid.*gspmd`, as its
    test_mesh_multigrid expects), greedy colour arrays on a stencil,
    mixed matrix families, a vector length the DIA shards do not divide;
    "auto" raises where the JAX package falls back to GSPMD, naming the
    refusal and the DeviceMesh its GSPMD mode needs."""
    dev = lambda A, cfg: bt.preprocessing_device(A, cfg)  # noqa: E731
    host = lambda spec, cfg, **kw: bt.preprocessing(  # noqa: E731
        bt.generators.from_source(spec), cfg, device=CPU, **kw)
    cases = [
        (host("band:61,2", _cfg(precond="SYMMETRIC_GAUSS_SEIDEL",
                                gs_mode="colored",
                                color_spec=bt.coloring.ColorSpec(
                                    "mod", 3, (3,)))),
         "rank-space blocked trisolves are not mesh-sharded"),
        (host("fdm:8", _cfg(precond="GAUSS_SEIDEL")),
         "level-scan trisolves have cross-shard recurrences"),
        (host("fdm:8", _cfg(method="GAUSS_SEIDEL")),
         "level-scan GS solver data has cross-shard recurrences"),
        (dev(_stencil(), _cfg(precond="MULTIGRID")), "multigrid.*gspmd"),
        (host("hpcg:8x8x8", _cfg(precond="SYMMETRIC_GAUSS_SEIDEL",
                                 gs_mode="colored"), A_dev=_stencil()),
         "greedy color arrays don't shard with spec kernels"),
        (host("hpcg:8x8x8", _cfg(precond="TWO_STAGE_GS",
                                 matrix_format="dia"), A_dev=_stencil()),
         "mixed matrix families in setup"),
        (dev(bt.dia.from_source_device("hpcg:7x3x3", torch.float64,
                                       device=CPU), _cfg()),
         "vector length 63 not divisible by 8 devices"),
    ]
    for setup, msg in cases:
        with pytest.raises(ValueError, match="shard_map mode unavailable: "
                                             + msg):
            shard_setup(setup, mesh8, mode="shard_map")
        with pytest.raises(ValueError, match=msg + ".*falls back to its "
                           "GSPMD mode.*needs a torch.distributed "
                           "DeviceMesh"):
            shard_setup(setup, mesh8)
    with pytest.raises(ValueError, match="unknown shard_setup mode"):
        shard_setup(cases[0][0], mesh8, mode="spmd")


def test_shard_setup_refuses_what_later_slices_port(mesh8):
    """Superblock L/U blocks now shard (slice 8b): the preconditioner's
    (CG + SGS on a stencil, CG + ILU(0) from host CSR with the stencil
    injected) are cut into the mesh's shards, the GS method's stay whole,
    as in the JAX package.  The port's own refusals remain: the GSPMD
    mode on this single-controller Mesh (it needs a DeviceMesh, one process
    a shard); a setup on a device the mesh does not hold.  A Mesh over
    several devices is accepted, each shard's vectors and operator data on
    its own device."""
    from basic_iterative_solvers_tpu_torch.ops.block_trisolve import (
        MeshSuperBlockTriSolve, SuperBlockTriSolve)
    A = _stencil()
    for setup in (
            bt.preprocessing_device(A, _cfg(precond="SYMMETRIC_GAUSS_SEIDEL")),
            bt.preprocessing_device(A, _cfg(method="SYMMETRIC_GAUSS_SEIDEL")),
            bt.preprocessing(bt.generators.from_source("hpcg:8x8x8"), _cfg(
                precond="ILU0", gs_mode="colored",
                color_spec=bt.generators.color_spec_for_source("hpcg:8x8x8")),
                A_dev=A, device=CPU)):
        assert any(B is not None for B in (setup.M.L_block, setup.gs_L_block))
        s8 = shard_setup(setup, mesh8, mode="shard_map")
        assert isinstance(s8.A, tmo.MeshStencil)
        for B, B8 in ((setup.M.L_block, s8.M.L_block),
                      (setup.M.U_block, s8.M.U_block)):
            assert B8 is None if B is None else (
                isinstance(B8, MeshSuperBlockTriSolve) and B8.inner is B
                and B8.n_devices == 8)
        assert s8.gs_L_block is setup.gs_L_block
        assert s8.gs_U_block is setup.gs_U_block
        assert setup.gs_L_block is None or isinstance(setup.gs_L_block,
                                                      SuperBlockTriSolve)
    setup = bt.preprocessing_device(A, _cfg())
    with pytest.raises(ValueError, match="gspmd mode needs a "
                       "torch.distributed DeviceMesh"):
        shard_setup(setup, mesh8, mode="gspmd")
    s2 = shard_setup(setup, Mesh(["cpu", "meta"]), mode="shard_map")
    devs = [torch.device("cpu"), torch.device("meta")]
    for v in (s2.b, s2.x0, s2.A_D):
        assert [t.device for t in v.shards] == devs
    assert [op.coeffs.device for op in s2.A.ops] == devs
    with pytest.raises(ValueError, match="the setup lies on cpu"):
        shard_setup(setup, Mesh(["meta"] * 8), mode="shard_map")
    assert isinstance(shard_setup(setup, mesh8).A, tmo.MeshStencil)


def test_mesh_hooks(mesh8):
    """The hooks of the JAX package's mesh path: multigrid refuses a
    stencil laid out for shards, the splits keep the parent's shards,
    fused-mode GMRES on a mesh operator runs fused (the basis kernels on
    each shard's columns; the JAX package warns and runs lowsync), the
    float64 oracle is the mesh operator around the float64 stencil, the
    colour ids a MeshVector of the operator's layout."""
    import dataclasses
    A8 = dataclasses.replace(_stencil(), shards=8)
    with pytest.raises(ValueError, match="not yet mesh-shardable"):
        bt.mg.build_mg_hierarchy(A8, _cfg(precond="MULTIGRID"))
    L, U, _, _ = bt.stencil_op.stencil_split(A8)
    assert L.shards == U.shards == 8
    cfg = _cfg(method="GMRES", restart_length=10, orthog_mode="fused",
               dtype=torch.float32, tolerance=1e-5)
    s8 = shard_setup(bt.preprocessing_device(
        bt.stencil_op.from_source_operator("hpcg:8x8x8", torch.float32,
                                           device=CPU), cfg), mesh8)
    from basic_iterative_solvers_tpu_torch.solvers.gmres import GMRESMethod
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        method = GMRESMethod(s8)
    assert method.orthog == "fused"
    assert not any("fused" in str(x.message) for x in w)
    from basic_iterative_solvers_tpu_torch.solvers.base import _f64_operands
    A64, _ = _f64_operands(s8)
    assert isinstance(A64, tmo.MeshStencil) and A64.rows == s8.A.rows
    assert A64.inner.dtype == torch.float64
    ids = bt.coloring.color_ids(bt.coloring.spec_for_device(s8.A.inner),
                                s8.A)
    assert ids.shape == (512,) and ids.blocks == s8.b.blocks
