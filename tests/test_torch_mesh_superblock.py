"""The port's mesh-sharded superblock solves (ops/block_trisolve.py:
`shard_superblock`, `super_level_halo`, `_solve_super_mesh`; the
`_mesh_blocks` step of parallel/sharded.py) against the JAX package on the
same inputs, made from a seed with numpy:

* each shard's plain twin (`super_level_halo_plain`, kernel #9's mesh
  form) bit-equal to the single-device `super_level_plain` on the rows it
  owns, every level of L and U, const, factor-table and plane mode, f32
  and f64, on hpcg:8x8x8 (8 shards, four of them inert), hpcg:16x12x8 (4
  shards) and fdm:16 (8 shards of two x-lines);
* the port's `_solve_super_mesh` against the JAX package's, which runs
  its Pallas level kernel in interpret mode on 4 of the 8 virtual devices;
* the SGS method, whose superblock solves stay whole on the mesh, against
  the JAX package's shard_map solve;
* accept or refuse, case by case, as the JAX package's shard_superblock
  (its packed layout, TPU tile geometry, the port shards).
The whole preconditioned solves on the mesh are in
test_torch_mesh_superblock_solve.py.
"""
import dataclasses

import numpy as np
import pytest
import torch

import basic_iterative_solvers_tpu as bis
import basic_iterative_solvers_tpu.coloring  # noqa: F401 (bis.coloring)
from basic_iterative_solvers_tpu.ops import block_trisolve as jbk
from basic_iterative_solvers_tpu.ops import pallas_env
from basic_iterative_solvers_tpu.parallel import make_mesh as jmake_mesh
from basic_iterative_solvers_tpu.parallel import shard_setup as jshard_setup

import basic_iterative_solvers_tpu_torch as bt
from basic_iterative_solvers_tpu_torch.coloring import spec_for_device
from basic_iterative_solvers_tpu_torch.ops import block_trisolve as bk
from basic_iterative_solvers_tpu_torch.parallel import make_mesh, shard_setup
from basic_iterative_solvers_tpu_torch.parallel import mesh_census
from tests.test_torch_mesh_solve import mesh_x

CPU = "cpu"


@pytest.fixture
def interpret():
    pallas_env.INTERPRET = True
    try:
        yield
    finally:
        pallas_env.INTERPRET = False


def _host_pair(spec, dtype, precond, A_dev=None):
    """(L, U) of the coloured host route under the source's grid spec."""
    cfg = bt.SolverConfig(
        preconditioner=bt.PrecondType[precond], dtype=dtype,
        gs_mode="colored", color_spec=bt.generators.color_spec_for_source(
            spec))
    M = bt.preprocessing(bt.generators.from_source(spec), cfg, A_dev=A_dev,
                         device=CPU).M
    return M.L_block, M.U_block


def _pair(spec, mode, dtype):
    """The (L, U) pair of `mode`: const (the analytic GS pair of a stencil,
    or the SGS pair from host CSR, const detected with its per-row D),
    table (the translation-table ILU(0) pair) or plane (ILU(0) from host
    CSR: L in plane mode)."""
    if spec.startswith("hpcg") and mode != "plane":
        A = bt.stencil_op.from_source_operator(spec, dtype, device=CPU)
        if mode == "const":
            return bk.build_superblock_gs_pair_stencil(
                A, spec_for_device(A), dtype=dtype, need_d=True)
        return bk.build_superblock_ilu0_pair_stencil(A, spec_for_device(A),
                                                     dtype=dtype)
    return _host_pair(spec, dtype, "ILU0" if mode == "plane"
                      else "SYMMETRIC_GAUSS_SEIDEL")


def _mode(B):
    return "table" if B.is_table else "plane" if B.is_plane else "const"


TWIN_CASES = [("hpcg:8x8x8", 8, "const"), ("hpcg:8x8x8", 8, "table"),
              ("hpcg:8x8x8", 8, "plane"), ("hpcg:16x12x8", 4, "const"),
              ("hpcg:16x12x8", 4, "table"), ("hpcg:16x12x8", 4, "plane"),
              ("fdm:16", 8, "const"), ("fdm:16", 8, "plane")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("spec,n_dev,mode", TWIN_CASES)
def test_shard_twin_bit_equal_to_single_level(spec, n_dev, mode, dtype):
    """Every shard's plain twin on its own rows of y and its window of x
    (random, so every source superblock holds values) writes exactly what
    the single-device super_level_plain writes on those rows, and nothing
    else of its window; a shard owning none of a level's lines (the inert
    shards of hpcg:8x8x8) leaves it as it was.  The whole mesh solve, with
    its exchanges (on fdm:16 a shard boundary falls between two lines of
    one superblock), is bit-equal to the single-device solve."""
    L, U = _pair(spec, mode, dtype)
    assert _mode(L) == mode
    mesh = make_mesh(n_dev, device=CPU)
    g = np.random.default_rng(7)
    for B in (L, U):
        MB = bk.shard_superblock(B, mesh)
        n, R, H = B.n_rows, MB.rows, MB.halo
        assert R % B.spec_params[0] == 0 and 0 < H <= R
        pad = n_dev * R - n
        for li in range(len(B.levels)):
            y = torch.from_numpy(g.standard_normal(n)).to(dtype)
            x = torch.from_numpy(g.standard_normal(n)).to(dtype)
            ref = torch.nn.functional.pad(
                bk.super_level_plain(B, li, y, x.clone()), (0, pad))
            xw = torch.nn.functional.pad(x, (H, pad + H))
            yw = torch.nn.functional.pad(y, (0, pad))
            for k, Bs in enumerate(MB.shards):
                win = xw[k * R:(k + 1) * R + 2 * H].clone()
                before = win.clone()
                bk.super_level_halo(Bs, li, yw[k * R:(k + 1) * R].clone(),
                                    win)
                assert torch.equal(win[H:H + R], ref[k * R:(k + 1) * R])
                assert torch.equal(win[:H], before[:H])
                assert torch.equal(win[H + R:], before[H + R:])
        # the whole solve, each level's lines passed to the neighbours'
        # windows, bit-equal to the single-device solve
        y = torch.from_numpy(g.standard_normal(n)).to(dtype)
        assert torch.equal(mesh_x(bk._solve_super_mesh(
            MB, mesh.scatter(y, MB.rows))),
            bk._solve_super(B, y, torch.empty_like(y)))
    if spec == "hpcg:8x8x8" and mode != "plane":
        # a 72-row halo over 64-row planes: two planes a shard
        assert MB.rows == 128 and sum(1 for Bs in MB.shards
                                      if Bs.row0 >= n) == 4


def test_mesh_solve_matches_jax_mesh_solve(interpret):
    """The JAX test_const_mode_mesh_sharded case: the const L solve of
    hpcg:8x8x8 (from host CSR, f32) on 4 shards, the port's
    _solve_super_mesh against the JAX package's (its Pallas level kernel
    in interpret mode on 4 virtual devices) within rtol 1e-6, and both
    against the single-device solve; one halo pair a level."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JMesh
    spec = "hpcg:8x8x8"
    Aj = bis.generators.from_source(spec)
    cs = bis.generators.color_spec_for_source(spec)
    rows = np.repeat(np.arange(Aj.n_rows), Aj.row_nnz())
    D = np.zeros(Aj.n_rows)
    D[rows[Aj.col == rows]] = Aj.val[Aj.col == rows]
    Lj, _Uj = jbk.build_superblock_gs_pair_from_csr(Aj, D, cs,
                                                    dtype=np.float32,
                                                    need_d=True)
    assert Lj.is_const
    y = np.random.default_rng(3).standard_normal(Aj.n_rows).astype(
        np.float32)
    MLj = jbk.shard_superblock(Lj, JMesh(np.array(jax.devices()[:4]),
                                         ("rows",)), "rows")
    xj = np.asarray(jbk._unpermute_super(MLj.inner, jbk._solve_super_mesh(
        MLj, jbk._permute_super(MLj.inner, jnp.asarray(y)))))
    L, _U = _host_pair(spec, torch.float32, "SYMMETRIC_GAUSS_SEIDEL")
    assert L.is_const and L.dinv_rows is not None
    mesh = make_mesh(4, device=CPU)
    ML = bk.shard_superblock(L, mesh)
    y8 = mesh.scatter(torch.from_numpy(y), ML.rows)
    mesh.reset_counts()
    x = mesh_x(bk.blocked_trisolve(ML, y8))
    assert mesh.counts["ppermute"] == 2 * len(L.levels)
    np.testing.assert_allclose(x.numpy(), xj, rtol=1e-6, atol=1e-6)
    assert torch.equal(x, bk.blocked_trisolve(L, torch.from_numpy(y)))


def _cfgs(method, precond, **kw):
    """(JAX config, port config): float64, tolerance 1e-10, fused."""
    kw = {"harness": "fused", "tolerance": 1e-10, **kw}
    cj = bis.SolverConfig(method=bis.SolverType[method],
                          preconditioner=bis.PrecondType[precond],
                          dtype=np.float64, **kw)
    ct = bt.SolverConfig(method=bt.SolverType[method],
                         preconditioner=bt.PrecondType[precond],
                         dtype=torch.float64, **kw)
    return cj, ct


def _check(res8, res1):
    assert res8.converged == res1.converged
    assert res8.iter_count == res1.iter_count
    np.testing.assert_allclose(np.asarray(mesh_x(res8.x_star)), np.asarray(
        res1.x_star), rtol=1e-8, atol=1e-10)


def test_gs_method_keeps_whole_blocks_as_jax(interpret):
    """SGS as the method on the hpcg:8x8x8 stencil: its superblock solves
    (gs_L_block, gs_U_block) stay whole on the mesh, as in the JAX
    package, whose shard_map solve of the same setup it matches: each
    apply gathers the residual to one device and scatters the update back
    (one whole-vector gather an iteration in the mesh census)."""
    cj, ct = _cfgs("SYMMETRIC_GAUSS_SEIDEL", "NONE", tolerance=1e-8)
    spec = "hpcg:8x8x8"
    rj = bis.solve(jshard_setup(bis.preprocessing_device(
        bis.stencil_op.from_source_operator(spec, dtype=np.float64), cj),
        jmake_mesh(8), mode="shard_map"))
    s8 = shard_setup(bt.preprocessing_device(
        bt.stencil_op.from_source_operator(spec, torch.float64, device=CPU),
        ct), make_mesh(8, device=CPU), mode="shard_map")
    assert isinstance(s8.gs_L_block, bk.SuperBlockTriSolve)
    assert isinstance(s8.gs_U_block, bk.SuperBlockTriSolve)
    assert s8.M.L_block is None
    _check(bt.solve(s8), rj)
    mesh = s8.b.mesh
    mesh.reset_counts()
    c = mesh_census(s8)
    assert c["in_while"]["all-gather"] == c["in_while"]["scatter"] == 1, c
    assert {w for _k, w, _e in c["full_gathers"]} == {"while"}
    assert {k for k, _w, _e in c["full_gathers"]} == {"all-gather",
                                                      "scatter"}
    assert mesh.counts["gather"] == mesh.counts["scatter"] >= 3


def _refusal_pair(pkg, case):
    """One triangle of `case` built by the JAX package (pkg "jax") or the
    port, and the spec it was built for."""
    spec = {"nx_not_dividing_128": "hpcg:12x4x4", "split": "hpcg:12x4x4",
            "packed": "hpcg:128x4x4", "const_fused": "hpcg:16x4x4",
            "rank_space": "band:61,2"}[case]
    if case == "rank_space":
        cs = bt.coloring.ColorSpec("mod", 3, (3,))
        if pkg == "jax":
            A = bis.generators.from_source(spec)
            jcs = bis.coloring.ColorSpec("mod", 3, (3,))
            return jbk.build_blocked_trisolve(
                A, None, jbk.spec_colors_np(jcs, A.n_rows), jcs,
                upper=False)
        A = bt.generators.from_source(spec)
        return bk.build_blocked_trisolve(
            A, None, bt.coloring.spec_colors_np(cs, A.n_rows), cs,
            upper=False, device=CPU)
    if pkg == "jax":
        op = bis.stencil_op.from_source_operator(spec, dtype=np.float32)
        cs = bis.coloring.spec_for_device(op)
        if case == "const_fused":
            return jbk.build_superblock_gs_pair_stencil(op, cs)[0]
        return jbk.build_superblock_ilu0_pair_stencil(op, cs,
                                                      dtype=np.float32)[1]
    return _pair(spec, "const" if case == "const_fused" else "table",
                 torch.float32)[1 if case != "const_fused" else 0]


#: case → the JAX package's shard_superblock refusal (None: it shards)
REFUSALS = {"nx_not_dividing_128": None, "const_fused": None,
            "split": "split-mode superblock solves are not mesh-sharded",
            "packed": "packed-table superblock solves are not mesh-sharded",
            "rank_space": "only superblock trisolves shard"}
#: the cases the port shards where the JAX package refuses: its packed
#: layout is TPU tile geometry the port does not have
PORT_SHARDS = {"packed"}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_shard_superblock_refusals_match_jax(case, monkeypatch):
    """Accept or refuse as the JAX package's shard_superblock, with its
    message, on 8 shards: an nx that does not divide 128 (aligned-fused,
    accepted), a const pair (accepted), the split route under
    BIS_SB_ALIGNED=0 (both modules' switch set) and a rank-space solve
    (refused).  The JAX package's packed layout (PACK_MIN_ROWS lowered to
    0 in its module) it refuses; the port, whose factor-table kernel has
    no packed layout, shards that pair, and its mesh solve is bit-equal
    to its single-device solve."""
    import jax
    from jax.sharding import Mesh as JMesh
    if case == "split":
        monkeypatch.setattr(jbk, "NO_ALIGNED", True)
        monkeypatch.setattr(bk, "NO_ALIGNED", True)
    if case == "packed":
        monkeypatch.setattr(jbk, "PACK_MIN_ROWS", 0)
    msg = REFUSALS[case]
    Bj, B = _refusal_pair("jax", case), _refusal_pair("port", case)
    jmesh = JMesh(np.array(jax.devices()), ("rows",))
    mesh = make_mesh(8, device=CPU)
    if case == "packed":
        assert Bj.is_packed
    if case != "rank_space":
        assert B.fused == Bj.fused
    if msg is None:
        jbk.shard_superblock(Bj, jmesh, "rows")
    else:
        with pytest.raises(jbk.BlockIneligibleError, match=msg):
            jbk.shard_superblock(Bj, jmesh, "rows")
    if msg is None or case in PORT_SHARDS:
        MB = bk.shard_superblock(B, mesh)
        assert len(MB.shards) == 8
        y = torch.from_numpy(np.random.default_rng(5).standard_normal(
            B.n_rows)).to(B.dtype)
        assert torch.equal(mesh_x(bk._solve_super_mesh(
            MB, mesh.scatter(y, MB.rows))),
            bk._solve_super(B, y, torch.empty_like(y)))
        return
    with pytest.raises(bk.BlockIneligibleError, match=msg):
        bk.shard_superblock(B, mesh, "rows")


def test_pcg_ilu0_384_shards_on_the_mesh():
    """The bench's pcg_ilu0@384 pair (f32), which the JAX package builds
    packed and so keeps off its mesh, shards on the port's 8-shard mesh:
    48 z-planes a shard, a halo of one plane and one line (the pair holds
    no planes, so the cut copies nothing)."""
    A = bt.stencil_op.from_source_operator("hpcg:384x384x384",
                                           torch.float32, device=CPU)
    for B in bk.build_superblock_ilu0_pair_stencil(A, spec_for_device(A)):
        assert B.is_table and B.fused
        MB = bk.shard_superblock(B, make_mesh(8, device=CPU))
        assert (MB.rows, MB.halo) == (48 * 384 * 384, 385 * 384)
        assert [Bs.row0 for Bs in MB.shards] == [k * MB.rows
                                                 for k in range(8)]
