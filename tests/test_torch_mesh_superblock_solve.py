"""Whole solves on the port's 8-shard mesh with their superblock
preconditioners cut into the shards (`shard_setup(..., mode="shard_map")`
on `make_mesh(8, device="cpu")`: MeshSuperBlockTriSolve L and U blocks,
kernel #9's mesh form through its plain twin) against the JAX package's
single-device solve, its test_mesh_blocked_ilu0 rule: equal counts and
converged flags, x* within rtol 1e-8, atol 1e-10, float64; and the
mesh's record of what an iteration moves.
"""
import dataclasses

import numpy as np
import pytest
import torch

import basic_iterative_solvers_tpu as bis

import basic_iterative_solvers_tpu_torch as bt
from basic_iterative_solvers_tpu_torch.ops import block_trisolve as bk
from basic_iterative_solvers_tpu_torch.parallel import make_mesh, shard_setup
from tests.test_torch_mesh_solve import no_gathers
from tests.test_torch_mesh_superblock import _cfgs, _check, _mode

CPU = "cpu"
ANDERSON = "anderson:Lx=8,Ly=8,Lz=4,t=0.05,ranpot=16.0,seed=1"


def _colored(cfg_cls, spec, **kw):
    """Colour keywords of the host route under the source's grid spec."""
    gen = bis.generators if cfg_cls is bis.SolverConfig else bt.generators
    return dict(gs_mode="colored",
                color_spec=gen.color_spec_for_source(spec), **kw)


SOLVE_CASES = {
    # CG + SGS on the stencil: the analytic const pair
    "cg_sgs_stencil": ("hpcg:8x8x8", "CONJUGATE_GRADIENT",
                       "SYMMETRIC_GAUSS_SEIDEL", "device", "const"),
    # CG + ILU(0) with the stencil injected: the factor-table pair
    "cg_ilu0_hpcg": ("hpcg:8x8x8", "CONJUGATE_GRADIENT", "ILU0", "stencil",
                     "table"),
    # BiCGSTAB + SGS on Anderson, the stencil injected: const, per-row D
    "bicgstab_sgs_anderson": (ANDERSON, "BICGSTAB", "SYMMETRIC_GAUSS_SEIDEL",
                              "stencil", "const"),
    # CG + ILU(0) from host CSR on fdm:16: L in plane mode
    "cg_ilu0_fdm_plane": ("fdm:16", "CONJUGATE_GRADIENT", "ILU0", "csr",
                          "plane"),
}


@pytest.mark.parametrize("case", sorted(SOLVE_CASES))
def test_mesh_superblock_solves_match_jax(case):
    """Whole f64 solves on the 8-shard mesh, L and U blocks cut into the
    shards (MeshSuperBlockTriSolve), against the JAX package's
    single-device solve of the same setup."""
    spec, method, precond, route, mode = SOLVE_CASES[case]
    cj, ct = _cfgs(method, precond)
    if route == "device":
        r1 = bis.solve(bis.preprocessing_device(
            bis.stencil_op.from_source_operator(spec, dtype=np.float64), cj))
        s1 = bt.preprocessing_device(bt.stencil_op.from_source_operator(
            spec, torch.float64, device=CPU), ct)
    else:
        cj = dataclasses.replace(cj, **_colored(bis.SolverConfig, spec))
        ct = dataclasses.replace(ct, **_colored(bt.SolverConfig, spec))
        inject = route == "stencil"
        r1 = bis.solve(bis.preprocessing(
            bis.generators.from_source(spec), cj,
            A_dev=(bis.stencil_op.from_source_operator(spec, np.float64)
                   if inject else None)))
        s1 = bt.preprocessing(
            bt.generators.from_source(spec), ct, device=CPU,
            A_dev=(bt.stencil_op.from_source_operator(spec, torch.float64,
                                                      device=CPU)
                   if inject else None))
    mesh = make_mesh(8, device=CPU)
    s8 = shard_setup(s1, mesh, mode="shard_map")
    L8 = s8.M.L_block
    assert isinstance(L8, bk.MeshSuperBlockTriSolve)
    assert isinstance(s8.M.U_block, bk.MeshSuperBlockTriSolve)
    assert _mode(L8.inner) == mode and L8.n_devices == 8
    if mode == "plane":
        assert [Bs.vals_cross[-1].shape[1] for Bs in L8.shards] == [
            (l1 - l0) * 16 for l0, l1 in (Bs.lines[-1] for Bs in L8.shards)]
    mesh.reset_counts()
    res8 = bt.solve(s8)
    assert mesh.counts["ppermute"] > 0
    _check(res8, r1)
    no_gathers(s8)


def test_mesh_exchanges_per_iteration():
    """What a CG + SGS iteration moves on the 8-shard mesh (hpcg:16x16x16,
    two z-planes a shard, host harness): one halo pair for the SpMV and
    one a level of each triangle (2·(1 + 2·4) ppermute calls); the
    triangles' pairs carry only the level's superblock lines inside the
    halo rows, a quarter of a halo slab, never a whole vector, and no
    vector is gathered whole.  The explicit float64 residual at the end
    is one more mesh SpMV."""
    ct = bt.SolverConfig(method=bt.SolverType.CONJUGATE_GRADIENT,
                         preconditioner=bt.PrecondType.SYMMETRIC_GAUSS_SEIDEL,
                         dtype=torch.float64, harness="host", max_iters=3,
                         tolerance=0.0)
    s8 = shard_setup(bt.preprocessing_device(
        bt.stencil_op.from_source_operator("hpcg:16x16x16", torch.float64,
                                           device=CPU), ct),
        make_mesh(8, device=CPU), mode="shard_map")
    L8 = s8.M.L_block
    assert (L8.rows, L8.halo) == (512, 16 * 17)
    mesh = s8.A.mesh
    mesh.reset_counts()
    res = bt.solve(s8)
    applies = 1 + res.iter_count
    n_spmv = applies + 1
    levels = 2 * len(L8.inner.levels)
    assert mesh.counts["gather"] == mesh.counts["scatter"] == 0
    assert mesh.counts["ppermute"] == 2 * (n_spmv + levels * applies)
    spmv_bytes = 2 * n_spmv * 7 * s8.A.inner.window_halo[0] * 8
    sent = mesh.counts["ppermute_bytes"] - spmv_bytes
    # per level a shard sends its superblock's lines among 17 halo lines a
    # side: 8 or 9 of them (one plane's worth of y-phase, one line)
    assert 0 < sent <= 2 * 7 * 9 * 16 * 8 * levels * applies
    assert sent < 2 * 7 * L8.halo * 8 * levels * applies / 2


@pytest.mark.parametrize("method,precond", [
    ("CONJUGATE_GRADIENT", "SYMMETRIC_GAUSS_SEIDEL"),
    ("CONJUGATE_GRADIENT", "ILU0"),
    ("SYMMETRIC_GAUSS_SEIDEL", "NONE")])
def test_traffic_estimate_on_the_mesh(method, precond):
    """The report's traffic estimate of a mesh setup, its blocks cut into
    the shards (the preconditioner's) or whole (the SGS method's), is the
    single-device setup's, as the JAX package's estimate unwraps a mesh
    block to its inner solve; the one-launch switch counts as there."""
    from basic_iterative_solvers_tpu_torch.precond import (
        estimated_precond_passes)
    from basic_iterative_solvers_tpu_torch.utils.report import (
        iteration_traffic_bytes)
    _cj, ct = _cfgs(method, precond)
    s1 = bt.preprocessing_device(bt.stencil_op.from_source_operator(
        "hpcg:8x8x8", torch.float64, device=CPU), ct)
    s8 = shard_setup(s1, make_mesh(8, device=CPU), mode="shard_map")
    assert iteration_traffic_bytes(s8) == iteration_traffic_bytes(s1) > 0
    if s8.M.L_block is not None:
        assert isinstance(s8.M.L_block, bk.MeshSuperBlockTriSolve)
        old = bk.MEGA
        try:
            for bk.MEGA in (False, True):
                assert (estimated_precond_passes(s8.M)
                        == estimated_precond_passes(s1.M))
        finally:
            bk.MEGA = old

