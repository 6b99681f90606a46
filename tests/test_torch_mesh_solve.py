"""Whole solves on the port's 8-shard mesh (`shard_setup(mode=
"shard_map")` on `make_mesh(8, device="cpu")`) against the JAX package,
float64, the stencil and DIA cases of tests/test_mesh_pallas.py (its
lane-ELL cases are in test_torch_mesh_lane_ell.py) with its `_check` rule:
equal `converged` and `iter_count`, x* within rtol 1e-8, atol 1e-10.
The cases the JAX file runs in its default lane are held against the JAX
package's own shard_map mode (8 virtual devices, Pallas in interpret
mode); those it marks slow against the JAX package's single-device solve,
which its slow tests show equal to its mesh solve.
"""
import numpy as np
import pytest
import torch

import basic_iterative_solvers_tpu as bis
from basic_iterative_solvers_tpu.ops import pallas_env
from basic_iterative_solvers_tpu.parallel import make_mesh as jmake_mesh
from basic_iterative_solvers_tpu.parallel import shard_setup as jshard_setup

import basic_iterative_solvers_tpu_torch as bt
from basic_iterative_solvers_tpu_torch.parallel import (make_mesh,
                                                        mesh_census,
                                                        shard_setup)
from basic_iterative_solvers_tpu_torch.parallel import mesh_ops as tmo
from basic_iterative_solvers_tpu_torch.parallel.mesh_vector import MeshVector

CPU = "cpu"


@pytest.fixture
def interpret():
    pallas_env.INTERPRET = True
    try:
        yield
    finally:
        pallas_env.INTERPRET = False


def _cfgs(method, precond, **kw):
    """(JAX config, port config): float64, tolerance 1e-11, fused."""
    kw.setdefault("harness", "fused")
    cj = bis.SolverConfig(method=bis.SolverType[method],
                          preconditioner=bis.PrecondType[precond],
                          dtype=np.float64, tolerance=1e-11, **kw)
    ct = bt.SolverConfig(method=bt.SolverType[method],
                         preconditioner=bt.PrecondType[precond],
                         dtype=torch.float64, tolerance=1e-11, **kw)
    return cj, ct


def mesh_x(x):
    """A mesh solve's x as one tensor (Mesh.gather), after checking that it
    came back as a MeshVector with each shard on its device of the mesh."""
    assert isinstance(x, MeshVector)
    assert [s.device for s in x.shards] == list(x.mesh.devices)
    return x.mesh.gather(x)


def no_gathers(s8):
    """The mesh census of a few fused iterations of s8: no vector gathered
    or scattered whole, in the loop or out of it."""
    c = mesh_census(s8)
    assert c["in_while"]["all-gather"] == 0 and c["full_gathers"] == [], c
    assert c["in_while"]["scatter"] == 0, c
    assert c["in_while"]["all-reduce"] >= 1, c


def _check(res8, res1):
    assert res8.converged == res1.converged
    assert res8.iter_count == res1.iter_count
    np.testing.assert_allclose(np.asarray(mesh_x(res8.x_star)), np.asarray(
        res1.x_star), rtol=1e-8, atol=1e-10)


def _stencil_setups(ct, spec="hpcg:8x8x8"):
    A = bt.stencil_op.from_source_operator(spec, torch.float64, device=CPU)
    return shard_setup(bt.preprocessing_device(A, ct),
                       make_mesh(8, device=CPU), mode="shard_map")


def test_mesh_stencil_cg_jacobi(interpret):
    """Stencil CG + Jacobi through the shard-local #1 with the fused dot
    summed by psum, against the JAX package's mesh solve."""
    cj, ct = _cfgs("CONJUGATE_GRADIENT", "JACOBI", planar_vectors="on")
    Aj = bis.stencil_op.stencil_27pt_operator(8, 8, 8, dtype=np.float64)
    rj = bis.solve(jshard_setup(bis.preprocessing_device(Aj, cj),
                                jmake_mesh(8), mode="shard_map"))
    s8 = _stencil_setups(ct)
    assert isinstance(s8.A, tmo.MeshStencil) and s8.A.inner.shards == 8
    _check(bt.solve(s8), rj)
    no_gathers(s8)


def test_mesh_dia_cg(interpret):
    """DIA CG + Jacobi through the shard-local #4, each shard holding its
    own data rows, against the JAX package's mesh solve."""
    cj, ct = _cfgs("CONJUGATE_GRADIENT", "JACOBI")
    rj = bis.solve(jshard_setup(bis.preprocessing_device(
        bis.dia.stencil_27pt_device(8, 8, 8, dtype=np.float64), cj),
        jmake_mesh(8), mode="shard_map"))
    A = bt.dia.stencil_27pt_device(8, 8, 8, dtype=torch.float64, device=CPU)
    s8 = shard_setup(bt.preprocessing_device(A, ct), make_mesh(8, device=CPU),
                     mode="shard_map")
    assert isinstance(s8.A, tmo.MeshDIA)
    assert [d.shape[1] for d in s8.A.data_shards] == [s8.A.rows] * 8
    _check(bt.solve(s8), rj)
    no_gathers(s8)


# the JAX file's slow cases: the port's mesh against the JAX package's
# single-device solve

STENCIL_CASES = {
    "colored_sgs": ("CONJUGATE_GRADIENT", "SYMMETRIC_GAUSS_SEIDEL",
                    dict(planar_vectors="on")),
    "two_stage_bicgstab": ("BICGSTAB", "SYMMETRIC_TWO_STAGE_GS",
                           dict(planar_vectors="on", precond_inner_iters=2)),
    "gmres_restarts": ("GMRES", "JACOBI",
                       dict(planar_vectors="on", restart_length=12,
                            orthog_mode="lowsync")),
    "pipelined_cg": ("CONJUGATE_GRADIENT", "JACOBI",
                     dict(planar_vectors="on", cg_flavor="pipelined")),
}


@pytest.mark.parametrize("case", sorted(STENCIL_CASES))
def test_mesh_stencil_solves_match_jax(case):
    """CG + exact coloured SGS (masked sweeps through the shard-local #3,
    supersteps with one exchange), BiCGSTAB + symmetric two-stage (the
    strict-part stencils mesh-wrapped), GMRES(12) with restarts and
    pipelined CG on the HPCG 8x8x8 mesh."""
    method, precond, kw = STENCIL_CASES[case]
    cj, ct = _cfgs(method, precond, **kw)
    r1 = bis.solve(bis.preprocessing_device(
        bis.stencil_op.stencil_27pt_operator(8, 8, 8, dtype=np.float64), cj))
    s8 = _stencil_setups(ct)
    if case == "colored_sgs":
        assert r1.converged
        assert s8.M.n_colors == 8
        assert isinstance(s8.M.A_full_dev, tmo.MeshStencil)
    if case == "two_stage_bicgstab":
        assert isinstance(s8.M.L_strict_dev, tmo.MeshStencil)
        assert isinstance(s8.M.U_strict_dev, tmo.MeshStencil)
        assert s8.M.L_strict_dev.inner.shards == 8
    res8 = bt.solve(s8)
    if case == "gmres_restarts":
        assert r1.converged and r1.gmres_restart_count >= 1
        assert res8.gmres_restart_count == r1.gmres_restart_count
    _check(res8, r1)


def test_mesh_counts_per_cg_iteration():
    """The mesh's record of what it moves, this slice's stand-in for the
    JAX package's census invariants: a classic CG iteration on the mesh
    stencil issues one halo pair (its one SpMV) and two psums of 8 scalars
    (the fused p·Ap and ‖r‖), no exchange carries more than the halo, and
    no vector is gathered whole: the explicit float64 residual at the end
    runs on the mesh too (one more SpMV and psum, as r₀ takes)."""
    ct = bt.SolverConfig(dtype=torch.float64, harness="host", max_iters=7,
                         tolerance=0.0)
    s8 = _stencil_setups(ct, "hpcg:16x16x16")
    mesh = s8.A.mesh
    mesh.reset_counts()
    res = bt.solve(s8)
    n_spmv = 2 + res.iter_count          # r0, one an iteration, the last
    assert mesh.counts["ppermute"] == 2 * n_spmv
    assert mesh.counts["psum"] == 2 * res.iter_count + 2
    assert mesh.counts["psum_bytes"] == 8 * 8 * mesh.counts["psum"]
    assert mesh.counts["gather"] == mesh.counts["scatter"] == 0
    halo = s8.A.inner.window_halo[0]
    assert mesh.counts["ppermute_bytes"] == 2 * n_spmv * 7 * halo * 8
    assert halo < s8.A.n_rows // 8


def test_mesh_gs_method_on_fdm():
    """SGS as the method on fdm:16 (the masked colour sweeps, as on
    fdm:2048) against the JAX package's single-device solve."""
    cj, ct = _cfgs("SYMMETRIC_GAUSS_SEIDEL", "NONE")
    r1 = bis.solve(bis.preprocessing_device(
        bis.stencil_op.from_source_operator("fdm:16", dtype=np.float64), cj))
    s8 = _stencil_setups(ct, "fdm:16")
    assert s8.gs_L_block is None and s8.A.rows == 32
    _check(bt.solve(s8), r1)
