"""Whole solves on the port's 8-shard mesh against the JAX package:
the lane-ELL cases of tests/test_mesh_pallas.py (general sparsity through
the shard-local #5), float64, with its `_check` rule, as in
test_torch_mesh_solve.py: its default-lane case against the JAX package's
shard_map mode, its slow cases against the JAX package's single-device
solve.  The JAX side's host code runs its NumPy branch (`numpy_branch`).
"""
import pytest
import torch

import basic_iterative_solvers_tpu as bis
from basic_iterative_solvers_tpu.parallel import make_mesh as jmake_mesh
from basic_iterative_solvers_tpu.parallel import shard_setup as jshard_setup

import basic_iterative_solvers_tpu_torch as bt
from basic_iterative_solvers_tpu_torch.parallel import make_mesh, shard_setup
from basic_iterative_solvers_tpu_torch.parallel import mesh_ops as tmo
from tests.test_torch_ilu0_factor import numpy_branch  # noqa: F401
from tests.test_torch_mesh_solve import (CPU, _cfgs, _check,  # noqa: F401
                                         no_gathers,
                                         interpret)


def _sband():
    return (bis.generators.scattered_band(2048, 6, 200, seed=3),
            bt.generators.scattered_band(2048, 6, 200, seed=3))


def test_mesh_lane_ell_cg_jacobi(interpret, numpy_branch):  # noqa: F811
    """Scattered-pattern CG + Jacobi through the shard-local #5 against
    the JAX package's mesh solve."""
    Aj, At = _sband()
    cj, ct = _cfgs("CONJUGATE_GRADIENT", "JACOBI", matrix_format="lane_ell")
    rj = bis.solve(jshard_setup(bis.preprocessing(Aj, cj), jmake_mesh(8),
                                mode="shard_map"))
    s8 = shard_setup(bt.preprocessing(At, ct, device=CPU),
                     make_mesh(8, device=CPU), mode="shard_map")
    assert isinstance(s8.A, tmo.MeshLaneELL)
    _check(bt.solve(s8), rj)
    no_gathers(s8)


LANE_CASES = {
    "two_stage_bicgstab": ("BICGSTAB", "TWO_STAGE_GS", {}),
    "chebyshev": ("CONJUGATE_GRADIENT", "CHEBYSHEV", {}),
    "greedy_sgs": ("SYMMETRIC_GAUSS_SEIDEL", "NONE",
                   dict(gs_mode="colored")),
    "greedy_pcg_sgs": ("CONJUGATE_GRADIENT", "SYMMETRIC_GAUSS_SEIDEL",
                       dict(gs_mode="colored")),
}


@pytest.mark.parametrize("case", sorted(LANE_CASES))
def test_mesh_lane_ell_solves_match_jax(case, numpy_branch):  # noqa: F811
    """BiCGSTAB + two-stage (the strict parts as mesh lane-ELL), CG +
    Chebyshev (the full operator mesh-wrapped), and exact greedy-coloured
    SGS as the method and as CG's preconditioner (the colour array a row
    vector like the others, each sweep step one mesh SpMV)."""
    method, precond, kw = LANE_CASES[case]
    Aj, At = _sband()
    cj, ct = _cfgs(method, precond, matrix_format="lane_ell", **kw)
    r1 = bis.solve(bis.preprocessing(Aj, cj))
    s8 = shard_setup(bt.preprocessing(At, ct, device=CPU),
                     make_mesh(8, device=CPU), mode="shard_map")
    assert isinstance(s8.A, tmo.MeshLaneELL)
    if case == "two_stage_bicgstab":
        assert isinstance(s8.M.L_strict_dev, tmo.MeshLaneELL)
    if case == "chebyshev":
        assert s8.M.A_full_dev is s8.A
    if case.startswith("greedy"):
        carr = s8.color_arr if precond == "NONE" else s8.M.color_arr
        assert carr is not None and carr.shape == (At.n_rows,)
    _check(bt.solve(s8), r1)


@pytest.mark.parametrize("spec", ["sband:2048,6,200", "sband:3000,8,1400"])
def test_shards_carry_counts_and_idx16(spec, rng):
    """Each shard's index plane is its window of the whole 16-bit one
    (the only index plane the shards hold), the inert extension rows count
    0, and a counted reading of each shard (rows [r0, r0 + rows) of
    row_len, indices from its 16-bit plane, from its x window) is
    bit-equal to lane_ell_spmv_halo_plain on that plane and on the int32
    one."""
    import numpy as np
    from basic_iterative_solvers_tpu_torch.ops import lane_ell as tle
    from basic_iterative_solvers_tpu_torch.parallel.sharded import (
        _halo_exchange, _split)
    M = tle.csr_to_lane_ell(bt.generators.from_source(spec), torch.float64,
                            device=CPU)
    mesh = make_mesh(8, device=CPU)
    W = tmo.wrap_lane_ell(M, mesh, "rows")
    E, R = W.inner, W.rows
    assert int(E.row_len[M.R:].sum()) == 0
    assert torch.equal(E.row_len[:M.R], M.row_len)
    x = torch.from_numpy(rng.standard_normal(M.n_rows))
    h = E.S * tle.LANES
    xp = torch.nn.functional.pad(x, (0, E.R * tle.LANES - M.n_rows))
    wins = _halo_exchange(mesh, _split(xp, 8), h, h)
    plane = E.R * tle.LANES
    for k in range(8):
        r0 = k * R
        assert W.idx_shards[k].dtype == torch.int16
        assert torch.equal(W.idx_shards[k], E.idx16[:, r0:r0 + R])
        p = W.idx_shards[k].long() & 0xFFFF
        lens = E.row_len[r0:r0 + R].long()
        r = (r0 + torch.arange(R)).view(R, 1)
        y = torch.zeros((R, tle.LANES), dtype=x.dtype)
        for s in range(E.K):
            flat = ((r + p[s] // tle.LANES - E.S) * tle.LANES
                    + p[s] % tle.LANES).clamp(0, plane - 1)
            xv = torch.where(flat < E.n_rows,
                             wins[k][flat - (r0 - E.S) * tle.LANES], 0.0)
            y = torch.where(s < lens, y + W.vals_shards[k][s] * xv, y)
        assert torch.equal(y.reshape(-1), tle.lane_ell_spmv_halo_plain(
            E, W.vals_shards[k], W.idx_shards[k], wins[k], r0, E.S))
        assert torch.equal(y.reshape(-1), tle.lane_ell_spmv_halo_plain(
            E, W.vals_shards[k], E.idx[:, r0:r0 + R].contiguous(), wins[k],
            r0, E.S))
    assert np.isclose(float(torch.cat([tle.lane_ell_spmv_halo_plain(
        E, W.vals_shards[k], W.idx_shards[k], wins[k], k * R, E.S)
        for k in range(8)])[:M.n_rows].sum()), float(
        tle.lane_ell_spmv_plain(M, x).sum()))


def test_shards_hold_int32_indices_past_16_bits():
    """An operator whose packed indices do not fit 16 bits has no 16-bit
    plane, and its shards hold the int32 one."""
    from basic_iterative_solvers_tpu_torch.ops import lane_ell as tle
    S = 256
    idx = torch.full((2, 64, tle.LANES), S * tle.LANES, dtype=torch.int32)
    M = tle.DeviceLaneELL(vals=torch.ones(2, 64, tle.LANES), idx=idx,
                          n_rows=64 * tle.LANES, n_cols=64 * tle.LANES, K=2,
                          S=S, R=64)
    assert M.idx16 is None
    W = tmo.wrap_lane_ell(M, make_mesh(8, device=CPU), "rows")
    assert all(t.dtype == torch.int32 for t in W.idx_shards)
    assert torch.equal(torch.cat(W.idx_shards, 1), W.inner.idx)


@pytest.mark.parametrize("entries,sms,route", [
    (256 * 256, 132, "padded"), (8 * 132 * 256, 132, "counted"),
    (8 * 132 * 256 - 1, 132, "counted"), (8 * 132 * 256 - 256, 132, "padded"),
    (500_096, 132, "counted"), (4 * 256, 1, "padded")])
def test_halo_route_by_the_launch_shape(entries, sms, route):
    """The shard launch stops each row at its count only where its blocks
    of 256 fill 8 an SM; a sband shard's launch (256 blocks) reads every
    slot."""
    from basic_iterative_solvers_tpu_torch.ops import lane_ell as tle
    assert tle.halo_route_for(entries, sms) == route
