"""The port's geometric multigrid (mg.py) against the JAX package's, piece
by piece: transfers, the Galerkin probe, the hierarchy, the refusals, the
level count and cost estimate, and the V-cycle on carried levels.  The
solves are in test_torch_mg_solve.py.

Inputs come from a seeded numpy generator and go to both packages.  The
JAX transfers are XLA einsums and the port's torch matmuls over the same
matrices: the ≤ 3 nonzero terms of a row are added in another order, so
results differ in the last bit (rtol 1e-14 for one transfer, 1e-12 for a
whole float64 V-cycle, 1e-5 in float32).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import basic_iterative_solvers_tpu as bis
from basic_iterative_solvers_tpu import mg as jmg

import basic_iterative_solvers_tpu_torch as bt
from basic_iterative_solvers_tpu_torch import convert
from basic_iterative_solvers_tpu_torch import mg as tmg

CPU = "cpu"
TORCH_DTYPE = {np.float64: torch.float64, np.float32: torch.float32}

FDIMS = [(9, 9, 9), (8, 10, 7), (16, 16, 1), (5, 1, 1)]


@pytest.mark.parametrize("transfer", ["linear", "injection"])
@pytest.mark.parametrize("fdims", FDIMS)
def test_transfers_match_jax(rng, transfer, fdims):
    """restrict_flat and prolong_flat equal the JAX package's (rtol 1e-14:
    the order of a row's ≤ 3 terms), and R = Pᵀ holds in the port."""
    cdims = tmg.coarse_dims(fdims)
    assert cdims == jmg.coarse_dims(fdims)
    nf, nc = int(np.prod(fdims)), int(np.prod(cdims))
    v, u = rng.standard_normal(nf), rng.standard_normal(nc)
    rt = tmg.restrict_flat(torch.from_numpy(v), fdims, cdims, transfer)
    pt = tmg.prolong_flat(torch.from_numpy(u), fdims, cdims, transfer)
    rj = jmg.restrict_flat(jnp.asarray(v), fdims, cdims, transfer)
    pj = jmg.prolong_flat(jnp.asarray(u), fdims, cdims, transfer)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-14,
                               atol=1e-14)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-14,
                               atol=1e-14)
    lhs, rhs = float(rt @ torch.from_numpy(u)), float(
        torch.from_numpy(v) @ pt)
    assert abs(lhs - rhs) < 1e-12 * max(1.0, abs(lhs))


def test_axis_transfer_matrix_matches_jax():
    for nf in (1, 5, 8, 9):
        nc = tmg.coarse_dims((nf, 1, 1))[0]
        for transfer in ("linear", "injection"):
            np.testing.assert_array_equal(
                tmg._axis_transfer_matrix(nf, nc, transfer),
                jmg._axis_transfer_matrix(nf, nc, transfer))


_STENCILS = {
    "hpcg": ([((dx, dy, dz), 26.0 if (dx, dy, dz) == (0, 0, 0) else -1.0)
              for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)],
             (16, 16, 16)),
    "fdm": ([((0, 0, 0), -4.0), ((-1, 0, 0), 1.0), ((1, 0, 0), 1.0),
             ((0, -1, 0), 1.0), ((0, 1, 0), 1.0)], (16, 16, 1)),
    "lap7": ([((0, 0, 0), 6.0)] + [(leg, -1.0) for leg in (
        (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1),
        (0, 0, -1))], (9, 8, 7)),
}


@pytest.mark.parametrize("transfer", ["linear", "injection"])
@pytest.mark.parametrize("name", sorted(_STENCILS))
def test_galerkin_coeffs_match_jax(name, transfer):
    """Same coarse legs (the 1e-12·max filter kept), values within 1e-15;
    HPCG's Galerkin level has 27 legs, #1's limit."""
    legs, dims = _STENCILS[name]
    got = tmg.galerkin_coarse_coeffs(legs, dims, transfer)
    ref = jmg.galerkin_coarse_coeffs(legs, dims, transfer)
    assert [leg for leg, _ in got] == [leg for leg, _ in ref]
    np.testing.assert_allclose([c for _, c in got], [c for _, c in ref],
                               rtol=0, atol=1e-15)
    if name == "hpcg" and transfer == "linear":
        assert len(got) == 27


def _hierarchies(spec, dtype=np.float64, **cfg):
    Aj = bis.stencil_op.from_source_operator(spec, dtype=dtype)
    At = bt.stencil_op.from_source_operator(spec, TORCH_DTYPE[dtype],
                                            device=CPU)
    lj = jmg.build_mg_hierarchy(Aj, bis.SolverConfig(dtype=dtype, **cfg))
    lt = tmg.build_mg_hierarchy(At, bt.SolverConfig(dtype=dtype, **cfg))
    return lj, lt


def _carry(levels_j, dtype):
    return convert.mg_levels_from_numpy(
        [(lev.A.legs, lev.A.coeff_values, lev.A.dims, np.asarray(lev.D_inv),
          np.asarray(lev.lmax)) for lev in levels_j],
        dtype=TORCH_DTYPE[dtype], device=CPU)


@pytest.mark.parametrize("spec,cfg", [
    ("hpcg:32x24x20", {}), ("fdm:64", {}), ("hpcg:16x16x16", {}),
    ("hpcg:16x16x16", {"mg_transfer": "injection"}),
    ("hpcg:16x16x16", {"mg_levels": 2, "mg_coarse_op": "rediscretize"}),
], ids=["hpcg32x24x20", "fdm64", "hpcg16", "injection", "two_levels"])
def test_hierarchy_matches_jax(spec, cfg):
    """Level dims, legs and coefficients, D⁻¹ and λmax equal."""
    lj, lt = _hierarchies(spec, **cfg)
    assert len(lt) == len(lj)
    for a, b in zip(lt, lj):
        assert a.A.dims == b.A.dims
        assert a.A.legs == b.A.legs
        np.testing.assert_array_equal(a.A.coeff_values,
                                      np.asarray(b.A.coeff_values))
        np.testing.assert_array_equal(
            a.D_inv.numpy(),
            convert.vector_from_numpy(np.asarray(b.D_inv), a.A).numpy())
        assert float(a.lmax) == float(b.lmax)


@pytest.mark.parametrize("case", ["anderson", "host_csr", "dia",
                                  "galerkin_injection", "transfer",
                                  "coarse_op", "levels"])
def test_refusals_match_jax(case):
    """The JAX package's refusals, in its order and with its exception
    types."""
    spec = ("anderson:Lx=6,Ly=6,Lz=6,t=1.0,ranpot=1.0,seed=1"
            if case == "anderson" else "hpcg:8x8x8")
    cfg = {"galerkin_injection": {"mg_transfer": "injection",
                                  "mg_coarse_op": "galerkin"},
           "transfer": {"mg_transfer": "cubic"},
           "coarse_op": {"mg_coarse_op": "exact"},
           "levels": {"mg_levels": -1}}.get(case, {})
    kw = dict(cfg)
    if case == "host_csr":
        Aj = bis.generators.from_source(spec)
        At = bt.generators.from_source(spec)
        calls = (lambda: bis.precond.setup_preconditioner(
                     Aj, bis.SolverConfig(
                         preconditioner=bis.PrecondType.MULTIGRID)),
                 lambda: bt.precond.setup_preconditioner(
                     At, bt.SolverConfig(
                         preconditioner=bt.PrecondType.MULTIGRID),
                     device=CPU))
    elif case == "dia":
        Aj = bis.dia.from_source_device(spec, dtype=np.float64)
        At = bt.dia.from_source_device(spec, dtype=torch.float64, device=CPU)
        calls = (lambda: jmg.build_mg_hierarchy(Aj, bis.SolverConfig(**kw)),
                 lambda: tmg.build_mg_hierarchy(At, bt.SolverConfig(**kw)))
    else:
        Aj = bis.stencil_op.from_source_operator(spec, dtype=np.float64)
        At = bt.stencil_op.from_source_operator(spec, torch.float64,
                                                device=CPU)
        calls = (lambda: jmg.build_mg_hierarchy(Aj, bis.SolverConfig(**kw)),
                 lambda: tmg.build_mg_hierarchy(At, bt.SolverConfig(**kw)))
    errors = []
    for call in calls:
        with pytest.raises(Exception) as info:
            call()
        errors.append(info.value)
    assert type(errors[1]) is type(errors[0])
    assert str(errors[1]) == str(errors[0])


@pytest.mark.parametrize("dims", [(128, 128, 128), (384, 384, 384),
                                  (32, 24, 20), (64, 64, 1), (2048, 2048, 1),
                                  (16, 16, 16), (7, 9, 5)])
def test_level_count_and_estimate_match_jax(dims):
    assert tmg._auto_n_levels(dims) == jmg._auto_n_levels(dims)
    spec = (f"hpcg:{dims[0]}x{dims[1]}x{dims[2]}" if dims[2] > 1
            else f"fdm:{dims[0]}")
    if dims[0] > 64:
        return                 # the count only: no operators this size here
    lj, lt = _hierarchies(spec)
    for sd, cd in ((2, 16), (1, 8), (3, 1)):
        assert tmg.estimated_vcycle_passes(lt, sd, cd) == \
            jmg.estimated_vcycle_passes(lj, sd, cd)


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-12),
                                        (np.float32, 1e-5)])
@pytest.mark.parametrize("spec", ["hpcg:16x16x16", "fdm:64",
                                  "hpcg:32x24x20"])
def test_vcycle_on_carried_levels(spec, dtype, rtol, rng):
    """One V-cycle on the JAX package's levels carried across: rtol 1e-12
    in float64, 1e-5 in float32 (transfer term order)."""
    lj, _ = _hierarchies(spec, dtype=dtype)
    lt = _carry(lj, dtype)
    y = rng.standard_normal(lt[0].A.n_rows).astype(dtype)
    zj = jmg.mg_vcycle(lj, jnp.asarray(y), 2, 16, 4.0, 200.0, "linear",
                       use_pallas=False)
    zt = tmg.mg_vcycle(lt, torch.from_numpy(y), 2, 16, 4.0, 200.0, "linear")
    assert zt.dtype == TORCH_DTYPE[dtype]
    zj = np.asarray(zj)
    np.testing.assert_allclose(zt.numpy(), zj, rtol=rtol,
                               atol=rtol * np.abs(zj).max())


def test_cheby_schedule_stays_in_the_vector_dtype():
    """The Chebyshev scalars are 0-d tensors of the vector dtype, computed
    as the JAX recurrence computes them (float32 here)."""
    lmax = torch.tensor(2.0, dtype=torch.float32)
    theta, steps = tmg.cheby_schedule(lmax, 200.0, 16, torch.float32, CPU)
    assert theta.dtype == torch.float32 and theta.dim() == 0
    assert len(steps) == 15
    assert all(a.dtype == b.dtype == torch.float32 for a, b in steps)
    lj = jnp.float32(2.0)
    lmin = lj / 200.0
    th = 0.5 * (lj + lmin)
    de = 0.5 * (lj - lmin)
    sig = th / de
    rho = 1.0 / sig
    rho_new = 1.0 / (2.0 * sig - rho)
    assert float(theta) == float(th)
    assert float(steps[0][0]) == float(rho_new * rho)
    assert float(steps[0][1]) == float(2.0 * rho_new / de)
