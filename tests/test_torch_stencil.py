"""The port's stencil operator against the JAX package's.

Both packages build the same generator specs; inputs come from
`numpy.random.default_rng` and reach each package as numpy arrays.  The
hand-written CUDA kernel cannot run here; its plain PyTorch version is
held against the JAX package's plain path (float64) and against the
Pallas kernel it replaces, run in interpret mode (float32).
"""
import numpy as np
import pytest
import torch

from basic_iterative_solvers_tpu import stencil_op as jso
from basic_iterative_solvers_tpu.ops import pallas_env

from basic_iterative_solvers_tpu_torch import stencil_op as tso

#: the port's entry points run on the card unless asked; these tests
#: run on the CPU
CPU = "cpu"

SPECS = ["hpcg:8x6x4", "hpcg:16x16x16", "fdm:16",
         "anderson:Lx=4,Ly=5,Lz=3,t=1.2,ranpot=4.0,seed=6"]
DOTS = [(), ("x",), ("self",), ("aux",)]


@pytest.fixture
def interpret():
    pallas_env.INTERPRET = True
    try:
        yield
    finally:
        pallas_env.INTERPRET = False


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n), rng.standard_normal(n)


@pytest.mark.parametrize("spec", SPECS)
def test_builders_match_jax(spec):
    for np_dt, t_dt in ((np.float64, torch.float64),
                        (np.float32, torch.float32)):
        Aj = jso.from_source_operator(spec, dtype=np_dt)
        At = tso.from_source_operator(spec, t_dt, device=CPU)
        assert At.legs == Aj.legs
        assert At.dims == Aj.dims
        assert (At.n_rows, At.n_cols) == (Aj.n_rows, Aj.n_cols)
        # coefficients and diagonal stored in the same dtype: bitwise equal
        np.testing.assert_array_equal(At.coeffs.numpy(), np.asarray(Aj.coeffs))
        if np_dt == np.float64:
            assert At.coeff_values == Aj.coeff_values
        assert (At.diag is None) == (Aj.diag is None)
        if Aj.diag is not None:
            np.testing.assert_array_equal(
                At.diag.numpy(), np.asarray(Aj.diag)[:Aj.n_rows])


@pytest.mark.parametrize("dots", DOTS, ids=lambda d: "+".join(d) or "none")
@pytest.mark.parametrize("spec", SPECS)
def test_plain_spmv_f64_matches_jax(spec, dots):
    """Same leg order in both, so only summation rounding differs: rtol
    1e-12 (and 1e-12·max|y| absolute for entries that cancel to ~0)."""
    Aj = jso.from_source_operator(spec, dtype=np.float64)
    At = tso.from_source_operator(spec, torch.float64, device=CPU)
    x, aux = _inputs(At.n_rows, 1)
    yj = np.asarray(jso.stencil_spmv_xla(Aj, np.asarray(x)))
    out = tso.stencil_spmv_plain(At, torch.from_numpy(x), dots,
                                 torch.from_numpy(aux))
    out = out if dots else (out,)
    y = out[0].numpy()
    np.testing.assert_allclose(y, yj, rtol=1e-12,
                               atol=1e-12 * np.abs(yj).max())
    partner = {"x": x, "self": yj, "aux": aux}
    for kind, d in zip(dots, out[1:]):
        np.testing.assert_allclose(float(d), np.dot(yj, partner[kind]),
                                   rtol=1e-12)


@pytest.mark.parametrize("dots", DOTS, ids=lambda d: "+".join(d) or "none")
@pytest.mark.parametrize("spec", SPECS)
def test_plain_spmv_f32_matches_pallas_kernel(interpret, spec, dots):
    """The TPU kernel (interpret mode) groups equal-coefficient legs, the
    plain version does not, and the two reduce in different orders: y to
    rtol 2e-6 / atol 1e-5, the dots to rtol 1e-5."""
    Ap = jso.to_planar_matrix(jso.from_source_operator(spec,
                                                       dtype=np.float32))
    At = tso.from_source_operator(spec, torch.float32, device=CPU)
    x, aux = (v.astype(np.float32) for v in _inputs(At.n_rows, 2))
    outs = jso.stencil_spmv_resident(Ap, jso.to_planar_vec(Ap, x), dots=dots,
                                     aux=jso.to_planar_vec(Ap, aux))
    outs = outs if dots else (outs,)
    yk = np.asarray(jso.from_planar_vec(Ap, outs[0]))
    out = tso.stencil_spmv_plain(At, torch.from_numpy(x), dots,
                                 torch.from_numpy(aux))
    out = out if dots else (out,)
    np.testing.assert_allclose(out[0].numpy(), yk, rtol=2e-6, atol=1e-5)
    for d, dk in zip(out[1:], outs[1:]):
        np.testing.assert_allclose(float(d), float(dk), rtol=1e-5)

