"""The port's lane-ELL format against the JAX package's: the builder's
slot planes and metadata, and the plain SpMV (kernel #5's plain version)
against the JAX package's XLA form and its Pallas kernel in interpret
mode.  The JAX side builds with its native host library off
(`numpy_branch`): the port copies its NumPy branch.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import basic_iterative_solvers_tpu as bis
from basic_iterative_solvers_tpu.ops import lane_ell as jle
from basic_iterative_solvers_tpu.ops import pallas_env

from basic_iterative_solvers_tpu_torch import convert
from basic_iterative_solvers_tpu_torch import generators as tgen
from basic_iterative_solvers_tpu_torch.ops import lane_ell as tle
from basic_iterative_solvers_tpu_torch.ops import spmv as tops
from tests.test_torch_ilu0_factor import numpy_branch  # noqa: F401

CPU = "cpu"
SPECS = ["sband:1500,6,260", "sband:1500,5,60", "sband:3000,8,1400",
         "fdm:16", "band:200,3"]


def _planes(spec, dtype, np_dtype):
    A = tgen.from_source(spec)
    Mt = tle.csr_to_lane_ell(A, dtype, device=CPU)
    Mj = jle.csr_to_lane_ell(bis.generators.from_source(spec),
                             dtype=np_dtype)
    return Mt, Mj


@pytest.mark.parametrize("spec", SPECS)
def test_builder_planes_equal(spec, numpy_branch):  # noqa: F811
    """vals, idx (pad slots included), K, S and R equal the JAX
    package's."""
    Mt, Mj = _planes(spec, torch.float32, np.float32)
    for f in ("n_rows", "K", "S", "R"):
        assert getattr(Mt, f) == getattr(Mj, f)
    np.testing.assert_array_equal(Mt.vals.numpy(), np.asarray(Mj.vals))
    np.testing.assert_array_equal(Mt.idx.numpy(), np.asarray(Mj.idx))
    assert Mt.idx.dtype == torch.int32
    assert tle.lane_ell_span(tgen.from_source(spec)) == Mj.S


@pytest.mark.parametrize("spec", SPECS)
def test_plain_matches_xla_f64(spec, rng, numpy_branch):  # noqa: F811
    """The plain version against the JAX package's lane_ell_spmv_xla,
    float64: the same products added slot by slot (rtol 1e-14)."""
    Mt, Mj = _planes(spec, torch.float64, np.float64)
    x = rng.standard_normal(Mt.n_rows)
    yj = np.asarray(jle.lane_ell_spmv_xla(Mj, jnp.asarray(x)))
    yt = tle.lane_ell_spmv(Mt, torch.from_numpy(x))
    np.testing.assert_allclose(yt.numpy(), yj, rtol=1e-14,
                               atol=1e-14 * np.abs(yj).max())
    assert torch.equal(yt, tops.spmv(Mt, torch.from_numpy(x)))
    A = tgen.from_source(spec)
    np.testing.assert_allclose(yt.numpy(), A.spmv(x), rtol=1e-12,
                               atol=1e-12 * np.abs(yj).max())


@pytest.fixture
def interpret():
    pallas_env.INTERPRET = True
    try:
        yield
    finally:
        pallas_env.INTERPRET = False


@pytest.mark.parametrize("spec", ["sband:1500,5,60", "sband:1500,6,260"])
def test_plain_matches_pallas_interpret(spec, interpret, rng,
                                        numpy_branch):  # noqa: F811
    """The plain version against the JAX package's Pallas lane-ELL kernel
    in interpret mode, float32 (tests/test_pallas_interpret.py's rtol 2e-5,
    atol 1e-5: the kernel adds per shift, masked)."""
    Mj = jle.csr_to_lane_ell(bis.generators.from_source(spec),
                             dtype=np.float32)
    Mt = convert.lane_ell_from_numpy(
        np.asarray(Mj.vals), np.asarray(Mj.idx), Mj.n_rows, Mj.K, Mj.S,
        Mj.R, dtype=torch.float32, device=CPU)
    x = rng.standard_normal(Mt.n_rows).astype(np.float32)
    yk = np.asarray(jle.lane_ell_spmv_pallas(Mj, jnp.asarray(x)))
    yt = tle.lane_ell_spmv_plain(Mt, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(yt, yk, rtol=2e-5, atol=1e-5)


def test_cpu_tensors_launch_nothing_and_bad_operands(rng):
    M = tle.csr_to_lane_ell(tgen.from_source("sband:1500,6,260"),
                            torch.float64, device=CPU)
    x = torch.from_numpy(rng.standard_normal(M.n_rows))
    tle.lane_ell_spmv.launches = 0
    tle.lane_ell_spmv(M, x)
    assert tle.lane_ell_spmv.launches == 0
    for bad, err in ((x.float(), TypeError), (x[:-1], ValueError)):
        with pytest.raises(err):
            tle.lane_ell_spmv(M, bad)
    with pytest.raises(ValueError, match="square"):
        tle.csr_to_lane_ell(bis.MatrixCSR.from_dense(np.ones((2, 3))),
                            device=CPU)


def test_ell_gather_spmv_matches_host(rng):
    """The gather ELL's plain torch SpMV against the host CSR product."""
    from basic_iterative_solvers_tpu_torch.device_matrix import csr_to_ell
    A = tgen.from_source("sband:1500,6,260")
    E = csr_to_ell(A, torch.float64, device=CPU)
    K = -(-int(A.row_nnz().max()) // 4) * 4
    assert E.data.shape == (A.n_rows, K) and E.cols.dtype == torch.int32
    x = rng.standard_normal(A.n_rows)
    np.testing.assert_allclose(tops.spmv(E, torch.from_numpy(x)).numpy(),
                               A.spmv(x), rtol=1e-12)
