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
from basic_iterative_solvers_tpu_torch import ops as tops
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


# ---------------------------------------------------------------------------
# The counted routes' stored arrays (row_len, idx16)
# ---------------------------------------------------------------------------

def _counted_reading(M, x):
    """A plain reading of what the counted kernel routes read: slot plane
    k adds its product only on the rows with k < row_len, the packed index
    taken from the 16-bit plane (its unsigned bits)."""
    plane = M.R * tle.LANES
    xf = torch.nn.functional.pad(x, (0, plane - M.n_rows))
    r = torch.arange(M.R).view(M.R, 1)
    p16 = M.idx16.long() & 0xFFFF
    lens = M.row_len.long()
    y = torch.zeros((M.R, tle.LANES), dtype=x.dtype)
    for k in range(M.K):
        flat = ((r + p16[k] // tle.LANES - M.S) * tle.LANES
                + p16[k] % tle.LANES).clamp(0, plane - 1)
        y = torch.where(k < lens, y + M.vals[k].to(x.dtype) * xf[flat], y)
    return y.reshape(-1)[:M.n_rows]


def _last_nonzero_np(vals):
    """One plus each row's last nonzero slot, from the planes in numpy."""
    nz = np.asarray(vals) != 0
    K = nz.shape[0]
    return np.where(nz.any(0), K - np.argmax(nz[::-1], axis=0), 0)


@pytest.mark.parametrize("spec", SPECS)
def test_counts_and_idx16_from_planes_and_csr(spec, numpy_branch):  # noqa: F811
    """row_len (one plus the last nonzero-valued slot) and the 16-bit
    plane, built from CSR by the port and from the JAX package's planes
    (convert.lane_ell_from_numpy), are equal; the counts match a numpy
    reading of the planes, the 16-bit plane's bits the int32 indices."""
    Mt, Mj = _planes(spec, torch.float32, np.float32)
    Mc = convert.lane_ell_from_numpy(
        np.asarray(Mj.vals), np.asarray(Mj.idx), Mj.n_rows, Mj.K, Mj.S,
        Mj.R, dtype=torch.float32, device=CPU)
    assert Mt.row_len.dtype == torch.uint8 and Mt.K <= 255
    assert Mt.row_len.shape == (Mt.R, tle.LANES)
    np.testing.assert_array_equal(Mt.row_len.numpy(),
                                  _last_nonzero_np(Mt.vals.numpy()))
    assert torch.equal(Mt.row_len, Mc.row_len)
    assert Mt.idx16 is not None and tle.route_for(Mt) == "idx16"
    assert torch.equal(Mt.idx16, Mc.idx16)
    assert torch.equal(Mt.idx16.int() & 0xFFFF, Mt.idx)
    # every real entry lies before its row's count
    A = tgen.from_source(spec)
    nnz = np.zeros(Mt.R * tle.LANES, dtype=np.int64)
    nnz[:A.n_rows] = A.row_nnz()
    assert (Mt.row_len.numpy().reshape(-1) <= nnz).all()
    assert int(Mt.row_len.long().sum()) <= A.nnz


def test_idx16_only_where_the_span_fits():
    """The 16-bit plane exists for (2S + 1)·128 ≤ 65,535 (S ≤ 255), and
    route_for takes idx32 beyond; more than 255 slots widen the counts to
    int32; extended rows count 0."""
    for S, fits in ((255, True), (256, False)):
        idx = torch.full((2, 8, tle.LANES), (2 * S + 1) * tle.LANES - 1,
                         dtype=torch.int32)
        M = tle.DeviceLaneELL(vals=torch.ones(2, 8, tle.LANES), idx=idx,
                              n_rows=1000, n_cols=1000, K=2, S=S, R=8)
        assert (M.idx16 is not None) == fits
        assert tle.route_for(M) == ("idx16" if fits else "idx32")
        if fits:
            assert int(M.idx16.int()[0, 0, 0]) & 0xFFFF == 65407
    vals = torch.zeros(300, 8, tle.LANES)
    vals[299, 3, 5] = 1.0
    M = tle.DeviceLaneELL(vals=vals, idx=torch.zeros(300, 8, tle.LANES,
                                                     dtype=torch.int32),
                          n_rows=1000, n_cols=1000, K=300, S=0, R=8)
    assert M.row_len.dtype == torch.int32 and int(M.row_len[3, 5]) == 300
    M = tle.csr_to_lane_ell(tgen.from_source("sband:1500,6,260"),
                            device=CPU)
    E = tle.lane_ell_extend_rows(M, M.R + tle.lane_ell_row_tile(M.n_rows,
                                                                 M.S))
    assert E.R > M.R and int(E.row_len[M.R:].sum()) == 0
    assert torch.equal(E.row_len[:M.R], M.row_len)


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_counted_reading_bit_equal_plain(spec, dtype, rng):
    """Stopping each row at its count changes no bit of y for finite x:
    the counted reading equals lane_ell_spmv_plain (x float64 over bf16
    values)."""
    M = tle.csr_to_lane_ell(tgen.from_source(spec), dtype, device=CPU)
    xdt = torch.float64 if dtype == torch.bfloat16 else dtype
    x = torch.from_numpy(rng.standard_normal(M.n_rows)).to(xdt)
    assert torch.equal(_counted_reading(M, x), tle.lane_ell_spmv_plain(M, x))


@pytest.mark.parametrize("spec", ["sband:1500,6,260", "fdm:16"])
def test_counted_reading_matches_xla(spec, rng, numpy_branch):  # noqa: F811
    """The counted reading of the port's planes against the JAX package's
    lane_ell_spmv_xla on the same numpy x, float64 (rtol 1e-14, as the
    plain version's test)."""
    Mt, Mj = _planes(spec, torch.float64, np.float64)
    x = rng.standard_normal(Mt.n_rows)
    yj = np.asarray(jle.lane_ell_spmv_xla(Mj, jnp.asarray(x)))
    yt = _counted_reading(Mt, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(yt, yj, rtol=1e-14,
                               atol=1e-14 * np.abs(yj).max())


def test_nonfinite_x_at_a_pad_column_departs(rng):
    """The departure by design: a NaN or Inf of x at a column that a
    skipped (pad) slot points at reaches y in the plain version (0·Inf)
    and not in the counted reading; only rows with such a skipped slot
    differ, and every other row is bit-equal."""
    M = tle.csr_to_lane_ell(tgen.from_source("sband:1500,6,260"),
                            torch.float64, device=CPU)
    plane = M.R * tle.LANES
    r = torch.arange(M.R).view(M.R, 1)
    cols = ((r + M.idx.long() // tle.LANES - M.S) * tle.LANES
            + M.idx.long() % tle.LANES).clamp(0, plane - 1)
    k = torch.arange(M.K).view(M.K, 1, 1)
    skipped = k >= M.row_len.long()
    j = int(cols[skipped].min())            # a column some pad points at
    x = torch.from_numpy(rng.standard_normal(M.n_rows))
    x[j] = float("inf")
    yp = tle.lane_ell_spmv_plain(M, x)
    yc = _counted_reading(M, x)
    hit = (skipped & (cols == j)).any(0).reshape(-1)[:M.n_rows]
    differ = ~((yp == yc) | (yp.isnan() & yc.isnan()))
    assert hit.any() and differ.any()
    assert not (differ & ~hit).any()
    # 0·Inf is NaN in the plain version; the counted reading keeps what
    # the real entries give (finite, or ±Inf where one of them reads x[j])
    assert torch.isnan(yp[differ]).all() and not yc[differ].isnan().any()
