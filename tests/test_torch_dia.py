"""The port's DIA format against the JAX package's: the device builders
and the CSR conversion (equal after cropping the JAX package's row-tile
padding), the plain SpMV (kernel #4's plain version) against the JAX
package's XLA form and its Pallas kernel in interpret mode, and the
structural split, diagonal and scaling.

On the CPU the port's DIA SpMV runs its plain version and launches
nothing; the kernel itself is held against it on the card by
chip_smoke.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import basic_iterative_solvers_tpu as bis
from basic_iterative_solvers_tpu import dia as jdia
from basic_iterative_solvers_tpu import device_matrix as jdm
from basic_iterative_solvers_tpu.ops import pallas_env
from basic_iterative_solvers_tpu.ops.spmv import spmv_dia as jspmv_dia

import basic_iterative_solvers_tpu_torch as bt
from basic_iterative_solvers_tpu_torch import convert
from basic_iterative_solvers_tpu_torch import device_matrix as tdm
from basic_iterative_solvers_tpu_torch import dia as tdia
from basic_iterative_solvers_tpu_torch import generators as tgen
from basic_iterative_solvers_tpu_torch.ops import dia_spmv as tds
from basic_iterative_solvers_tpu_torch import ops as tops

CPU = "cpu"
SPECS = ["hpcg:8x6x4", "fdm:16", "band:700,2",
         "scamac:Anderson,Lx=5,Ly=4,Lz=3,ranpot=3.0,seed=2",
         "anderson:Lx=4,Ly=3,Lz=5,t=0.5,boundary=periodic"]
DTYPES = [(np.float32, torch.float32), (np.float64, torch.float64)]


def _from_jax(Aj, dtype):
    return convert.dia_from_numpy(np.asarray(Aj.data), Aj.offsets,
                                  Aj.n_rows, Aj.n_cols, dtype=dtype,
                                  device=CPU)


def _same_dia(At, Aj):
    assert At.offsets == tuple(Aj.offsets)
    assert (At.n_rows, At.n_cols) == (Aj.n_rows, Aj.n_cols)
    k, n = len(Aj.offsets), Aj.n_rows
    np.testing.assert_array_equal(At.data.numpy(),
                                  np.asarray(Aj.data)[:k, :n])
    # the JAX package's padding holds structural zeros only
    assert not np.asarray(Aj.data)[:k, n:].any()


@pytest.mark.parametrize("np_dt,t_dt", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("spec", SPECS)
def test_device_builder_equal(spec, np_dt, t_dt):
    """dia.from_source_device builds the JAX package's DIA matrix."""
    _same_dia(tdia.from_source_device(spec, t_dt, device=CPU),
              jdia.from_source_device(spec, dtype=np_dt))


@pytest.mark.parametrize("spec", SPECS[:4] + ["sband:1500,6,8"])
def test_csr_to_dia_equal(spec):
    """csr_to_dia from the host CSR equals the JAX package's, and equals
    the device builder where one exists."""
    A = tgen.from_source(spec)
    Aj = bis.generators.from_source(spec)
    At = tdm.csr_to_dia(A, torch.float64, device=CPU)
    _same_dia(At, jdm.csr_to_dia(Aj, dtype=np.float64))
    if tgen.device_buildable(spec):
        assert torch.equal(At.data, tdia.from_source_device(
            spec, torch.float64, device=CPU).data)


@pytest.mark.parametrize("spec", SPECS)
def test_plain_spmv_matches_xla_f64(spec, rng):
    """The plain version against the JAX package's XLA DIA SpMV, float64,
    rtol 1e-14 (both add the diagonals in offset order)."""
    Aj = jdia.from_source_device(spec, dtype=np.float64)
    At = _from_jax(Aj, torch.float64)
    x = rng.standard_normal(At.n_rows)
    yj = np.asarray(jspmv_dia(Aj, jnp.asarray(x)))
    yt = tds.dia_spmv(At, torch.from_numpy(x))
    np.testing.assert_allclose(yt.numpy(), yj, rtol=1e-14,
                               atol=1e-14 * np.abs(yj).max())
    assert torch.equal(yt, tops.spmv(At, torch.from_numpy(x)))


@pytest.fixture
def interpret():
    pallas_env.INTERPRET = True
    try:
        yield
    finally:
        pallas_env.INTERPRET = False


@pytest.mark.parametrize("spec", ["band:700,2", "hpcg:8x6x4"])
def test_plain_spmv_matches_pallas_interpret(spec, interpret, rng):
    """The plain version against the JAX package's Pallas DIA kernel run
    in interpret mode, float32, rtol 2e-6 (tests/test_pallas_interpret.py's
    tolerance): the Pallas kernel sums by lane-residue groups, the plain
    version (and kernel #4) in offset order."""
    from basic_iterative_solvers_tpu.ops.pallas_spmv import dia_pallas_core
    Aj = jdia.from_source_device(spec, dtype=np.float32)
    At = _from_jax(Aj, torch.float32)
    x = rng.standard_normal(At.n_rows).astype(np.float32)
    hneg = max(0, -min(Aj.offsets))
    R = Aj.row_tile
    npad = Aj.data.shape[1]
    xp = jnp.zeros(npad + R, jnp.float32).at[hneg:hneg + At.n_rows].set(x)
    yk = np.asarray(dia_pallas_core(Aj.offsets, hneg, R, Aj.data,
                                    xp))[:At.n_rows]
    yt = tds.dia_spmv_plain(At, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(yt, yk, rtol=2e-6, atol=1e-6)


@pytest.mark.parametrize("spec", ["fdm:16", "band:700,2",
                                  "scamac:Anderson,Lx=5,Ly=4,Lz=3,"
                                  "ranpot=3.0,seed=2"])
def test_split_diag_scale_equal(spec):
    """dia_split, dia_diag and dia_scale equal the JAX package's (float64,
    the same operations in the same order), dia_extract_scale to an
    ulp."""
    Aj = jdia.from_source_device(spec, dtype=np.float64)
    At = _from_jax(Aj, torch.float64)
    Lt, Ut, Dt, Dit = tdia.dia_split(At)
    Lj, Uj, Dj, Dij = jdia.dia_split(Aj)
    for t, j in ((Lt, Lj), (Ut, Uj)):
        assert t.offsets == tuple(j.offsets)
        if j.offsets:
            _same_dia(t, j)
    np.testing.assert_array_equal(Dt.numpy(), np.asarray(Dj))
    np.testing.assert_array_equal(Dit.numpy(), np.asarray(Dij))
    # 1/sqrt(|d|): XLA's square root and division round within an ulp
    # of torch's
    sj = np.asarray(jdia.dia_extract_scale(Aj))
    np.testing.assert_allclose(tdia.dia_extract_scale(At).numpy(), sj,
                               rtol=3e-16)
    _same_dia(tdia.dia_scale(At, torch.from_numpy(sj.copy())),
              jdia.dia_scale(Aj, jnp.asarray(sj)))


def test_zero_or_missing_diagonal_raises():
    At = tdia.anderson_device(3, ranpot=0.0, dtype=torch.float64, device=CPU)
    with pytest.raises(ValueError, match="zero on the matrix diagonal"):
        tdia.dia_split(At)
    L, _U, _D, _Di = tdia.dia_split(tdia.from_source_device(
        "fdm:4", torch.float64, device=CPU))
    with pytest.raises(ValueError, match="no stored main diagonal"):
        tdia.dia_diag(L)


def test_cpu_tensors_launch_nothing_and_bad_operands(rng):
    """A CPU tensor runs the plain version (no launch); wrong dtype,
    shape, device or contiguity raise before anything runs."""
    At = tdia.from_source_device("hpcg:8x6x4", torch.float64, device=CPU)
    x = torch.from_numpy(rng.standard_normal(At.n_rows))
    tds.dia_spmv.launches = 0
    tds.dia_spmv(At, x)
    assert tds.dia_spmv.launches == 0
    for bad, err in ((x.float(), TypeError), (x[:-1], ValueError),
                     (torch.ones(2 * At.n_rows,
                                 dtype=torch.float64)[::2], ValueError)):
        with pytest.raises(err):
            tds.dia_spmv(At, bad)


@pytest.mark.parametrize("entry", [tdia.from_source_device, tdm.from_csr,
                                   bt.preprocessing],
                         ids=lambda f: f.__name__)
def test_builders_default_to_the_card(entry, monkeypatch):
    """The builders and host-CSR preprocessing put the matrix on the card
    unless asked for the CPU; with no card they raise, naming the
    device."""
    import inspect
    assert inspect.signature(entry).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = {tdia.from_source_device: ("band:30,2",),
            tdm.from_csr: (tgen.from_source("band:30,2"),),
            bt.preprocessing: (tgen.from_source("band:30,2"),
                               bt.SolverConfig())}[entry]
    with pytest.raises(RuntimeError, match="'cuda'.*device='cpu'"):
        entry(*args)
    out = entry(*args, device=CPU)
    assert (out.A if entry is bt.preprocessing else out).device.type == "cpu"


def test_kernel_refuses_more_than_96_diagonals():
    """The kernel takes the offsets by value, at most the JAX package's
    dia_max_diags (96): a wider DIA matrix raises before any launch."""
    At = tdm.csr_to_dia(tgen.from_source("sband:1500,6,260"), torch.float32,
                        device=CPU)
    assert len(At.offsets) > 96
    with pytest.raises(ValueError, match="at most 96 diagonals"):
        tds._dia_spmv_cuda(At, torch.ones(At.n_rows))
