"""The port's host-CSR layer against the JAX package's: generators, Matrix
Market I/O, factors, level sets, permutations, colourings and the format
choice.

All of it is NumPy arithmetic in the same order in both packages, so the
comparisons are exact.  The port copies the NumPy branches of the JAX
package's host code, so the JAX side runs with its native host library
switched off (`numpy_branch`).
"""
import numpy as np
import pytest

import basic_iterative_solvers_tpu as bis
from basic_iterative_solvers_tpu import coloring as jcol
from basic_iterative_solvers_tpu import device_matrix as jdm
from basic_iterative_solvers_tpu import factor as jfac
from basic_iterative_solvers_tpu import permute as jperm
from basic_iterative_solvers_tpu.io import mmio as jmmio

from basic_iterative_solvers_tpu_torch import coloring as tcol
from basic_iterative_solvers_tpu_torch import device_matrix as tdm
from basic_iterative_solvers_tpu_torch import factor as tfac
from basic_iterative_solvers_tpu_torch import generators as tgen
from basic_iterative_solvers_tpu_torch import permute as tperm
from basic_iterative_solvers_tpu_torch.io import mmio as tmmio
from basic_iterative_solvers_tpu_torch.matrix import MatrixCSR
from tests.test_torch_ilu0_factor import numpy_branch  # noqa: F401

ANDERSON = "scamac:Anderson,Lx=5,Ly=4,Lz=3,t=1.2,ranpot=4.0,seed=6"
SPECS = ["hpcg:8x6x4", "fdm:16", "band:61,2", "sband:1500,6,260", ANDERSON,
         "anderson:Lx=3,Ly=4,Lz=3,boundary=periodic",
         "scamac:Hubbard,n_sites=6,n_fermions=3,U=2.0,ranpot=1.0",
         "scamac:SpinChainXXZ,n_sites=8,n_up=4,Jz=0.5,boundary=periodic",
         "scamac:FreeFermionChain,n_sites=8,n_fermions=3,boundary=periodic"]


def _same_csr(a, b):
    assert (a.n_rows, a.n_cols, a.nnz) == (b.n_rows, b.n_cols, b.nnz)
    np.testing.assert_array_equal(a.row_ptr, b.row_ptr)
    np.testing.assert_array_equal(a.col, b.col)
    np.testing.assert_array_equal(a.val, b.val)


@pytest.mark.parametrize("spec", SPECS)
def test_generators_bit_equal(spec, numpy_branch):  # noqa: F811
    """Every generator spec gives the JAX package's CSR bit for bit, and
    the same structural colouring and device-builder verdict."""
    _same_csr(tgen.from_source(spec), bis.generators.from_source(spec))
    sj = bis.generators.color_spec_for_source(spec)
    st = tgen.color_spec_for_source(spec)
    assert (st is None) == (sj is None)
    if sj is not None:
        assert (st.kind, st.n_colors, st.params) == (sj.kind, sj.n_colors,
                                                     sj.params)
    assert (tgen.device_buildable(spec)
            == bis.generators.device_buildable(spec))


@pytest.mark.parametrize("bad", ["nope:3", "scamac:Heisenberg,n=3",
                                 "anderson:Lx=3,q=1"])
def test_bad_sources_raise_like_jax(bad):
    for pkg in (bis.generators, tgen):
        with pytest.raises(ValueError):
            pkg.from_source(bad)


def test_mtx_round_trip_and_probes(tmp_path):
    """write_mtx → read_mtx gives the matrix back in both packages; a
    symmetric pattern file expands and takes 0.01; a non-square file
    raises MatrixMarketError('Matrix must be square.')."""
    A = tgen.from_source("band:40,3")
    path = tmp_path / "band.mtx"
    tmmio.write_mtx(path, A, comment="banded\ntest")
    _same_csr(tmmio.read_mtx(path), A)
    _same_csr(tmmio.read_mtx(path), jmmio.read_mtx(str(path)))
    sym = tmp_path / "sym.mtx"
    sym.write_text("%%MatrixMarket matrix coordinate pattern symmetric\n"
                   "% c\n3 3 4\n1 1\n2 1\n3 2\n3 3\n")
    _same_csr(tmmio.read_mtx(sym), jmmio.read_mtx(str(sym)))
    assert tmmio.read_mtx(sym).nnz == 6
    assert np.all(tmmio.read_mtx(sym).val == 0.01)
    rect = tmp_path / "rect.mtx"
    rect.write_text("%%MatrixMarket matrix coordinate real general\n"
                    "2 3 1\n1 1 1.0\n")
    with pytest.raises(tmmio.MatrixMarketError, match="Matrix must be "
                       "square."):
        tmmio.read_mtx(rect)
    dense = tmp_path / "dense.mtx"
    dense.write_text("%%MatrixMarket matrix array real general\n"
                     "2 2\n1\n2\n3\n4\n")
    with pytest.raises(tmmio.MatrixMarketError, match="Unsupported"):
        tmmio.read_mtx(dense)


def test_csr_adapters():
    """from_dense, from_scipy, diagonal, spmv and to_dense agree with the
    JAX package's."""
    import scipy.sparse as sp
    rng = np.random.default_rng(3)
    dense = rng.standard_normal((9, 9)) * (rng.random((9, 9)) < 0.3)
    np.fill_diagonal(dense, 4.0)
    for t, j in ((MatrixCSR.from_dense(dense),
                  bis.MatrixCSR.from_dense(dense)),
                 (MatrixCSR.from_scipy(sp.csr_matrix(dense)),
                  bis.MatrixCSR.from_scipy(sp.csr_matrix(dense)))):
        _same_csr(t, j)
        np.testing.assert_array_equal(t.diagonal(), j.diagonal())
        np.testing.assert_array_equal(t.to_dense(), dense)
        x = rng.standard_normal(9)
        np.testing.assert_allclose(t.spmv(x), dense @ x, rtol=1e-14)


@pytest.mark.parametrize("spec", ["fdm:16", "band:61,2", ANDERSON])
@pytest.mark.parametrize("ilu0", [False, True])
def test_factor_lu_equal(spec, ilu0, numpy_branch):  # noqa: F811
    """factor_LU (the split, the diagonal, natural-order ILU(0)) and the
    level sets of both triangles equal the JAX package's bit for bit."""
    A = tgen.from_source(spec)
    Aj = bis.generators.from_source(spec)
    ft, fj = tfac.factor_LU(A, ilu0=ilu0), jfac.factor_LU(Aj, ilu0=ilu0)
    for name in ("L", "L_strict", "U", "U_strict"):
        _same_csr(getattr(ft, name), getattr(fj, name))
    for name in ("A_D", "A_D_inv", "L_D", "U_D"):
        np.testing.assert_array_equal(getattr(ft, name), getattr(fj, name))
    np.testing.assert_array_equal(tfac.level_sets_lower(ft.L_strict),
                                  jfac.level_sets_lower(fj.L_strict))
    np.testing.assert_array_equal(tfac.level_sets_upper(ft.U_strict),
                                  jfac.level_sets_upper(fj.U_strict))


def test_scale_and_diagonal_errors(numpy_branch):  # noqa: F811
    A = tgen.from_source("band:61,2")
    Aj = bis.generators.from_source("band:61,2")
    np.testing.assert_array_equal(tfac.extract_scale(A),
                                  jfac.extract_scale(Aj))
    s = tfac.extract_scale(A)
    _same_csr(tfac.scale_mat(A.copy(), s), jfac.scale_mat(Aj.copy(), s))
    Z = MatrixCSR.from_dense(np.array([[1.0, 2.0], [3.0, 0.0]]))
    with pytest.raises(tfac.MissingDiagonalError):
        tfac.peel_diag(Z)
    Z2 = MatrixCSR(2, 2, 4, np.array([0, 2, 4]), np.array([0, 1, 0, 1],
                                                          dtype=np.int32),
                   np.array([1.0, 2.0, 3.0, 0.0]))
    with pytest.raises(tfac.ZeroDiagonalError):
        tfac.peel_diag(Z2)


@pytest.mark.parametrize("mode", ["none", "bfs", "rcm", "color",
                                  "color_bal"])
@pytest.mark.parametrize("spec", ["fdm:16", "sband:1500,6,260"])
def test_compute_permutation_equal(spec, mode, numpy_branch):  # noqa: F811
    A = tgen.from_source(spec)
    Aj = bis.generators.from_source(spec)
    for a, b in zip(tperm.compute_permutation(A, mode),
                    jperm.compute_permutation(Aj, mode)):
        np.testing.assert_array_equal(a, b)
    perm, inv = tperm.compute_permutation(A, mode)
    _same_csr(tperm.permute_csr(A, perm, inv),
              jperm.permute_csr(Aj, perm, inv))


@pytest.mark.parametrize("balanced", [False, True])
@pytest.mark.parametrize("spec", ["hpcg:8x6x4", "sband:1500,6,260"])
def test_greedy_coloring_equal(spec, balanced, numpy_branch):  # noqa: F811
    A = tgen.from_source(spec)
    ct = tcol.greedy_coloring(A, balanced=balanced)
    np.testing.assert_array_equal(
        ct, jcol.greedy_coloring(bis.generators.from_source(spec),
                                 balanced=balanced))
    assert tcol.check_coloring(A, ct)
    assert not tcol.check_coloring(A, np.zeros_like(ct))


@pytest.mark.parametrize("spec,kw,choice", [
    ("hpcg:8x6x4", {}, "dia"), ("band:61,2", {}, "dia"),
    ("sband:1500,6,260", {}, "lane_ell"),
    ("sband:1500,6,260", {"max_span": 1}, "ell"),
    ("hpcg:8x6x4", {"dia_max_diags": 20}, "lane_ell")])
def test_auto_format_choice_like_jax(spec, kw, choice, numpy_branch):  # noqa: F811,E501
    A = tgen.from_source(spec)
    assert tdm.auto_format_choice(A, **kw) == choice
    assert jdm.auto_format_choice(bis.generators.from_source(spec),
                                  **kw) == choice
    offs_t, fill_t = tdm.analyze_diagonals(A)
    offs_j, fill_j = jdm.analyze_diagonals(bis.generators.from_source(spec))
    np.testing.assert_array_equal(offs_t, offs_j)
    assert fill_t == fill_j
