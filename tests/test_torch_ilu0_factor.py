"""The port's host set-up of exact coloured ILU(0) against the JAX
package's: the CSR subset (matrix.py, permute.py), the colour helpers, the
prototype factorization (factor.py) and the translation tables
(ops/block_trisolve._ilu0_translation_tables).

All of it is float64 NumPy arithmetic in the same order in both packages,
so every comparison is exact (rtol 0).  The port copies the NumPy branch
of the JAX package's factorization, so the JAX side runs with its native
host library switched off (`numpy_branch`): the native IKJ loop contracts
to fused multiply-adds and differs in the last bit.  Matrices come from
the JAX package's generators, carried across as NumPy arrays.
"""
import numpy as np
import pytest
import torch

import basic_iterative_solvers_tpu as bis
from basic_iterative_solvers_tpu import _native
from basic_iterative_solvers_tpu import coloring as jcol
from basic_iterative_solvers_tpu import factor as jfac
from basic_iterative_solvers_tpu import permute as jperm
from basic_iterative_solvers_tpu import stencil_op as jso
from basic_iterative_solvers_tpu.generators import color_spec_for_source
from basic_iterative_solvers_tpu.ops import block_trisolve as jbt

from basic_iterative_solvers_tpu_torch import coloring as tcol
from basic_iterative_solvers_tpu_torch import factor as tfac
from basic_iterative_solvers_tpu_torch import matrix as tmat
from basic_iterative_solvers_tpu_torch import permute as tperm
from basic_iterative_solvers_tpu_torch import stencil_op as tso
from basic_iterative_solvers_tpu_torch.ops import block_trisolve as tbt

#: the port's entry points run on the card unless asked; these tests
#: run on the CPU
CPU = "cpu"

FACTOR_SPECS = ["hpcg:6x4x2", "hpcg:8x8x8"]
TABLE_SPECS = ["hpcg:16x16x16", "hpcg:32x24x20", "hpcg:12x8x6"]


@pytest.fixture
def numpy_branch(monkeypatch):
    """The JAX package's NumPy factorization branch (tests/test_native.py's
    switch)."""
    monkeypatch.setenv("BIS_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(_native, "_LIB", None)
    monkeypatch.setattr(_native, "_TRIED", True)


def _port_csr(spec):
    """The JAX package's CSR of `spec` as the port's MatrixCSR, and the
    JAX one."""
    Aj = bis.generators.from_source(spec)
    At = tmat.MatrixCSR(Aj.n_rows, Aj.n_cols, Aj.nnz,
                        np.asarray(Aj.row_ptr).copy(),
                        np.asarray(Aj.col).copy(), np.asarray(Aj.val).copy())
    return Aj, At


def _port_spec(spec):
    s = color_spec_for_source(spec)
    return tcol.ColorSpec(kind=s.kind, n_colors=s.n_colors, params=s.params)


@pytest.mark.parametrize("spec", FACTOR_SPECS + ["fdm:16"])
def test_color_helpers_match_jax(spec):
    """spec_colors_np, _grid_coords and colors_to_perm equal the JAX
    package's (integer arithmetic: exact)."""
    sj, st = color_spec_for_source(spec), _port_spec(spec)
    n = bis.generators.from_source(spec).n_rows
    cj, ct = jbt.spec_colors_np(sj, n), tcol.spec_colors_np(st, n)
    np.testing.assert_array_equal(ct, cj)
    assert ct.dtype == cj.dtype
    for a, b in zip(tcol.colors_to_perm(ct), jcol.colors_to_perm(cj)):
        np.testing.assert_array_equal(a, b)
    idx = np.arange(n)
    for a, b in zip(tcol._grid_coords(idx, 5, 3), jbt._grid_coords(idx, 5, 3)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("spec", FACTOR_SPECS)
def test_coo_csr_and_permute_match_jax(spec):
    """MatrixCOO.from_arrays → convert_coo_to_csr rebuilds the JAX
    package's CSR from its own triplets, and permute_csr by the colour
    permutation equals the JAX package's (exact)."""
    from basic_iterative_solvers_tpu.matrix import MatrixCOO, \
        convert_coo_to_csr
    Aj, At = _port_csr(spec)
    rows = np.repeat(np.arange(At.n_rows), At.row_nnz())
    rng = np.random.default_rng(11)
    order = rng.permutation(rows.size)          # unsorted triplets
    coo_t = tmat.MatrixCOO.from_arrays(rows[order], At.col[order],
                                       At.val[order], n_rows=At.n_rows,
                                       n_cols=At.n_cols)
    coo_j = MatrixCOO.from_arrays(rows[order], At.col[order], At.val[order],
                                  n_rows=At.n_rows, n_cols=At.n_cols)
    Ct, Cj = tmat.convert_coo_to_csr(coo_t), convert_coo_to_csr(coo_j)
    for f in ("row_ptr", "col", "val"):
        np.testing.assert_array_equal(getattr(Ct, f), getattr(Cj, f))
        np.testing.assert_array_equal(getattr(Ct, f), getattr(At, f))
    perm, inv = jcol.colors_to_perm(
        jbt.spec_colors_np(color_spec_for_source(spec), At.n_rows))
    Pt, Pj = tperm.permute_csr(At, perm, inv), jperm.permute_csr(Aj, perm,
                                                                 inv)
    for f in ("row_ptr", "col", "val"):
        np.testing.assert_array_equal(getattr(Pt, f),
                                      np.asarray(getattr(Pj, f)))
    with pytest.raises(ValueError, match="duplicate"):
        tmat.convert_coo_to_csr(tmat.MatrixCOO.from_arrays(
            [0, 0], [1, 1], [1.0, 2.0], n_rows=2, n_cols=2))


@pytest.mark.parametrize("spec", FACTOR_SPECS)
def test_ilu0_factorization_matches_jax(numpy_branch, spec):
    """_ilu0_values and factor_ilu0_colored_triplets equal the JAX
    package's NumPy branch bit for bit (the same IKJ loop and pivot
    guards)."""
    Aj, At = _port_csr(spec)
    sj = color_spec_for_source(spec)
    colors = jbt.spec_colors_np(sj, At.n_rows)
    perm, inv = jcol.colors_to_perm(colors)
    Pj = jperm.permute_csr(Aj, perm, inv)
    Pt = tperm.permute_csr(At, perm, inv)
    np.testing.assert_array_equal(tfac._ilu0_values(Pt, 1e-8, 1e-4),
                                  jfac._ilu0_values(Pj, 1e-8, 1e-4))
    got = tfac.factor_ilu0_colored_triplets(At, colors)
    ref = jfac.factor_ilu0_colored_triplets(Aj, colors)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, np.asarray(r))


def test_ilu0_pivot_guard_and_missing_diagonal(numpy_branch):
    """A final diagonal below pivot_tolerance becomes ±pivot_replacement,
    as in the JAX package; a row with no stored diagonal raises
    MissingDiagonalError."""
    A = tmat.convert_coo_to_csr(tmat.MatrixCOO.from_arrays(
        [0, 0, 1, 1], [0, 1, 0, 1], [1.0, 1.0, 1.0, 1.0 + 1e-12],
        n_rows=2, n_cols=2))
    vals = tfac._ilu0_values(A, 1e-8, 1e-4)
    assert vals[3] == 1e-4 and vals[2] == 1.0
    from basic_iterative_solvers_tpu.matrix import MatrixCSR
    Aj = MatrixCSR(2, 2, 4, A.row_ptr, A.col, A.val)
    np.testing.assert_array_equal(vals, jfac._ilu0_values(Aj, 1e-8, 1e-4))
    B = tmat.convert_coo_to_csr(tmat.MatrixCOO.from_arrays(
        [0, 1], [0, 0], [1.0, 1.0], n_rows=2, n_cols=2))
    with pytest.raises(tfac.MissingDiagonalError, match="row 1"):
        tfac._ilu0_values(B, 1e-8, 1e-4)


def _tables_both(spec):
    Aj = jso.from_source_operator(spec, dtype=np.float64)
    At = tso.from_source_operator(spec, torch.float64, device=CPU)
    sj = jcol.spec_for_device(Aj)
    params = tuple(int(p) for p in sj.params)
    n_colors = sj.n_colors
    tj = jbt._ilu0_translation_tables(Aj, params, n_colors, 1e-8, 1e-4)
    tt = tbt._ilu0_translation_tables(At, params, n_colors, 1e-8, 1e-4)
    return tj, tt, At


@pytest.mark.parametrize("spec", TABLE_SPECS,
                         ids=["identity", "mapped", "split"])
def test_translation_tables_match_jax(numpy_branch, spec):
    """(T, Tdiag, (Px, Py, Pz), R, h) equal the JAX package's bit for bit:
    identity axes (16³), mapped axes (32×24×20: 32, 24 > 2R + 2s) and the
    split-route grid (12×8×6)."""
    (Tj, Dj, Pj, Rj, hj), (Tt, Dt, Pt, Rt, ht), _ = _tables_both(spec)
    assert (tuple(Pt), Rt, ht) == (tuple(Pj), Rj, hj)
    np.testing.assert_array_equal(Tt, Tj)
    np.testing.assert_array_equal(Dt, Dj)


def test_class_table_equals_whole_csr_factorization():
    """On hpcg:32×24×20 (mapped x and y axes), every factor value of the
    port's own coloured factorization of the whole CSR equals the class
    table's value at the row's class and the leg's offset, and every U
    pivot its Tdiag: the translation tables are exact, not approximate
    (the counterpart of tests/test_block_trisolve.py's check)."""
    spec = "hpcg:32x24x20"
    _Aj, A = _port_csr(spec)
    st = _port_spec(spec)
    rows, cols, vals, U_D = tfac.factor_ilu0_colored_triplets(
        A, tcol.spec_colors_np(st, A.n_rows))
    op = tso.from_source_operator(spec, torch.float64, device=CPU)
    L, U = tbt.build_superblock_ilu0_pair_stencil(op, st,
                                                  dtype=torch.float64)
    assert L.proto != tuple(op.dims)            # mapped, not identity
    nx, ny, nz = op.dims
    base = np.empty(A.n_rows, dtype=np.int64)
    for li in range(len(L.levels)):
        rows_of = torch.arange(A.n_rows).view(nz, ny, nx)[
            tbt._rows(L, li)[5]]
        base[rows_of.reshape(-1).numpy()] = tbt._class_base(
            L, li, "cpu").reshape(-1).numpy()
    w, h = 3, 1
    xr, yr, zr = tcol._grid_coords(rows, nx, ny)
    xc, yc, zc = tcol._grid_coords(cols, nx, ny)
    kd = (xc - xr + h) + w * ((yc - yr + h) + w * (zc - zr + h))
    T = L.table.numpy()
    np.testing.assert_array_equal(T[kd, base[rows]], vals)
    np.testing.assert_array_equal(U.table_dinv.numpy()[base], 1.0 / U_D)
