"""The port's native host library (basic_iterative_solvers_tpu_torch/
_native.py over its own csrc/bis_host.cpp) against the JAX package's
(tests/test_native.py, case by case).

* Every binding, port against the JAX package, on the same inputs: bit for
  bit (both libraries are one source built with the same flags).
* Every call site's native pass against the port's NumPy branch
  (BIS_TPU_NO_NATIVE=1): bit for bit, apart from two named last-bit
  departures, held to rtol 1e-14: the host SpMV and the ILU(0) values,
  whose native loops contract to fused multiply-adds.
* The superblock builders: the native analysis and scatter against the
  NumPy builder (FORCE_NUMPY), and the CSR-direct GS and ILU(0) pairs
  against the triplet pipeline and the JAX package's CSR-direct pairs, at
  float32 and float64.
* The switch is read at every call; the library builds once per source
  and CPU, a second process finds it, concurrent builders agree, and a
  broken source raises with the compiler's output.
* The ILU(0) prototype of the translation tables (hpcg:6x4x2, 640 table
  entries) equal to the JAX package's, and factor_ilu0_colored and
  stencil_to_dia against the JAX package's on its tests' inputs.

Sources: hpcg:8x6x8, fdm:16, sband:3000,6,200 and a symmetric .mtx
written to tmp_path, all small.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import basic_iterative_solvers_tpu as bis
from basic_iterative_solvers_tpu import _native as jnat
from basic_iterative_solvers_tpu import generators as jgen
from basic_iterative_solvers_tpu import stencil_op as jso
from basic_iterative_solvers_tpu.ops import block_trisolve as jbt

import basic_iterative_solvers_tpu_torch as bt
from basic_iterative_solvers_tpu_torch import _native as tnat
from basic_iterative_solvers_tpu_torch import coloring as tcol
from basic_iterative_solvers_tpu_torch import device_matrix as tdm
from basic_iterative_solvers_tpu_torch import factor as tfac
from basic_iterative_solvers_tpu_torch import generators as tgen
from basic_iterative_solvers_tpu_torch import matrix as tmat
from basic_iterative_solvers_tpu_torch import permute as tperm
from basic_iterative_solvers_tpu_torch import stencil_op as tso
from basic_iterative_solvers_tpu_torch.io import mmio as tmmio
from basic_iterative_solvers_tpu_torch.ops import block_trisolve as tbt
from basic_iterative_solvers_tpu_torch.ops import lane_ell as tle
from tests.test_torch_ilu0_factor import numpy_branch  # noqa: F401

CPU = "cpu"
SOURCES = ["hpcg:8x6x8", "fdm:16", "sband:3000,6,200", "mtx"]
GRID = ["hpcg:8x6x8", "fdm:16"]
DTYPES = [(torch.float32, np.float32), (torch.float64, np.float64)]


def _jax_native_available() -> bool:
    """Is the JAX package's native library loaded?  A failed first load is
    retried under a file lock before its tests skip: that package builds
    straight into csrc/libbis_host.so and keeps a failed load for the life
    of the process, so a test process that read the file while another was
    writing it would skip every test here.  Under the lock the load is
    tried again and, failing that, the library is rebuilt beside its place
    and moved there in one step."""
    if jnat.available() or os.environ.get("BIS_TPU_NO_NATIVE"):
        return jnat.available()
    import fcntl
    lock = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "build", ".jax_native.lock")
    os.makedirs(os.path.dirname(lock), exist_ok=True)
    with open(lock, "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        for attempt in range(2):
            jnat._TRIED, jnat._LIB = False, None
            if jnat.available() or attempt:
                break
            tmp = f"{jnat._SO}.{os.getpid()}.tmp"
            src = os.path.join(jnat._CSRC, "bis_host.cpp")
            built = subprocess.run(
                ["g++", "-O3", "-march=native", "-fPIC", "-std=c++17",
                 "-shared", "-o", tmp, src], capture_output=True,
                timeout=600).returncode == 0
            if not built:
                break
            os.replace(tmp, jnat._SO)
        return jnat._LIB is not None


pytestmark = pytest.mark.skipif(not _jax_native_available(),
                                reason="the JAX package's native library "
                                       "did not build")


def _mtx_text():
    """A symmetric Matrix Market file (lower triangle, comments, a blank
    line) of an Anderson matrix."""
    A = tgen.anderson(5, 4, 3, ranpot=6.0, seed=9)
    rows = A.rows()
    low = A.col <= rows
    lines = [f"{r + 1} {c + 1} {float(v)!r}" for r, c, v in
             zip(rows[low], A.col[low], A.val[low])]
    return ("%%MatrixMarket matrix coordinate real symmetric\n% comment\n"
            f"{A.n_rows} {A.n_cols} {len(lines)}\n" + "\n".join(lines[:7])
            + "\n\n% mid comment\n" + "\n".join(lines[7:]) + "\n")


@pytest.fixture(params=SOURCES)
def mats(request, tmp_path):
    """(JAX CSR, port CSR) of one source, each read by its own package."""
    src = request.param
    if src == "mtx":
        path = tmp_path / "a.mtx"
        path.write_text(_mtx_text())
        return bis.io.read_mtx(str(path)), tmmio.read_mtx(str(path))
    return jgen.from_source(src), tgen.from_source(src)


def _same(a, b):
    """Exact equality of nested results: arrays by dtype, shape and bits."""
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    elif isinstance(a, np.ndarray):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    elif hasattr(a, "row_ptr"):
        _same((np.asarray(a.row_ptr), np.asarray(a.col), np.asarray(a.val),
               a.n_rows, a.n_cols, a.nnz),
              (np.asarray(b.row_ptr), np.asarray(b.col), np.asarray(b.val),
               b.n_rows, b.n_cols, b.nnz))
    else:
        assert a == b


def _x(A):
    return np.random.default_rng(4).standard_normal(A.n_cols)


def _color_perm(N, A):
    colors = N.greedy_color(A, False)
    perm = np.argsort(colors, kind="stable").astype(np.int32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size, dtype=np.int32)
    return perm, inv


def _b_coo(N, A):
    rows = np.repeat(np.arange(A.n_rows), np.diff(A.row_ptr))
    shuffle = np.random.default_rng(5).permutation(A.nnz)
    I = rows[shuffle].astype(np.int32)
    J = np.asarray(A.col)[shuffle]
    V = np.asarray(A.val)[shuffle]
    dup = np.concatenate([np.arange(A.nnz), np.arange(0, A.nnz, 3)])
    return (N.coo_to_csr(A.nnz, A.n_rows, A.n_cols, I, J, V),
            N.coo_dedup_csr(dup.size, A.n_rows, A.n_cols, I[dup], J[dup],
                            V[dup] * 1.25))


def _b_split(N, A):
    return N.split_lu(A)


def _b_diag(N, A):
    _, Ls, _, Us = N.split_lu(A)
    return (N.peel_diag(A, 1e-16, True, True), N.level_sets(Ls),
            N.level_sets_upper(Us))


def _b_spmv(N, A):
    return N.spmv_csr(A, _x(A))


def _b_ilu0(N, A):
    return N.ilu0(A, 1e-8, 1e-4)


def _b_orders(N, A):
    return (N.greedy_color(A, False), N.greedy_color(A, True),
            N.bfs_perm(A, False, False), N.bfs_perm(A, True, True))


def _b_permute(N, A):
    perm, inv = _color_perm(N, A)
    Ap, lu = N.permute_factor_csr(A, perm, inv, 1e-8, 1e-4)
    return (N.permute_csr(A, perm, inv), Ap, lu,
            N.expand_perm_triplets(Ap, lu, perm))


def _b_formats(N, A):
    n = A.n_rows
    offs, span, ok = N.csr_pattern_stats(A, cap=2 * n)
    K = int(np.diff(A.row_ptr).max())
    R = -(-n // 128)
    out = [offs, span, ok, N.csr_pattern_stats(A, cap=3)]
    for dt in (np.float32, np.float64):
        out += [N.csr_to_ell_pack(A, -(-K // 4) * 4, dt),
                N.lane_ell_build(A, K, span, R + 8, dt)]
        if offs.size <= 96:
            out.append(N.csr_to_dia_pack(A, offs, n, dt))
    return out


BINDINGS = [_b_coo, _b_split, _b_diag, _b_spmv, _b_ilu0, _b_orders,
            _b_permute, _b_formats]


@pytest.mark.parametrize("binding", BINDINGS,
                         ids=[b.__name__[3:] for b in BINDINGS])
def test_binding_matches_jax(binding, mats):
    """Each binding on the same CSR: the port's library and the JAX
    package's give the same bits."""
    Aj, At = mats
    _same(binding(tnat, At), binding(jnat, Aj))


def test_parse_and_generate_match_jax():
    """parse_triplets (values, patterns, a surplus line, a malformed line)
    and the HPCG generator, bit for bit."""
    text = _mtx_text().split("\n", 3)[3]
    n = text.count("\n") - 2
    for N in (tnat, jnat):
        with pytest.raises(ValueError):
            N.parse_triplets("1 x 3\n", 1, with_value=True)
    _same(tnat.parse_triplets(text, n, True),
          jnat.parse_triplets(text, n, True))
    _same(tnat.parse_triplets(text, n - 1, True),      # surplus: n entries
          jnat.parse_triplets(text, n - 1, True))
    _same(tnat.parse_triplets("2 3\n4 5\n", 2, False, 0.01),
          jnat.parse_triplets("2 3\n4 5\n", 2, False, 0.01))
    _same(tnat.hpcg_csr(6, 5, 4, 26.0, -1.0),
          jnat.hpcg_csr(6, 5, 4, 26.0, -1.0))


@pytest.mark.parametrize("src", GRID)
def test_superblock_bindings_match_jax(src):
    """bis_sb_analyze / _scatter on the triplets and bis_sb_analyze_csr /
    _scatter_csr on the colour-permuted CSR, at the port's row stride m,
    float32 and float64 planes."""
    spec = jgen.color_spec_for_source(src)
    Aj, At = jgen.from_source(src), tgen.from_source(src)
    nx, ny, nz, sx, sy, sz = spec.params
    m = nx * (ny // sy) * (nz // sz)
    colors = jbt.spec_colors_np(spec, Aj.n_rows)
    perm = np.argsort(colors, kind="stable").astype(np.int32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size, dtype=np.int32)

    def run(N, A):
        rows = np.repeat(np.arange(A.n_rows), np.diff(A.row_ptr))
        an = N.sb_analyze(rows, np.asarray(A.col), *spec.params, 513)
        out = [an]
        Ap, lu = N.permute_factor_csr(A, perm, inv, 1e-8, 1e-4)
        an_csr = N.sb_analyze_csr(Ap, perm, *spec.params, 513)
        out.append(an_csr)
        for dt in (np.float32, np.float64):
            for upper in (False, True):
                kc = an["cross_up" if upper else "cross_lo"]
                ks = an["self_up" if upper else "self_lo"]
                pc = np.zeros((max(len(kc), 1), m), dt)
                ps = np.zeros((max(len(ks), 1), m), dt)
                assert N.sb_scatter(rows, np.asarray(A.col), A.val,
                                    *spec.params, upper, kc, ks, m, pc, ps)
                out += [pc, ps]
            planes = [np.zeros((max(len(an_csr[k]), 1), m), dt)
                      for k in ("cross_lo", "self_lo", "cross_up",
                                "self_up")]
            out += [N.sb_scatter_csr(Ap, lu, perm, *spec.params, an_csr,
                                     m, m, *planes), planes]
        return out

    _same(run(tnat, At), run(jnat, Aj))


# ---------------------------------------------------------------------------
# Call sites: native against the port's NumPy branch
# ---------------------------------------------------------------------------

def _both(monkeypatch, fn):
    """fn() with the native library, then with BIS_TPU_NO_NATIVE=1."""
    native = fn()
    monkeypatch.setenv("BIS_TPU_NO_NATIVE", "1")
    plain = fn()
    monkeypatch.delenv("BIS_TPU_NO_NATIVE")
    return native, plain


def _s_convert(A):
    rows = A.rows()
    order = np.random.default_rng(5).permutation(A.nnz)
    coo = tmat.MatrixCOO.from_arrays(rows[order], A.col[order],
                                     A.val[order], A.n_rows, A.n_cols)
    return tmat.convert_coo_to_csr(coo)


def _s_factor(A):
    L, Ls, U, Us = tfac.split_LU(A)
    return ((L, Ls, U, Us), tfac.peel_diag(A), tfac.level_sets_lower(Ls),
            tfac.level_sets_upper(Us))


def _s_orders(A):
    colors = tcol.greedy_coloring(A)
    perm, inv = tcol.colors_to_perm(colors)
    return ([tperm.compute_permutation(A, mode)
             for mode in ("bfs", "rcm", "color", "color_bal")],
            tperm.permute_csr(A, perm, inv))


def _s_formats(A):
    out = [tdm.analyze_diagonals(A), tle.lane_ell_span(A)]
    for dt in (torch.float32, torch.float64, torch.bfloat16):
        M = tle.csr_to_lane_ell(A, dt, device=CPU)
        out += [M.vals, M.idx, M.row_len]
        E = tdm.csr_to_ell(A, dt, device=CPU)
        out += [E.data, E.cols]
        if tdm.analyze_diagonals(A)[0].size <= 96:
            D = tdm.csr_to_dia(A, dt, device=CPU)
            out += [D.data, D.offsets]
    return out


SITES = [_s_convert, _s_factor, _s_orders, _s_formats]


@pytest.mark.parametrize("site", SITES, ids=[s.__name__[3:] for s in SITES])
def test_call_site_matches_numpy_branch(site, mats, monkeypatch):
    """The port's call sites: native and NumPy branch bit for bit."""
    _same(*_both(monkeypatch, lambda: site(mats[1])))


def test_generators_and_mtx_match_numpy_branch(tmp_path, monkeypatch):
    """stencil_27pt, scattered_band and read_mtx (symmetric, comments)."""
    path = tmp_path / "a.mtx"
    path.write_text(_mtx_text())
    _same(*_both(monkeypatch, lambda: (
        tgen.stencil_27pt(6, 5, 4), tgen.scattered_band(3000, 6, 200, 2),
        tgen.scattered_band(64, 3, 10, 1), tmmio.read_mtx(str(path)))))


def test_fma_departures_named(mats, monkeypatch):
    """The two last-bit departures of the native branch from the NumPy
    branch: the host SpMV (a sequential row sum with fused multiply-adds
    against add.reduceat) and the ILU(0) values (the IKJ update contracted
    to fused multiply-adds); each within rtol 1e-14, the pattern and the
    triplets' rows and columns exact."""
    A = mats[1]
    x = _x(A)
    (y, lu, trip), (y0, lu0, trip0) = _both(monkeypatch, lambda: (
        A.spmv(x), tfac._ilu0_values(A, 1e-8, 1e-4),
        tfac.factor_ilu0_colored_triplets(A, tcol.greedy_coloring(A))))
    np.testing.assert_allclose(y, y0, rtol=1e-14, atol=1e-14 * abs(y0).max())
    np.testing.assert_allclose(lu, lu0, rtol=1e-14,
                               atol=1e-14 * abs(lu0).max())
    np.testing.assert_array_equal(trip[0], trip0[0])
    np.testing.assert_array_equal(trip[1], trip0[1])
    for v, v0 in zip(trip[2:], trip0[2:]):
        np.testing.assert_allclose(v, v0, rtol=1e-14,
                                   atol=1e-14 * abs(v0).max())


# ---------------------------------------------------------------------------
# Superblock builders
# ---------------------------------------------------------------------------

def _sb_equal(Ba, Bb):
    """Two port SuperBlockTriSolves equal: metadata, mode, planes and
    per-row diagonals bit for bit."""
    assert type(Ba) is type(Bb)
    for f in ("n_rows", "S", "m", "sx", "levels", "upper", "spec_params",
              "dtype", "reach", "const_cross", "const_self", "fused",
              "unit", "is_const", "is_plane"):
        assert getattr(Ba, f) == getattr(Bb, f), f
    for fa, fb in ((Ba.vals_cross, Bb.vals_cross),
                   (Ba.vals_self, Bb.vals_self)):
        assert (fa is None) == (fb is None)
        for a, b in zip(fa or (), fb or ()):
            assert (a is None) == (b is None)
            if a is not None:
                _same(a, b)
    _same(Ba.dinv_rows, Bb.dinv_rows)
    assert (Ba.d_rows is None) == (Bb.d_rows is None)
    if Ba.d_rows is not None:
        _same(Ba.d_rows, Bb.d_rows)


def _sb_matches_jax(Bt, Bj):
    """A port SuperBlockTriSolve against the JAX package's: levels, mode,
    const coefficients, planes (the TPU padding stripped) and per-row
    diagonals bit for bit."""
    assert Bt.levels == Bj.levels
    assert Bt.is_const == (Bj.const_cross is not None)
    if Bt.is_const:
        assert (Bt.const_cross, Bt.const_self) == (Bj.const_cross,
                                                   Bj.const_self)
    else:
        for vt, vj in zip(Bt.vals_cross + Bt.vals_self,
                          Bj.vals_cross + Bj.vals_self):
            assert (vt is None) == (vj is None)
            if vt is not None:
                vj = np.asarray(vj)
                np.testing.assert_array_equal(
                    vt.numpy(), vj.reshape(vj.shape[0], -1)[:, :Bt.m])
    nx, ny, nz, sx, sy, sz = Bt.spec_params
    i = np.arange(Bt.n_rows)
    X, Y, Z = i % nx, (i // nx) % ny, i // (nx * ny)
    SB, SLOT = (Y % sy) + sy * (Z % sz), X + nx * ((Y // sy) + (ny // sy)
                                                   * (Z // sz))
    rows_of = lambda blocks: np.stack(  # noqa: E731
        [np.asarray(b).reshape(-1) for b in blocks])[SB, SLOT]
    np.testing.assert_array_equal(Bt.dinv_rows.numpy(), rows_of(Bj.dinv))
    if Bt.d_rows is not None:
        np.testing.assert_array_equal(Bt.d_rows.numpy(), rows_of(Bj.d))


def _setup(src):
    spec_j = jgen.color_spec_for_source(src)
    spec_t = tcol.ColorSpec(spec_j.kind, spec_j.n_colors, spec_j.params)
    At = tgen.from_source(src)
    return At, jgen.from_source(src), spec_t, spec_j, tcol.spec_colors_np(
        spec_t, At.n_rows)


@pytest.mark.parametrize("t_dt,np_dt", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("src,split", [("hpcg:8x6x8", False),
                                       ("fdm:16", False),
                                       ("hpcg:6x4x8", True)],
                         ids=["hpcg", "fdm", "hpcg-split"])
def test_builder_native_matches_numpy_and_jax(src, split, t_dt, np_dt,
                                              monkeypatch):
    """build_best_trisolve_pair, SGS pair of the CSR and ILU(0) pair of the
    triplets: the native analysis and scatter equal the NumPy builder
    (FORCE_NUMPY) and the JAX package's builder (native too)."""
    if split:
        monkeypatch.setattr(tbt, "NO_ALIGNED", True)
        monkeypatch.setattr(jbt, "NO_ALIGNED", True)
    At, Aj, st, sj, colors = _setup(src)
    D = At.diagonal()
    trip_t = tfac.factor_ilu0_colored_triplets(At, colors)
    for T, DL, DU, need_d in ((At, D, D, True),
                              (trip_t[:3] + (At.n_rows,), None, trip_t[3],
                               False)):
        native = tbt.build_best_trisolve_pair(T, DL, DU, colors, st,
                                              dtype=t_dt, need_d=need_d,
                                              device=CPU)
        monkeypatch.setattr(tbt, "FORCE_NUMPY", True)
        plain = tbt.build_best_trisolve_pair(T, DL, DU, colors, st,
                                             dtype=t_dt, need_d=need_d,
                                             device=CPU)
        monkeypatch.setattr(tbt, "FORCE_NUMPY", False)
        Tj = Aj if T is At else T
        jax_pair = jbt.build_best_trisolve_pair(Tj, DL, DU, colors, sj,
                                                dtype=np_dt, need_d=need_d)
        for Bn, Bp, Bj in zip(native, plain, jax_pair):
            assert isinstance(Bn, tbt.SuperBlockTriSolve)
            assert Bn.fused == (not split)
            _sb_equal(Bn, Bp)
            _sb_matches_jax(Bn, Bj)


@pytest.mark.parametrize("t_dt,np_dt", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("src", GRID)
def test_csr_direct_pairs(src, t_dt, np_dt, monkeypatch):
    """The CSR-direct pairs: ILU(0) off the colour-permuted CSR against the
    triplet pipeline and the NumPy builder, GS off the natural CSR against
    build_best_trisolve_pair; both against the JAX package's CSR-direct
    pairs, bit for bit."""
    At, Aj, st, sj, colors = _setup(src)
    perm, inv = tcol.colors_to_perm(colors)
    Ap, lu = tnat.permute_factor_csr(At, perm, inv, 1e-8, 1e-4)
    L, U, U_D = tbt.build_superblock_ilu0_pair(Ap, lu, perm, st,
                                               dtype=t_dt, device=CPU)
    rows, cols, vals, U_D3 = tfac.factor_ilu0_colored_triplets(At, colors)
    _same(U_D, U_D3)
    trip = (rows, cols, vals, At.n_rows)
    for force in (False, True):
        monkeypatch.setattr(tbt, "FORCE_NUMPY", force)
        L3, U3 = tbt.build_best_trisolve_pair(trip, None, U_D3, colors, st,
                                              dtype=t_dt, device=CPU)
        _sb_equal(L, L3)
        _sb_equal(U, U3)
    monkeypatch.setattr(tbt, "FORCE_NUMPY", False)
    Apj, luj = jnat.permute_factor_csr(Aj, perm, inv, 1e-8, 1e-4)
    Lj, Uj, U_Dj = jbt.build_superblock_ilu0_pair(Apj, luj, perm, sj,
                                                  dtype=np_dt)
    _same(U_D, U_Dj)
    _sb_matches_jax(L, Lj)
    _sb_matches_jax(U, Uj)
    D = At.diagonal()
    Lg, Ug = tbt.build_superblock_gs_pair_from_csr(At, D, st, dtype=t_dt,
                                                   need_d=True, device=CPU)
    for Bn, Bb in zip((Lg, Ug), tbt.build_best_trisolve_pair(
            At, D, D, colors, st, dtype=t_dt, need_d=True, device=CPU)):
        _sb_equal(Bn, Bb)
    for Bn, Bj in zip((Lg, Ug), jbt.build_superblock_gs_pair_from_csr(
            Aj, D, sj, dtype=np_dt, need_d=True)):
        _sb_matches_jax(Bn, Bj)


def test_csr_direct_refusals(monkeypatch):
    """A mod spec, a switched-off library and FORCE_NUMPY refuse with
    BlockIneligibleError; colours the spec does not give skip the native
    analysis."""
    At, _Aj, st, _sj, colors = _setup("hpcg:8x6x8")
    D = At.diagonal()
    assert tbt._native_analysis_for((At.rows(), At.col, At.val, At.n_rows),
                                    colors[::-1].copy(), st) is None
    with pytest.raises(tbt.BlockIneligibleError):
        tbt.build_superblock_gs_pair_from_csr(
            At, D, tcol.ColorSpec("mod", 3, (3,)), device=CPU)
    monkeypatch.setenv("BIS_TPU_NO_NATIVE", "1")
    with pytest.raises(tbt.BlockIneligibleError):
        tbt.build_superblock_gs_pair_from_csr(At, D, st, device=CPU)
    monkeypatch.delenv("BIS_TPU_NO_NATIVE")
    monkeypatch.setattr(tbt, "FORCE_NUMPY", True)
    with pytest.raises(tbt.BlockIneligibleError):
        tbt.build_superblock_gs_pair_from_csr(At, D, st, device=CPU)


@pytest.mark.parametrize("pc", ["ilu0", "sgs", "gs", "bgs"])
def test_preconditioner_takes_csr_direct(pc, monkeypatch):
    """setup_preconditioner on host CSR under a grid spec packs the pair
    off the CSR (one call of the CSR-direct builder), equal to the
    builders' pair; GS keeps L, BGS keeps U."""
    At, _Aj, st, _sj, colors = _setup("hpcg:8x6x8")
    calls = []
    orig = tbt._sb_pack_pair_from_csr
    monkeypatch.setattr(tbt, "_sb_pack_pair_from_csr",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    cfg = bt.SolverConfig(method=bt.SolverType.CONJUGATE_GRADIENT,
                          preconditioner=bt.PRECOND_CLI_NAMES[pc],
                          gs_mode="colored", dtype=torch.float64,
                          color_spec=st)
    M = bt.precond.setup_preconditioner(At, cfg, device=CPU)
    assert calls == [1]
    if pc == "ilu0":
        rows, cols, vals, U_D = tfac.factor_ilu0_colored_triplets(At, colors)
        ref = tbt.build_best_trisolve_pair((rows, cols, vals, At.n_rows),
                                           None, U_D, colors, st,
                                           dtype=torch.float64, device=CPU)
    else:
        D = At.diagonal()
        ref = tbt.build_best_trisolve_pair(At, D, D, colors, st,
                                           dtype=torch.float64,
                                           need_d=pc == "sgs", device=CPU)
    for B, R, keep in zip((M.L_block, M.U_block), ref,
                          (pc != "bgs", pc != "gs")):
        assert (B is not None) == keep
        if keep:
            _sb_equal(B, R)


# ---------------------------------------------------------------------------
# The switch and the build
# ---------------------------------------------------------------------------

def test_switch_read_per_call(numpy_branch, monkeypatch):  # noqa: F811
    """numpy_branch sets BIS_TPU_NO_NATIVE: the port takes the NumPy
    branch at once, whatever ran before in this process, and the native
    passes again once it is unset."""
    A = tgen.from_source("fdm:16")
    assert not tnat.available()
    assert tnat.split_lu(A) is None and tnat.spmv_csr(A, _x(A)) is None
    assert tnat.sb_scatter([], [], [], 1, 1, 1, 1, 1, 1, False, [], [], 1,
                           np.zeros(1), np.zeros(1)) is False
    monkeypatch.delenv("BIS_TPU_NO_NATIVE")
    assert tnat.available() and tnat.split_lu(A) is not None
    monkeypatch.setenv("BIS_TPU_NO_NATIVE", "1")
    assert tnat.split_lu(A) is None


_STANDALONE = textwrap.dedent("""
    import importlib.util, json, sys
    spec = importlib.util.spec_from_file_location("nat", sys.argv[1])
    nat = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(nat)
    path = nat.build(build_dir=sys.argv[2])
    print(json.dumps([str(path), nat.build_seconds]))
""")


def _build_in(build_dir, n_procs):
    procs = [subprocess.Popen(
        [sys.executable, "-c", _STANDALONE, tnat.__file__, str(build_dir)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(n_procs)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    import json
    return [json.loads(o.strip().splitlines()[-1]) for o, _e in outs]


def test_build_once_and_found(tmp_path):
    """Three concurrent builders into an empty directory agree on one
    library, built once, with no temporary file left; a later process
    finds it without building (build_seconds 0) and the file is unchanged;
    the process's own library is keyed the same way."""
    first = _build_in(tmp_path, 3)
    paths = {p for p, _s in first}
    assert len(paths) == 1
    assert sum(s > 0 for _p, s in first) == 1
    lib = paths.pop()
    assert sorted(os.listdir(tmp_path)) == [".lock", os.path.basename(lib)]
    stamp = os.stat(lib).st_mtime_ns
    (again, seconds), = _build_in(tmp_path, 1)
    assert again == lib and seconds == 0.0
    assert os.stat(lib).st_mtime_ns == stamp
    assert os.path.basename(lib) == tnat.library_path().name
    assert str(tnat.build()).startswith(str(tnat.BUILD_DIR))


def test_broken_source_raises(tmp_path):
    """A source g++ rejects raises RuntimeError with the compiler's
    message, and leaves nothing but the lock behind."""
    src = tmp_path / "broken.cpp"
    src.write_text('extern "C" int bis_broken( { return 0; }\n')
    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match="error"):
        tnat.build(source=src, build_dir=out)
    assert os.listdir(out) == [".lock"]


# ---------------------------------------------------------------------------
# The ILU(0) prototype, factor_ilu0_colored, stencil_to_dia
# ---------------------------------------------------------------------------

def test_ilu0_prototype_matches_jax():
    """The translation tables' prototype factorization on hpcg:6x4x2
    (640 factor entries), port native against the JAX package's native,
    bit for bit: the tables and the U pivots."""
    src = "hpcg:6x4x2"
    sj = jgen.color_spec_for_source(src)
    opt = tso.from_source_operator(src, torch.float64, device=CPU)
    opj = jso.from_source_operator(src, dtype=np.float64)
    got = tbt._ilu0_translation_tables(opt, tuple(sj.params), sj.n_colors,
                                       1e-8, 1e-4)
    ref = jbt._ilu0_translation_tables(opj, tuple(sj.params), sj.n_colors,
                                       1e-8, 1e-4)
    assert np.count_nonzero(got[0]) == 640
    _same(got[0], np.asarray(ref[0]))
    _same(got[1], np.asarray(ref[1]))
    assert got[2:] == tuple(ref[2:])


def _random_sym_csr(pkg, n=40, density=0.15, seed=0):
    """tests/test_coloring.py's matrix, as `pkg`'s MatrixCSR."""
    rng = np.random.default_rng(seed)
    dense = rng.uniform(-1, 1, (n, n)) * (rng.uniform(size=(n, n)) < density)
    dense = dense + dense.T
    np.fill_diagonal(dense, 2.0 * n)
    return pkg.MatrixCSR.from_dense(dense)


def test_factor_ilu0_colored_matches_jax():
    """factor_ilu0_colored on tests/test_coloring.py's random matrix
    (n = 40, seed 11, greedy colours) equals the JAX package's bit for bit
    and its masked-sweep apply equals the permuted-space substitutions;
    on a stencil the factors stay DIA."""
    from basic_iterative_solvers_tpu import factor as jfac
    from basic_iterative_solvers_tpu import matrix as jmat
    A = _random_sym_csr(tmat, seed=11)
    colors = tcol.greedy_coloring(A)
    L_s, U_s, U_D = tfac.factor_ilu0_colored(A, colors)
    _same((L_s, U_s, U_D), jfac.factor_ilu0_colored(
        _random_sym_csr(jmat, seed=11), colors))
    y = np.random.default_rng(3).uniform(-1, 1, A.n_rows)
    t = np.zeros_like(y)
    for c in range(int(colors.max()) + 1):            # forward colours
        sel = colors == c
        t[sel] = (y - L_s.spmv(t))[sel]
    z = np.zeros_like(y)
    for c in range(int(colors.max()), -1, -1):
        sel = colors == c
        z[sel] = ((t - U_s.spmv(z)) / U_D)[sel]
    perm, inv = tcol.colors_to_perm(colors)
    Ap = tperm.permute_csr(A, perm, inv)
    dense = np.zeros((A.n_rows, A.n_rows))
    dense[Ap.rows(), Ap.col] = tfac._ilu0_values(Ap, 1e-8, 1e-4)
    zp = np.linalg.solve(np.tril(dense, -1) + np.eye(A.n_rows), y[perm])
    wp = np.linalg.solve(np.triu(dense), zp)
    np.testing.assert_allclose(z[perm], wp, rtol=1e-10, atol=1e-12)
    S = tgen.stencil_27pt(6, 5, 4)
    L_s, U_s, U_D = tfac.factor_ilu0_colored(S, tcol.greedy_coloring(S))
    for T in (L_s, U_s):
        assert isinstance(tdm.from_csr(T, torch.float64, device=CPU),
                          tdm.DeviceDIA)
    assert np.all(np.abs(U_D) > 0)


def _random_legs(seed):
    """tests/test_property.py's random stencil: a random subset of the 27
    legs (the centre kept) with normal coefficients."""
    rng = np.random.default_rng(seed)
    nx, ny, nz = (int(v) for v in rng.integers(2, 9, size=3))
    legs = [(dx, dy, dz) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
            for dx in (-1, 0, 1)]
    keep = rng.random(27) < 0.6
    keep[13] = True
    return [(leg, float(rng.standard_normal()))
            for leg, k in zip(legs, keep) if k], (nx, ny, nz)


@pytest.mark.parametrize("case", ["anderson"] + [f"legs{s}" for s in
                                                 range(4)])
def test_stencil_to_dia_matches_jax(case):
    """stencil_to_dia against the JAX package's on tests/test_stencil_op.py's
    Anderson operator (a dense diagonal) and test_property.py's random
    stencils: offsets equal, data bit for bit (the JAX padding stripped),
    and the DIA SpMV equals the stencil's plain SpMV."""
    from basic_iterative_solvers_tpu_torch import dia as tdia
    from basic_iterative_solvers_tpu_torch.ops.dia_spmv import dia_spmv_plain
    if case == "anderson":
        At = tso.anderson_operator(5, 3, 2, ranpot=3.0, seed=9,
                                   dtype=torch.float64, device=CPU)
        Aj = jso.anderson_operator(5, 3, 2, ranpot=3.0, seed=9,
                                   dtype=np.float64)
        ref = tdia.anderson_device(5, 3, 2, ranpot=3.0, seed=9,
                                   dtype=torch.float64, device=CPU)
    else:
        legs, dims = _random_legs(int(case[4:]))
        At = tso.make_stencil(legs, *dims, dtype=torch.float64, device=CPU)
        Aj = jso.make_stencil(legs, *dims, dtype=np.float64)
        ref = None
    M, Mj = tso.stencil_to_dia(At), jso.stencil_to_dia(Aj)
    assert M.offsets == Mj.offsets and M.device == At.device
    _same(M.data.numpy(), np.asarray(Mj.data)[:, :At.n_rows])
    if ref is not None:
        assert M.offsets == ref.offsets
        _same(M.data, ref.data)
    x = torch.from_numpy(_x(At))
    np.testing.assert_allclose(dia_spmv_plain(M, x).numpy(),
                               tso.stencil_spmv_plain(At, x).numpy(),
                               rtol=1e-12, atol=1e-12)
