"""ctypes bindings for the port's native host library (csrc/bis_host.cpp).

The JAX package's _native.py, binding for binding: the same C interface,
the same ctypes signatures and the same None/False returns where a pass
refuses, so every call site keeps its NumPy branch as the plain version
and test oracle and takes the native pass by default.

The library is built with g++ at first use into `build/host/` beside the
package, keyed by a hash of the source, the flags and the host CPU (the
flags hold -march=native), apart from the CUDA kernels' library (_build.py)
so it loads on a machine with no nvcc.  Concurrent builders (test workers)
serialise on a file lock and each build lands under a temporary name that
is renamed into place.  A failed build or load raises with the compiler's
output: nothing falls back to NumPy quietly.  Only the environment switch
`BIS_TPU_NO_NATIVE` (the JAX package's) selects the NumPy branches, and it
is read at every call.
"""
from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import platform
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "bis_host.cpp"
BUILD_DIR = _PKG.parent / "build" / "host"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared")

#: seconds the last build in this process took (0.0: the library was found
#: built)
build_seconds = 0.0

_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")


def available() -> bool:
    """True unless BIS_TPU_NO_NATIVE is set (read at every call)."""
    return not os.environ.get("BIS_TPU_NO_NATIVE")


def _host_cpu() -> str:
    """The host CPU's model and flags: a -march=native build runs only on
    the kind of CPU that built it."""
    try:
        with open("/proc/cpuinfo") as f:
            keep = [line for line in f
                    if line.startswith(("model name", "flags", "Features"))]
        return "".join(sorted(set(keep)))
    except OSError:
        return platform.machine() + platform.processor()


def library_path(source: Path = SOURCE, build_dir: Path = BUILD_DIR) -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_host_cpu().encode())
    h.update(Path(source).read_bytes())
    return Path(build_dir) / f"libbis_host_{h.hexdigest()[:16]}.so"


def build(source: Path = SOURCE, build_dir: Path = BUILD_DIR) -> Path:
    """Compile the host library unless a build of this source for this CPU
    exists; returns its path.  Raises, with g++'s output, if it fails."""
    global build_seconds
    lib = library_path(source, build_dir)
    if lib.exists():
        return lib
    Path(build_dir).mkdir(parents=True, exist_ok=True)
    with open(Path(build_dir) / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():           # another worker built it meanwhile
            return lib
        t0 = time.perf_counter()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
        os.close(fd)
        try:
            cmd = ["g++", *CXX_FLAGS, "-o", tmp, str(source)]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=300)
            except OSError as e:
                raise RuntimeError(f"host library build failed: "
                                   f"{' '.join(cmd)}: {e}") from e
            if proc.returncode != 0:
                raise RuntimeError(
                    f"host library build failed ({proc.returncode}): "
                    f"{' '.join(cmd)}\n{proc.stderr}{proc.stdout}")
            os.chmod(tmp, 0o755)
            os.replace(tmp, lib)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        build_seconds = time.perf_counter() - t0
    return lib


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """Build (if needed) and load the library, every entry point's
    argument and result types declared."""
    lib = ctypes.CDLL(str(build()))
    lib.bis_parse_triplets.restype = ctypes.c_longlong
    lib.bis_parse_triplets.argtypes = [
        ctypes.c_char_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_double, _i32p, _i32p, _f64p]
    lib.bis_coo_to_csr.restype = ctypes.c_int
    lib.bis_coo_to_csr.argtypes = [
        ctypes.c_longlong, ctypes.c_int32, ctypes.c_int32,
        _i32p, _i32p, _f64p, _i64p, _i32p, _f64p]
    lib.bis_coo_dedup_csr.restype = ctypes.c_longlong
    lib.bis_coo_dedup_csr.argtypes = [
        ctypes.c_longlong, ctypes.c_int32, ctypes.c_int32,
        _i32p, _i32p, _f64p, _i64p, _i32p, _f64p]
    lib.bis_split_lu_count.restype = None
    lib.bis_split_lu_count.argtypes = [
        ctypes.c_int32, _i64p, _i32p, _i64p, _i64p, _i64p, _i64p]
    lib.bis_split_lu_fill.restype = None
    lib.bis_split_lu_fill.argtypes = (
        [ctypes.c_int32, _i64p, _i32p, _f64p]
        + [_i64p, _i32p, _f64p] * 4)
    lib.bis_peel_diag.restype = ctypes.c_longlong
    lib.bis_peel_diag.argtypes = [
        ctypes.c_int32, _i64p, _i32p, _f64p, ctypes.c_double, ctypes.c_int,
        _f64p, _i64p]
    lib.bis_ilu0.restype = ctypes.c_longlong
    lib.bis_ilu0.argtypes = [
        ctypes.c_int32, ctypes.c_int32, _i64p, _i32p, _f64p,
        ctypes.c_double, ctypes.c_double]
    lib.bis_level_sets.restype = None
    lib.bis_level_sets.argtypes = [ctypes.c_int32, _i64p, _i32p,
                                   ctypes.c_int, _i32p]
    lib.bis_spmv_csr.restype = None
    lib.bis_spmv_csr.argtypes = [ctypes.c_int32, _i64p, _i32p, _f64p,
                                 _f64p, _f64p]
    lib.bis_greedy_color.restype = ctypes.c_longlong
    lib.bis_greedy_color.argtypes = [ctypes.c_int32, _i64p, _i32p,
                                     ctypes.c_int, _i32p]
    lib.bis_bfs_perm.restype = None
    lib.bis_bfs_perm.argtypes = [ctypes.c_int32, _i64p, _i32p, ctypes.c_int,
                                 ctypes.c_int, _i32p]
    lib.bis_permute_csr.restype = None
    lib.bis_permute_csr.argtypes = [ctypes.c_int32, _i64p, _i32p, _f64p,
                                    _i32p, _i32p, _i64p, _i32p, _f64p]
    lib.bis_permute_factor_csr.restype = ctypes.c_longlong
    lib.bis_permute_factor_csr.argtypes = [
        ctypes.c_int32, _i64p, _i32p, _f64p, _i32p, _i32p,
        ctypes.c_double, ctypes.c_double, _i64p, _i32p, _f64p]
    lib.bis_csr_to_ell_pack.restype = None
    lib.bis_csr_to_ell_pack.argtypes = [
        ctypes.c_int32, _i64p, _i32p, _f64p, ctypes.c_longlong,
        ctypes.c_int, _i32p, ctypes.c_void_p]
    lib.bis_csr_to_dia_pack.restype = None
    lib.bis_csr_to_dia_pack.argtypes = [
        ctypes.c_int32, _i64p, _i32p, _f64p, _i64p, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    lib.bis_csr_pattern_stats.restype = ctypes.c_longlong
    lib.bis_csr_pattern_stats.argtypes = [
        ctypes.c_int32, ctypes.c_int32, _i64p, _i32p, ctypes.c_longlong,
        _i64p, _i64p]
    lib.bis_lane_ell_ranges.restype = ctypes.c_longlong
    lib.bis_lane_ell_ranges.argtypes = [
        ctypes.c_int32, _i64p, _i32p, ctypes.c_int32, _i32p, _i32p]
    lib.bis_lane_ell_pack.restype = None
    lib.bis_lane_ell_pack.argtypes = [
        ctypes.c_int32, _i64p, _i32p, _f64p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_longlong, _i32p, ctypes.c_int, ctypes.c_void_p, _i32p]
    lib.bis_hpcg_csr.restype = None
    lib.bis_hpcg_csr.argtypes = [ctypes.c_int32, ctypes.c_int32,
                                 ctypes.c_int32, ctypes.c_double,
                                 ctypes.c_double, _i64p, _i32p, _f64p]
    lib.bis_expand_perm_triplets.restype = None
    lib.bis_expand_perm_triplets.argtypes = [
        ctypes.c_int32, _i64p, _i32p, _f64p, _i32p, _i32p, _i32p, _f64p]
    lib.bis_sb_analyze.restype = ctypes.c_longlong
    lib.bis_sb_analyze.argtypes = (
        [ctypes.c_longlong, _i32p, _i32p]
        + [ctypes.c_int32] * 6
        + [ctypes.c_longlong, _i64p, _i64p, _i64p, _i64p, _i64p])
    lib.bis_sb_scatter.restype = ctypes.c_longlong
    lib.bis_sb_scatter.argtypes = (
        [ctypes.c_longlong, _i32p, _i32p, _f64p]
        + [ctypes.c_int32] * 6
        + [ctypes.c_int, _i64p, ctypes.c_int32, _i64p, ctypes.c_int32,
           ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
           ctypes.c_void_p])
    lib.bis_sb_analyze_csr.restype = ctypes.c_longlong
    lib.bis_sb_analyze_csr.argtypes = (
        [ctypes.c_int32, _i64p, _i32p, _i32p]
        + [ctypes.c_int32] * 6
        + [ctypes.c_longlong, _i64p, _i64p, _i64p, _i64p, _i64p])
    lib.bis_sb_scatter_csr.restype = ctypes.c_longlong
    lib.bis_sb_scatter_csr.argtypes = (
        [ctypes.c_int32, _i64p, _i32p, _f64p, _i32p]
        + [ctypes.c_int32] * 6
        + [_i64p, ctypes.c_int32] * 4
        + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int]
        + [ctypes.c_void_p] * 4 + [_f64p])
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, or None where BIS_TPU_NO_NATIVE is set."""
    return _library() if available() else None


def _as(arr, dtype):
    return np.ascontiguousarray(arr, dtype=dtype)


def _dtype32(dtype) -> Optional[int]:
    """1 for float32 planes, 0 for float64, None for a dtype the packers
    do not write."""
    dt = np.dtype(dtype)
    if dt == np.dtype(np.float32):
        return 1
    return 0 if dt == np.dtype(np.float64) else None


def parse_triplets(data_text: str, nnz_stored: int, with_value: bool,
                   pattern_value: float = 0.01):
    """Parse 'i j [v]' lines -> (I, J, V) 0-based, or None.  Asks for
    nnz_stored + 1 entries so a file with more data lines than its header
    declares yields a count the caller's exact-count check rejects, as the
    NumPy branch does."""
    lib = _load()
    if lib is None:
        return None
    buf = data_text.encode()
    cap = nnz_stored + 1
    I = np.empty(cap, dtype=np.int32)
    J = np.empty(cap, dtype=np.int32)
    V = np.empty(cap, dtype=np.float64)
    got = lib.bis_parse_triplets(buf, len(buf), cap,
                                 1 if with_value else 0, pattern_value,
                                 I, J, V)
    if got < 0:
        raise ValueError("malformed matrix market entry")
    return I[:got], J[:got], V[:got]


def coo_to_csr(nnz, n_rows, n_cols, I, J, V):
    """(row_ptr, col, val) row-major sorted, or None.  Raises on
    duplicates."""
    lib = _load()
    if lib is None:
        return None
    I, J, V = _as(I, np.int32), _as(J, np.int32), _as(V, np.float64)
    row_ptr = np.empty(n_rows + 1, dtype=np.int64)
    col = np.empty(nnz, dtype=np.int32)
    val = np.empty(nnz, dtype=np.float64)
    rc = lib.bis_coo_to_csr(nnz, n_rows, n_cols, I, J, V, row_ptr, col, val)
    if rc == -2:
        raise ValueError("duplicate (row, col) entries in COO matrix")
    if rc != 0:
        raise ValueError("COO indices out of range")
    return row_ptr, col, val


def coo_dedup_csr(nnz, n_rows, n_cols, I, J, V):
    """CSR with duplicate (i, j) entries summed in input order (stable LSD
    sorts: bit-equal to a stable argsort + add.at), or None."""
    lib = _load()
    if lib is None:
        return None
    I, J, V = _as(I, np.int32), _as(J, np.int32), _as(V, np.float64)
    row_ptr = np.empty(n_rows + 1, dtype=np.int64)
    col = np.empty(max(1, nnz), dtype=np.int32)
    val = np.empty(max(1, nnz), dtype=np.float64)
    out = lib.bis_coo_dedup_csr(nnz, n_rows, n_cols, I, J, V,
                                row_ptr, col, val)
    if out < 0:
        raise ValueError("COO indices out of range")
    return row_ptr, col[:out].copy(), val[:out].copy()


def split_lu(A):
    """(L, L_strict, U, U_strict) MatrixCSR, or None."""
    lib = _load()
    if lib is None:
        return None
    from .matrix import MatrixCSR
    n = A.n_rows
    rp = _as(A.row_ptr, np.int64)
    cl = _as(A.col, np.int32)
    vl = _as(A.val, np.float64)
    ptrs = [np.empty(n + 1, dtype=np.int64) for _ in range(4)]
    lib.bis_split_lu_count(n, rp, cl, *ptrs)
    outs = []
    args = [n, rp, cl, vl]
    for ptr in ptrs:
        nnz = int(ptr[-1])
        c = np.empty(nnz, dtype=np.int32)
        v = np.empty(nnz, dtype=np.float64)
        outs.append((ptr, c, v))
        args += [ptr, c, v]
    lib.bis_split_lu_fill(*args)
    return tuple(MatrixCSR(n, A.n_cols, int(p[-1]), p, c, v)
                 for (p, c, v) in outs)


def peel_diag(A, zero_tol: float, check_missing: bool, check_zero: bool):
    """Dense diagonal of A, or None.  Raises factor.py's errors on a
    missing or zero diagonal."""
    lib = _load()
    if lib is None:
        return None
    D = np.empty(A.n_rows, dtype=np.float64)
    bad_row = np.empty(1, dtype=np.int64)
    flags = (1 if check_missing else 0) | (2 if check_zero else 0)
    rc = lib.bis_peel_diag(A.n_rows, _as(A.row_ptr, np.int64),
                           _as(A.col, np.int32), _as(A.val, np.float64),
                           zero_tol, flags, D, bad_row)
    if rc < 0:
        from .factor import MissingDiagonalError, ZeroDiagonalError
        if rc == -4:
            raise ZeroDiagonalError(
                f"ERROR: Zero diagonal element in row {int(bad_row[0])}")
        if rc == -3:
            raise MissingDiagonalError(
                f"ERROR: No diagonal element found in row {int(bad_row[0])}")
        raise RuntimeError(f"bis_peel_diag failed with code {rc}")
    return D


def ilu0(A, pivot_tolerance: float, pivot_replacement: float):
    """In-pattern ILU(0) values (a modified copy of A.val), or None."""
    lib = _load()
    if lib is None:
        return None
    lu_val = _as(A.val, np.float64).copy()
    rc = lib.bis_ilu0(A.n_rows, A.n_cols, _as(A.row_ptr, np.int64),
                      _as(A.col, np.int32), lu_val,
                      pivot_tolerance, pivot_replacement)
    if rc < 0:
        from .factor import MissingDiagonalError
        raise MissingDiagonalError(
            "ERROR: ILU(0) requires a full diagonal; missing in row "
            f"{-rc - 1000}")
    return lu_val


def level_sets(T_strict, upper: bool = False):
    """Wavefront level per row, or None."""
    lib = _load()
    if lib is None:
        return None
    level = np.empty(T_strict.n_rows, dtype=np.int32)
    lib.bis_level_sets(T_strict.n_rows, _as(T_strict.row_ptr, np.int64),
                       _as(T_strict.col, np.int32), 1 if upper else 0, level)
    return level


def level_sets_upper(T_strict):
    return level_sets(T_strict, upper=True)


def greedy_color(A, balanced: bool):
    """Greedy (first-fit or balanced) colouring of the CSR graph, or
    None."""
    lib = _load()
    if lib is None:
        return None
    colors = np.empty(A.n_rows, dtype=np.int32)
    lib.bis_greedy_color(A.n_rows, _as(A.row_ptr, np.int64),
                         _as(A.col, np.int32), 1 if balanced else 0, colors)
    return colors


def bfs_perm(A, reverse: bool, sort_by_degree: bool):
    """BFS/RCM ordering (perm[new] = old), or None."""
    lib = _load()
    if lib is None:
        return None
    perm = np.empty(A.n_rows, dtype=np.int32)
    lib.bis_bfs_perm(A.n_rows, _as(A.row_ptr, np.int64), _as(A.col, np.int32),
                     1 if reverse else 0, 1 if sort_by_degree else 0, perm)
    return perm


def csr_to_ell_pack(A, K: int, dtype):
    """(data, cols) padded-row ELL planes in one C sweep, or None."""
    lib = _load()
    d32 = _dtype32(dtype)
    if lib is None or d32 is None:
        return None
    cols = np.zeros((A.n_rows, K), dtype=np.int32)
    data = np.zeros((A.n_rows, K), dtype=dtype)
    lib.bis_csr_to_ell_pack(
        A.n_rows, _as(A.row_ptr, np.int64), _as(A.col, np.int32),
        _as(A.val, np.float64), K, d32,
        cols, data.ctypes.data_as(ctypes.c_void_p))
    return data, cols


def csr_to_dia_pack(A, offsets, npad: int, dtype):
    """(n_diags, npad) DIA data planes in one C sweep, or None."""
    lib = _load()
    d32 = _dtype32(dtype)
    if lib is None or d32 is None:
        return None
    offsets = _as(np.asarray(offsets), np.int64)
    data = np.zeros((max(1, len(offsets)), npad), dtype=dtype)
    lib.bis_csr_to_dia_pack(
        A.n_rows, _as(A.row_ptr, np.int64), _as(A.col, np.int32),
        _as(A.val, np.float64), offsets, len(offsets), npad, d32,
        data.ctypes.data_as(ctypes.c_void_p))
    return data


def csr_pattern_stats(A, cap: int = 4096):
    """One-pass pattern stats: (offsets, or None past `cap` distinct
    diagonals; lane span; columns strictly ascending), or None."""
    lib = _load()
    if lib is None:
        return None
    offs = np.empty(max(1, cap), dtype=np.int64)
    stats = np.zeros(3, dtype=np.int64)
    lib.bis_csr_pattern_stats(A.n_rows, A.n_cols, _as(A.row_ptr, np.int64),
                              _as(A.col, np.int32), cap, offs, stats)
    n_diags = int(stats[0])
    return ((offs[:n_diags].copy() if n_diags >= 0 else None),
            int(stats[1]), bool(stats[2]))


def lane_ell_build(A, K: int, S: int, R_pad: int, dtype):
    """Lane-ELL planes (vals, idx, slot_ranges) straight off the CSR in two
    C sweeps, or None (no library, a dtype the packer does not write, or
    columns not strictly ascending: the NumPy branch takes those)."""
    lib = _load()
    d32 = _dtype32(dtype)
    if lib is None or d32 is None:
        return None
    lo = np.empty(K, dtype=np.int32)
    hi = np.empty(K, dtype=np.int32)
    if lib.bis_lane_ell_ranges(A.n_rows, _as(A.row_ptr, np.int64),
                               _as(A.col, np.int32), K, lo, hi) != 0:
        return None
    vals = np.empty((K, R_pad, 128), dtype=dtype)
    idx = np.empty((K, R_pad, 128), dtype=np.int32)
    lib.bis_lane_ell_pack(
        A.n_rows, _as(A.row_ptr, np.int64), _as(A.col, np.int32),
        _as(A.val, np.float64), K, S, R_pad, lo, d32,
        vals.ctypes.data_as(ctypes.c_void_p), idx)
    ranges = tuple((int(a), int(b)) for a, b in zip(lo, hi))
    return vals, idx, ranges


def permute_factor_csr(A, perm, inv_perm, pivot_tolerance: float,
                       pivot_replacement: float):
    """P A Pᵀ and its in-pattern ILU(0) in one C sweep: (Ap, lu_val), Ap's
    .val being lu_val, or None.  Raises MissingDiagonalError as ilu0."""
    lib = _load()
    if lib is None or A.n_rows != A.n_cols:
        return None
    from .matrix import MatrixCSR
    row_ptr = np.empty(A.n_rows + 1, dtype=np.int64)
    col = np.empty(A.nnz, dtype=np.int32)
    lu_val = np.empty(A.nnz, dtype=np.float64)
    perm = _as(perm, np.int32)
    rc = lib.bis_permute_factor_csr(
        A.n_rows, _as(A.row_ptr, np.int64), _as(A.col, np.int32),
        _as(A.val, np.float64), perm, _as(inv_perm, np.int32),
        pivot_tolerance, pivot_replacement, row_ptr, col, lu_val)
    if rc < 0:
        from .factor import MissingDiagonalError
        raise MissingDiagonalError(
            "ERROR: ILU(0) requires a full diagonal; missing in row "
            f"{int(perm[int(-rc - 1000)])}")
    return MatrixCSR(A.n_rows, A.n_cols, A.nnz, row_ptr, col, lu_val), lu_val


def permute_csr(A, perm, inv_perm):
    """A' = P A Pᵀ as a new MatrixCSR, or None."""
    lib = _load()
    if lib is None:
        return None
    from .matrix import MatrixCSR
    row_ptr = np.empty(A.n_rows + 1, dtype=np.int64)
    col = np.empty(A.nnz, dtype=np.int32)
    val = np.empty(A.nnz, dtype=np.float64)
    lib.bis_permute_csr(A.n_rows, _as(A.row_ptr, np.int64),
                        _as(A.col, np.int32), _as(A.val, np.float64),
                        _as(perm, np.int32), _as(inv_perm, np.int32),
                        row_ptr, col, val)
    return MatrixCSR(A.n_rows, A.n_cols, A.nnz, row_ptr, col, val)


def spmv_csr(A, x):
    """y = A @ x on the host (the test oracle), or None."""
    lib = _load()
    if lib is None:
        return None
    y = np.empty(A.n_rows, dtype=np.float64)
    lib.bis_spmv_csr(A.n_rows, _as(A.row_ptr, np.int64), _as(A.col, np.int32),
                     _as(A.val, np.float64), _as(x, np.float64), y)
    return y


def hpcg_csr(nx: int, ny: int, nz: int, diag: float, off: float):
    """The 27-point stencil's CSR (row_ptr, col, val), or None."""
    lib = _load()
    if lib is None:
        return None
    n = nx * ny * nz
    nnz = (3 * nx - 2) * (3 * ny - 2) * (3 * nz - 2)
    row_ptr = np.empty(n + 1, dtype=np.int64)
    col = np.empty(nnz, dtype=np.int32)
    val = np.empty(nnz, dtype=np.float64)
    lib.bis_hpcg_csr(nx, ny, nz, diag, off, row_ptr, col, val)
    return row_ptr, col, val


def expand_perm_triplets(Ap, lu_val, perm):
    """(rows_o, cols_o int32, U_D): permuted-CSR factor values mapped back
    to the original ordering, or None."""
    lib = _load()
    if lib is None:
        return None
    n = Ap.n_rows
    rows_o = np.empty(Ap.nnz, dtype=np.int32)
    cols_o = np.empty(Ap.nnz, dtype=np.int32)
    U_D = np.zeros(n, dtype=np.float64)
    lib.bis_expand_perm_triplets(n, _as(Ap.row_ptr, np.int64),
                                 _as(Ap.col, np.int32),
                                 _as(lu_val, np.float64),
                                 _as(perm, np.int32), rows_o, cols_o, U_D)
    return rows_o, cols_o, U_D


_SB_KEYS = ("cross_lo", "self_lo", "cross_up", "self_up")


def _sb_result(rc, bufs, counts):
    if rc == -10:
        from .ops.block_trisolve import ImproperColoringError
        raise ImproperColoringError("coloring is not proper for this pattern")
    if rc != 0:
        return None
    return {k: bufs[i][:counts[i]].copy() for i, k in enumerate(_SB_KEYS)}


def sb_analyze(rows, cols, nx, ny, nz, sx, sy, sz, cap: int):
    """One-pass superblock group discovery for both triangles:
    {'cross_lo', 'self_lo', 'cross_up', 'self_up'} ascending int64 keys, or
    None (no library, indices past int32, or a structural refusal: the
    NumPy builder then raises in its order).  An improper colouring raises
    ImproperColoringError (a verdict that does not depend on scan order)."""
    lib = _load()
    if lib is None or len(rows) and (rows.max() >= 2**31
                                     or cols.max() >= 2**31):
        return None
    rows32 = _as(rows, np.int32)
    cols32 = _as(cols, np.int32)
    bufs = [np.empty(cap, dtype=np.int64) for _ in range(4)]
    counts = np.zeros(4, dtype=np.int64)
    rc = lib.bis_sb_analyze(len(rows32), rows32, cols32, nx, ny, nz,
                            sx, sy, sz, cap, *bufs, counts)
    return _sb_result(rc, bufs, counts)


def sb_analyze_csr(Ap, perm, nx, ny, nz, sx, sy, sz, cap: int):
    """sb_analyze straight off the colour-permuted CSR (row i of Ap is
    original row perm[i]); the same contract."""
    lib = _load()
    if lib is None or Ap.n_rows >= 2**31:
        return None
    bufs = [np.empty(cap, dtype=np.int64) for _ in range(4)]
    counts = np.zeros(4, dtype=np.int64)
    rc = lib.bis_sb_analyze_csr(Ap.n_rows, _as(Ap.row_ptr, np.int64),
                                _as(Ap.col, np.int32), _as(perm, np.int32),
                                nx, ny, nz, sx, sy, sz, cap, *bufs, counts)
    return _sb_result(rc, bufs, counts)


def sb_scatter_csr(Ap, lu_val, perm, nx, ny, nz, sx, sy, sz, analysis,
                   stride_lo: int, stride_up: int,
                   pc_lo, ps_lo, pc_up, ps_up) -> Optional[np.ndarray]:
    """Fill both triangles' (zeroed) group planes, row g of a plane at
    g·stride + slot, and peel the diagonal, in one pass over the permuted
    CSR; returns the diagonal U_D, or None."""
    lib = _load()
    if lib is None:
        return None
    U_D = np.zeros(Ap.n_rows, dtype=np.float64)
    args = []
    for k in _SB_KEYS:
        uk = _as(analysis[k], np.int64)
        args += [uk, len(uk)]
    rc = lib.bis_sb_scatter_csr(
        Ap.n_rows, _as(Ap.row_ptr, np.int64), _as(Ap.col, np.int32),
        _as(lu_val, np.float64), _as(perm, np.int32),
        nx, ny, nz, sx, sy, sz, *args, stride_lo, stride_up,
        _dtype32(pc_lo.dtype),
        pc_lo.ctypes.data_as(ctypes.c_void_p),
        ps_lo.ctypes.data_as(ctypes.c_void_p),
        pc_up.ctypes.data_as(ctypes.c_void_p),
        ps_up.ctypes.data_as(ctypes.c_void_p), U_D)
    if rc != 0:
        raise RuntimeError(f"bis_sb_scatter_csr failed with code {rc}")
    return U_D


def sb_scatter(rows, cols, vals, nx, ny, nz, sx, sy, sz, upper: bool,
               ukc, uks, stride: int, planes_cross, planes_self) -> bool:
    """Scatter one triangle's values into the (zeroed) group planes laid
    out in key order, row g at g·stride + slot; False where the library
    is switched off."""
    lib = _load()
    if lib is None:
        return False
    rows32 = _as(rows, np.int32)
    cols32 = _as(cols, np.int32)
    rc = lib.bis_sb_scatter(
        len(rows32), rows32, cols32, _as(vals, np.float64),
        nx, ny, nz, sx, sy, sz, 1 if upper else 0,
        _as(ukc, np.int64), len(ukc), _as(uks, np.int64), len(uks),
        stride, _dtype32(planes_cross.dtype),
        planes_cross.ctypes.data_as(ctypes.c_void_p),
        planes_self.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError(f"bis_sb_scatter failed with code {rc}")
    return True
