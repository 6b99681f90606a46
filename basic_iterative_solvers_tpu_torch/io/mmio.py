"""Matrix Market I/O: the NumPy branch of the JAX package's io/mmio.py.

* only ``matrix coordinate {real|integer|pattern} {general|symmetric}`` is
  accepted;
* pattern matrices get every value set to 0.01;
* symmetric storage is expanded to general by mirroring the off-diagonal
  entries;
* 1-based indices become 0-based, and entries are sorted row-major.
"""
from __future__ import annotations

import io as _io

import numpy as np

from ..matrix import MatrixCOO, MatrixCSR, convert_coo_to_csr, csr_to_coo

_SUPPORTED_FIELDS = ("real", "integer", "pattern")
_SUPPORTED_SYMMETRIES = ("general", "symmetric")
_PATTERN_VALUE = 0.01


class MatrixMarketError(ValueError):
    pass


def _parse_banner(line: str):
    parts = line.strip().split()
    if len(parts) != 5 or parts[0] != "%%MatrixMarket":
        raise MatrixMarketError(
            f"Could not process Matrix Market banner: {line!r}")
    _, obj, fmt, field, symmetry = (p.lower() for p in parts)
    if obj != "matrix" or fmt != "coordinate":
        raise MatrixMarketError(
            f"Unsupported matrix format (object={obj}, format={fmt}); "
            "only sparse 'matrix coordinate' files are supported")
    if field not in _SUPPORTED_FIELDS:
        raise MatrixMarketError(f"Unsupported field type: {field}")
    if symmetry not in _SUPPORTED_SYMMETRIES:
        raise MatrixMarketError(f"Unsupported symmetry: {symmetry}")
    return field, symmetry


def read_mtx_coo(path_or_file, require_square: bool = False) -> MatrixCOO:
    """Read a Matrix Market coordinate file into sorted COO."""
    if hasattr(path_or_file, "read"):
        text = path_or_file.read()
        if isinstance(text, bytes):
            text = text.decode()
    else:
        with open(path_or_file, "r") as f:
            text = f.read()
    nl = text.find("\n")
    if nl < 0:
        raise MatrixMarketError("empty file")
    field, symmetry = _parse_banner(text[:nl])
    size_line = None
    data_start = nl + 1
    for line in _io.StringIO(text[nl + 1:]):
        stripped = line.strip()
        data_start += len(line)
        if not stripped or stripped.startswith("%"):
            continue
        size_line = stripped
        break
    if size_line is None:
        raise MatrixMarketError("missing size line")
    sizes = size_line.split()
    if len(sizes) != 3:
        raise MatrixMarketError(f"bad size line: {size_line!r}")
    n_rows, n_cols, nnz_stored = (int(s) for s in sizes)
    if require_square and n_rows != n_cols:
        raise MatrixMarketError("Matrix must be square.")

    data = _io.StringIO(text[data_start:])
    if field == "pattern":
        arr = (np.loadtxt(data, dtype=np.int64, ndmin=2, comments="%")
               if nnz_stored else np.zeros((0, 2), np.int64))
        if arr.size and arr.shape[1] != 2:
            raise MatrixMarketError("pattern entries must have 2 fields")
        V = np.full(arr.shape[0], _PATTERN_VALUE, dtype=np.float64)
    else:
        arr = (np.loadtxt(data, dtype=np.float64, ndmin=2, comments="%")
               if nnz_stored else np.zeros((0, 3)))
        if arr.size and arr.shape[1] != 3:
            raise MatrixMarketError("coordinate entries must have 3 fields")
        V = arr[:, 2].astype(np.float64)
    I = arr[:, 0].astype(np.int64) - 1
    J = arr[:, 1].astype(np.int64) - 1
    if I.shape[0] != nnz_stored:
        raise MatrixMarketError(
            f"expected {nnz_stored} entries, found {I.shape[0]}")
    if symmetry == "symmetric":
        off = I != J
        I, J, V = (np.concatenate([I, J[off]]), np.concatenate([J, I[off]]),
                   np.concatenate([V, V[off]]))
    return MatrixCOO.from_arrays(I, J, V, n_rows=n_rows, n_cols=n_cols,
                                 is_symmetric=(symmetry == "symmetric")
                                 ).sort()


def read_mtx(path_or_file, require_square: bool = True) -> MatrixCSR:
    """Read a .mtx file straight to CSR."""
    return convert_coo_to_csr(read_mtx_coo(path_or_file, require_square))


def write_mtx(path, mat, comment: str = "") -> None:
    """Write CSR or COO as 'matrix coordinate real general'."""
    coo = csr_to_coo(mat) if isinstance(mat, MatrixCSR) else mat.sort()
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        for line in comment.splitlines():
            f.write(f"% {line}\n")
        f.write(f"{coo.n_rows} {coo.n_cols} {coo.nnz}\n")
        np.savetxt(f, np.column_stack([coo.I + 1, coo.J + 1, coo.values]),
                   fmt=("%d", "%d", "%.17g"))
