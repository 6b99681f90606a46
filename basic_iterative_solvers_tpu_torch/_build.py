"""Build and load the port's hand-written CUDA kernels.

The sources under `csrc/` are compiled by `nvcc` for Hopper (sm_90a), one
`nvcc` per source, all started together, and linked into one shared
library with a plain C interface, loaded with ctypes.  The library is built
at first use into `build/kernels/` beside the package, keyed by a hash of
the sources and flags, so a checkout needs nothing prebuilt.  Import this
module only on the path that launches a kernel: the CPU tests import
everything else on machines with no `nvcc`.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent
SOURCES = tuple(_PKG / "csrc" / name
                for name in ("stencil_spmv.cu", "gmres_basis.cu",
                             "block_trisolve.cu", "sparse_spmv.cu"))
BUILD_DIR = _PKG.parent / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

MAX_LEGS = 27
MAX_DOTS = 3
#: the most DIA offsets the kernel takes by value (the JAX package's
#: SolverConfig.dia_max_diags default)
MAX_DIAGS = 96


class StencilArgs(ctypes.Structure):
    """ctypes mirror of `BisStencilArgs` in csrc/stencil_spmv.cu."""

    _fields_ = [
        ("off", ctypes.c_longlong * MAX_LEGS),
        ("group_coeff", ctypes.c_double * MAX_LEGS),
        ("dx", ctypes.c_int * MAX_LEGS),
        ("dy", ctypes.c_int * MAX_LEGS),
        ("dz", ctypes.c_int * MAX_LEGS),
        ("group_begin", ctypes.c_int * (MAX_LEGS + 1)),
        ("n_groups", ctypes.c_int),
        ("nx", ctypes.c_int), ("ny", ctypes.c_int), ("nz", ctypes.c_int),
        ("block_x", ctypes.c_int), ("block_y", ctypes.c_int),
        ("grid_x", ctypes.c_int), ("grid_y", ctypes.c_int),
        ("n_dots", ctypes.c_int),
        ("dot_kind", ctypes.c_int * MAX_DOTS),
    ]


class SuperLevelArgs(ctypes.Structure):
    """ctypes mirror of `BisSuperLevelArgs` in csrc/block_trisolve.cu."""

    _fields_ = [
        ("cross_off", ctypes.c_longlong * MAX_LEGS),
        ("cross_coeff", ctypes.c_double * MAX_LEGS),
        ("self_coeff", ctypes.c_double * MAX_LEGS),
        ("dinv", ctypes.c_double),
        ("cross_delta", ctypes.c_longlong * MAX_LEGS),
        ("m", ctypes.c_longlong),
        ("cross_dx", ctypes.c_int * MAX_LEGS),
        ("cross_dy", ctypes.c_int * MAX_LEGS),
        ("cross_dz", ctypes.c_int * MAX_LEGS),
        ("self_dx", ctypes.c_int * MAX_LEGS),
        ("n_cross", ctypes.c_int), ("n_self", ctypes.c_int),
        ("nx", ctypes.c_int), ("ny", ctypes.c_int), ("nz", ctypes.c_int),
        ("sx", ctypes.c_int), ("sy", ctypes.c_int), ("sz", ctypes.c_int),
        ("py", ctypes.c_int), ("pz", ctypes.c_int),
        ("my", ctypes.c_int), ("lines", ctypes.c_int),
        ("upper", ctypes.c_int),
        ("block_x", ctypes.c_int), ("block_y", ctypes.c_int),
        ("grid_x", ctypes.c_int),
        ("cross_kd", ctypes.c_int * MAX_LEGS),
        ("self_kd", ctypes.c_int * MAX_LEGS),
        ("proto_x", ctypes.c_int), ("proto_y", ctypes.c_int),
        ("proto_z", ctypes.c_int),
        ("radius", ctypes.c_int), ("n_proto", ctypes.c_int),
        ("cross_spy", ctypes.c_int * MAX_LEGS),
        ("cross_spz", ctypes.c_int * MAX_LEGS),
        ("mode", ctypes.c_int),
    ]


class DiaArgs(ctypes.Structure):
    """ctypes mirror of `BisDiaArgs` in csrc/sparse_spmv.cu."""

    _fields_ = [("off", ctypes.c_longlong * MAX_DIAGS),
                ("n", ctypes.c_longlong),
                ("n_diags", ctypes.c_int)]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    candidates = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    candidates.append(shutil.which("nvcc"))
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (looked under CUDA_HOME and on PATH); "
                       "the CUDA kernels cannot be built")


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libbis_torch_kernels_{h.hexdigest()[:16]}.so"


def _run(cmds):
    """Run the commands concurrently; raise, naming the first that failed."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    outs = [(cmd, proc.communicate()[0], proc.returncode)
            for cmd, proc in procs]
    for cmd, out, rc in outs:
        if rc != 0:
            raise RuntimeError(f"kernel build failed ({rc}): "
                               f"{' '.join(cmd)}\n{out}")


def build() -> Path:
    """Compile the kernel library unless a build of these sources exists;
    returns its path.  Raises, naming the command, if the build fails."""
    lib = _library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in SOURCES]
        _run([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
              for obj, src in zip(objs, SOURCES)])
        out = os.path.join(tmp, lib.name)
        _run([[nvcc, *ARCH_FLAGS, "-shared", "-o", out, *objs]])
        os.replace(out, lib)      # atomic: concurrent builders both succeed
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every entry
    point's argument and result types declared."""
    lib = ctypes.CDLL(str(build()))
    ptr = ctypes.c_void_p
    for name in ("bis_stencil_spmv_f32", "bis_stencil_spmv_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(StencilArgs), ptr, ptr,
                       ptr, ptr, ptr, ptr]
        fn.restype = ctypes.c_int
    i64, i32 = ctypes.c_longlong, ctypes.c_int
    for suffix in ("f32", "bf16"):
        fn = getattr(lib, f"bis_gmres_project_gram_{suffix}")
        fn.argtypes = [i32, ptr, ptr, ptr, i64, i32, i32, ptr, i32, ptr]
        fn.restype = i32
        fn = getattr(lib, f"bis_gmres_correct_write_{suffix}")
        fn.argtypes = [i32, ptr, ptr, ptr, i64, i32, ptr, ptr, i32, ptr]
        fn.restype = i32
    for dt in ("f32", "f64"):
        fn = getattr(lib, f"bis_stencil_gs_color_step_{dt}")
        fn.argtypes = [i32, ctypes.POINTER(StencilArgs), i32, i32, i32, i32,
                       i32, ptr, ptr, ptr, ptr, ptr, ptr]
        fn.restype = i32
        level = ctypes.POINTER(SuperLevelArgs)
        for name, args in (("super_level", [ptr] * 8),
                           ("super_acc", [ptr] * 6),
                           ("super_parity", [i32] + [ptr] * 8),
                           ("super_solve_mega", [i32] * 4 + [ptr] * 4)):
            fn = getattr(lib, f"bis_{name}_{dt}")
            fn.argtypes = [i32, level if name != "super_solve_mega"
                           else ptr] + args
            fn.restype = i32
        fn = getattr(lib, f"bis_dia_spmv_{dt}")
        fn.argtypes = [i32, ctypes.POINTER(DiaArgs), ptr, ptr, ptr, ptr]
        fn.restype = i32
        fn = getattr(lib, f"bis_lane_ell_spmv_{dt}")
        fn.argtypes = [i32, ptr, ptr, ptr, ptr, i64, i64, i32, i32, ptr]
        fn.restype = i32
        fn = getattr(lib, f"bis_rank_level_{dt}")
        fn.argtypes = [i32, ptr, ptr, ptr, ptr, ptr, i32, i64, i32, ptr]
        fn.restype = i32
    lib.bis_super_solve_mega_grid.argtypes = [i32] * 4
    lib.bis_super_solve_mega_grid.restype = i32
    for size_fn, mirror, source in (
            (lib.bis_stencil_args_size, StencilArgs,
             "BisStencilArgs in csrc/stencil_spmv.cu"),
            (lib.bis_super_level_args_size, SuperLevelArgs,
             "BisSuperLevelArgs in csrc/block_trisolve.cu"),
            (lib.bis_dia_args_size, DiaArgs,
             "BisDiaArgs in csrc/sparse_spmv.cu")):
        size_fn.argtypes = []
        size_fn.restype = ctypes.c_int
        if size_fn() != ctypes.sizeof(mirror):
            raise RuntimeError(f"{mirror.__name__} does not match {source}")
    return lib
