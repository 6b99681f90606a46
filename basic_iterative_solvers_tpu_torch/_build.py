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
#: the header every source includes (the launchers' device check)
HEADERS = (_PKG / "csrc" / "bis_device.cuh",)
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
        ("box_mask", ctypes.c_int * MAX_LEGS),
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
        ("y_row0", ctypes.c_longlong), ("x_row0", ctypes.c_longlong),
        ("slot0", ctypes.c_longlong), ("plane_m", ctypes.c_longlong),
        ("cross_dx", ctypes.c_int * MAX_LEGS),
        ("cross_dy", ctypes.c_int * MAX_LEGS),
        ("cross_dz", ctypes.c_int * MAX_LEGS),
        ("self_dx", ctypes.c_int * MAX_LEGS),
        ("n_cross", ctypes.c_int), ("n_self", ctypes.c_int),
        ("nx", ctypes.c_int), ("ny", ctypes.c_int), ("nz", ctypes.c_int),
        ("sx", ctypes.c_int), ("sy", ctypes.c_int), ("sz", ctypes.c_int),
        ("py", ctypes.c_int), ("pz", ctypes.c_int),
        ("my", ctypes.c_int), ("lines", ctypes.c_int),
        ("line0", ctypes.c_int),
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
        ("cross_rx", ctypes.c_int), ("cross_ry", ctypes.c_int),
        ("cross_rz", ctypes.c_int),
        ("cross_q", ctypes.c_int * MAX_LEGS),
        ("cross_r", ctypes.c_int * MAX_LEGS),
    ]


#: the rank-space level's vec route: its largest group bucket
#: (BIS_RV_MAX_GROUPS in csrc/block_trisolve.cu)
RANK_VEC_GROUPS = 8


class RankVecArgs(ctypes.Structure):
    """ctypes mirror of `BisRankVecArgs` in csrc/block_trisolve.cu."""

    _fields_ = [
        ("M", ctypes.c_longlong),
        ("c", ctypes.c_int),
        ("n_groups", ctypes.c_int),
        ("cpt", ctypes.c_int),
        ("plane", ctypes.c_int * RANK_VEC_GROUPS),
        ("src", ctypes.c_int * RANK_VEC_GROUPS),
        ("base", ctypes.c_int * RANK_VEC_GROUPS),
        ("nvec", ctypes.c_int * RANK_VEC_GROUPS),
        ("shift", ctypes.c_int * RANK_VEC_GROUPS),
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
    for src in SOURCES + HEADERS:
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


def launch(fn, device, *args) -> int:
    """Call the library's launcher `fn(device index, *args, stream)` on
    `device`: under torch.cuda.device(device), on that device's current
    stream.  Every hand-kernel launch goes through here, so a mesh shard's
    launch runs on its own card and the process's current device is the
    same afterwards; the launchers check that they run on the device they
    are given and never switch it.  Returns the launcher's CUDA error."""
    import torch
    with torch.cuda.device(device):
        return fn(device.index, *args,
                  torch.cuda.current_stream(device).cuda_stream)


def query(fn, index: int, *args):
    """Call the library's card query `fn(index, *args)` under
    torch.cuda.device(index), as `launch` calls a launcher: the queries
    check the card as the launchers do."""
    import torch
    with torch.cuda.device(index):
        return fn(index, *args)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every entry
    point's argument and result types declared."""
    lib = ctypes.CDLL(str(build()))
    ptr = ctypes.c_void_p
    i64, i32 = ctypes.c_longlong, ctypes.c_int
    # "_bf16": the form that takes bfloat16 matrix data (a stencil's
    # diagonal, DIA data, lane-ELL values) beside vectors of the named type
    for name in ("bis_stencil_spmv_f32", "bis_stencil_spmv_f64",
                 "bis_stencil_spmv_f32_bf16", "bis_stencil_spmv_f64_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = [i32, ctypes.POINTER(StencilArgs), ptr, ptr,
                       ptr, ptr, ptr, ptr]
        fn.restype = i32
        fn = getattr(lib, name.replace("spmv", "spmv_stream"))
        fn.argtypes = [i32, ctypes.POINTER(StencilArgs)] + [i32] * 4 + [
            ptr] * 6
        fn.restype = i32
        # the shard-local form: row0, lines, n, hneg, then the pointers
        fn = getattr(lib, name.replace("spmv", "spmv_halo"))
        fn.argtypes = [i32, ctypes.POINTER(StencilArgs)] + [i64] * 4 + [
            ptr] * 6
        fn.restype = i32
        # the shard-local form's box route: zr, grid, then row0, rows,
        # hneg, wlen
        fn = getattr(lib, name.replace("spmv", "spmv_halo_box"))
        fn.argtypes = [i32, ctypes.POINTER(StencilArgs)] + [i32] * 3 + [
            i64] * 4 + [ptr] * 6
        fn.restype = i32
        # the box routes: #1's vec, zr, grid; #2's zr, grid, slot
        fn = getattr(lib, name.replace("spmv", "spmv_box"))
        fn.argtypes = [i32, ctypes.POINTER(StencilArgs)] + [i32] * 4 + [
            ptr] * 6
        fn.restype = i32
        fn = getattr(lib, name.replace("spmv", "spmv_stream_box"))
        fn.argtypes = [i32, ctypes.POINTER(StencilArgs)] + [i32] * 4 + [
            ptr] * 6
        fn.restype = i32
    lib.bis_stencil_stream_tile.argtypes = [ctypes.POINTER(i32)] * 4
    lib.bis_stencil_stream_tile.restype = i32
    lib.bis_stencil_box_shape.argtypes = [ctypes.POINTER(i32)] * 4
    lib.bis_stencil_box_shape.restype = i32
    for suffix in ("f32", "bf16"):
        fn = getattr(lib, f"bis_gmres_project_gram_strided_{suffix}")
        fn.argtypes = [i32, ptr, ptr, ptr, i64, i32, i32, ptr, i32, ptr]
        fn.restype = i32
        fn = getattr(lib, f"bis_gmres_correct_write_strided_{suffix}")
        fn.argtypes = [i32, ptr, ptr, ptr, i64, i32, ptr, ptr, i32, ptr]
        fn.restype = i32
        # ..., partials, gp, gpart, gq, out, tickets, grid, stream
        fn = getattr(lib, f"bis_gmres_project_gram_ring_{suffix}")
        fn.argtypes = [i32, ptr, ptr, ptr, i64, i32, i32, ptr, i32, ptr,
                       i32, ptr, ptr, i32, ptr]
        fn.restype = i32
        fn = getattr(lib, f"bis_gmres_correct_write_ring_{suffix}")
        fn.argtypes = [i32, ptr, ptr, ptr, i64, i32, ptr, ptr, i32, ptr,
                       i32, ptr, ptr, i32, ptr]
        fn.restype = i32
    lib.bis_gmres_ring_blocks_per_sm.argtypes = [i32, i32, ctypes.POINTER(i32)]
    lib.bis_gmres_ring_blocks_per_sm.restype = i32
    lib.bis_gmres_ring_shape.argtypes = [ctypes.POINTER(i32)] * 5
    lib.bis_gmres_ring_shape.restype = None
    for dt in ("f32", "f64", "f32_bf16", "f64_bf16"):
        fn = getattr(lib, f"bis_stencil_gs_color_step_{dt}")
        fn.argtypes = [i32, ctypes.POINTER(StencilArgs), i32, i32, i32, i32,
                       i32, ptr, ptr, ptr, ptr, ptr, ptr]
        fn.restype = i32
        fn = getattr(lib, f"bis_stencil_gs_color_step_halo_{dt}")
        fn.argtypes = [i32, ctypes.POINTER(StencilArgs)] + [i32] * 5 + [
            i64] * 4 + [ptr] * 6
        fn.restype = i32
        # #3's box route: kind, p0-p2, colour, zr, grid_x, grid_y; the
        # shard form adds row0, rows, hneg, wlen
        fn = getattr(lib, f"bis_stencil_gs_color_step_box_{dt}")
        fn.argtypes = [i32, ctypes.POINTER(StencilArgs)] + [i32] * 8 + [
            ptr] * 6
        fn.restype = i32
        fn = getattr(lib, f"bis_stencil_gs_color_step_halo_box_{dt}")
        fn.argtypes = [i32, ctypes.POINTER(StencilArgs)] + [i32] * 8 + [
            i64] * 4 + [ptr] * 6
        fn.restype = i32
        fn = getattr(lib, f"bis_dia_spmv_{dt}")
        fn.argtypes = [i32, ctypes.POINTER(DiaArgs), ptr, ptr, ptr, ptr]
        fn.restype = i32
        fn = getattr(lib, f"bis_dia_spmv_halo_{dt}")
        fn.argtypes = [i32, ctypes.POINTER(DiaArgs), ptr, ptr, ptr, i64, i64,
                       ptr]
        fn.restype = i32
        # the counted routes: ..., n, plane, S, idx_bytes, len_bytes
        fn = getattr(lib, f"bis_lane_ell_spmv_{dt}")
        fn.argtypes = [i32] + [ptr] * 5 + [i64, i64] + [i32] * 3 + [ptr]
        fn.restype = i32
        # ..., rows, r0, halo, n, plane, S, wlen, idx_bytes, len_bytes
        fn = getattr(lib, f"bis_lane_ell_spmv_halo_{dt}")
        fn.argtypes = [i32] + [ptr] * 5 + [i64] * 5 + [i32, i64, i32, i32,
                                                         ptr]
        fn.restype = i32
        # the padded route: ..., plane, K, S, wlen, idx_bytes
        fn = getattr(lib, f"bis_lane_ell_spmv_halo_{dt}_padded")
        fn.argtypes = [i32, ptr, ptr, ptr, ptr] + [i64] * 5 + [i32, i32, i64,
                                                              i32, ptr]
        fn.restype = i32
    for dt in ("f32", "f64"):
        level = ctypes.POINTER(SuperLevelArgs)
        for name, args in (("super_level", [ptr] * 8),
                           ("super_acc", [ptr] * 6),
                           ("super_parity", [i32] + [ptr] * 8),
                           ("super_solve_mega", [i32] * 4 + [ptr] * 4)):
            fn = getattr(lib, f"bis_{name}_{dt}")
            fn.argtypes = [i32, level if name != "super_solve_mega"
                           else ptr] + args
            fn.restype = i32
        fn = getattr(lib, f"bis_rank_level_{dt}")
        fn.argtypes = [i32, ptr, ptr, ptr, ptr, ptr, i32, i64, i32, ptr]
        fn.restype = i32
        # the vec route: table, threads a block, y, x, vals, dinv, stream
        fn = getattr(lib, f"bis_rank_level_vec_{dt}")
        fn.argtypes = [i32, ctypes.POINTER(RankVecArgs), i32] + [ptr] * 5
        fn.restype = i32
    level = ctypes.POINTER(SuperLevelArgs)
    lib.bis_super_level_staged_f32.argtypes = [i32, level] + [ptr] * 5
    lib.bis_super_level_staged_f32.restype = i32
    lib.bis_super_level_staged_grid.argtypes = [level]
    lib.bis_super_level_staged_grid.restype = i32
    # the line route: ..., tl, lb, y, x, vc, vs, drows, stream
    for dt in ("f32", "f64"):
        fn = getattr(lib, f"bis_super_level_line_{dt}")
        fn.argtypes = [i32, level, i32, i32] + [ptr] * 6
        fn.restype = i32
        # the split route's staged and line kernels: acc staged (y, x,
        # acc, table), acc line (tl, lb, y, x, acc, vc), parity staged (p,
        # tl, lb, y, acc, x, table, tdinv), parity line (p, tl, lb, y, acc,
        # x, vs, drows); the stream last
        for name, args in (("super_acc_staged", [ptr] * 5),
                           ("super_acc_line", [i32] * 2 + [ptr] * 5),
                           ("super_parity_staged", [i32] * 3 + [ptr] * 6),
                           ("super_parity_line", [i32] * 3 + [ptr] * 6)):
            fn = getattr(lib, f"bis_{name}_{dt}")
            fn.argtypes = [i32, level] + args
            fn.restype = i32
    lib.bis_super_solve_mega_grid.argtypes = [i32] * 4
    lib.bis_super_solve_mega_grid.restype = i32
    # the brick route and its barrier floor: tables, n_levels, nx, ny, nz,
    # sy, sz, rx, ry, rz, by, bz, tl, lb, y, x, drows, stream
    for name in ("super_solve_brick", "super_solve_brick_floor"):
        for dt in ("f32", "f64"):
            fn = getattr(lib, f"bis_{name}_{dt}")
            fn.argtypes = [i32, ptr] + [i32] * 13 + [ptr] * 4
            fn.restype = i32
    lib.bis_super_solve_brick_resident.argtypes = [i32, i32, i32, i64]
    lib.bis_super_solve_brick_resident.restype = i32
    lib.bis_super_solve_brick_smem_optin.argtypes = [i32]
    lib.bis_super_solve_brick_smem_optin.restype = i32
    lib.bis_super_solve_brick_smem.argtypes = [i32] * 11
    lib.bis_super_solve_brick_smem.restype = i64
    lib.bis_super_solve_brick_threads.argtypes = []
    lib.bis_super_solve_brick_threads.restype = i32
    lib.bis_super_solve_brick_parts.argtypes = [i32] * 7 + [
        ctypes.POINTER(i32)] * 2
    lib.bis_super_solve_brick_parts.restype = i32
    for size_fn, mirror, source in (
            (lib.bis_stencil_args_size, StencilArgs,
             "BisStencilArgs in csrc/stencil_spmv.cu"),
            (lib.bis_super_level_args_size, SuperLevelArgs,
             "BisSuperLevelArgs in csrc/block_trisolve.cu"),
            (lib.bis_dia_args_size, DiaArgs,
             "BisDiaArgs in csrc/sparse_spmv.cu"),
            (lib.bis_rank_vec_args_size, RankVecArgs,
             "BisRankVecArgs in csrc/block_trisolve.cu")):
        size_fn.argtypes = []
        size_fn.restype = ctypes.c_int
        if size_fn() != ctypes.sizeof(mirror):
            raise RuntimeError(f"{mirror.__name__} does not match {source}")
    from .ops import gmres_basis as gb
    ring = [i32() for _ in range(5)]
    lib.bis_gmres_ring_shape(*[ctypes.byref(v) for v in ring])
    if tuple(v.value for v in ring) != (gb.RING_CONSUMERS, gb.RING_STAGE_VECS,
                                        gb.RING_STAGES, gb.RING_MAX_GRID,
                                        gb.RING_GROUP_BLOCKS):
        raise RuntimeError("ops/gmres_basis.RING_* do not match BIS_RING_* "
                           "in csrc/gmres_basis.cu")
    from .stencil_op import (BOX_RESIDENT, BOX_STAGES, BOX_THREADS,
                             STREAM_HALO, STREAM_TILE)
    tile = [i32() for _ in range(4)]
    lib.bis_stencil_stream_tile(*[ctypes.byref(v) for v in tile])
    if tuple(v.value for v in tile) != STREAM_TILE + STREAM_HALO[:2]:
        raise RuntimeError("stencil_op.STREAM_TILE/STREAM_HALO do not match "
                           "BIS_STREAM_* in csrc/stencil_spmv.cu")
    from .ops.block_trisolve import LINE_SMEM_MAX, LINE_THREADS
    limits = [i32() for _ in range(2)]
    lib.bis_super_level_line_limits.argtypes = [ctypes.POINTER(i32)] * 2
    lib.bis_super_level_line_limits.restype = None
    lib.bis_super_level_line_limits(*[ctypes.byref(v) for v in limits])
    if tuple(v.value for v in limits) != (LINE_THREADS, LINE_SMEM_MAX):
        raise RuntimeError("ops/block_trisolve.LINE_THREADS/LINE_SMEM_MAX do "
                           "not match BIS_SL_LINE_* in csrc/block_trisolve.cu")
    from .ops.block_trisolve import BRICK_THREADS, brick_parts, brick_smem
    parts = [i32() for _ in range(2)]
    lib.bis_super_solve_brick_parts(8, 16, 8, 1, 1, 2, 2,
                                    *[ctypes.byref(v) for v in parts])
    parts = tuple(v.value for v in parts)
    if lib.bis_super_solve_brick_threads() != BRICK_THREADS or parts != \
            brick_parts(8, 16, 8, 1, 1, 2, 2) or any(
            lib.bis_super_solve_brick_smem(4, 16, 8, 1, 1, 1, 2, 2, 128, item,
                                           d)
            != brick_smem(4, 16, 8, 1, 1, 1, 2, 2, 128, item, bool(d))
            for item in (4, 8) for d in (0, 1)):
        raise RuntimeError("ops/block_trisolve.BRICK_THREADS, brick_parts "
                           "or brick_smem do not match csrc/block_trisolve."
                           "cu")
    from .ops.block_trisolve import RANK_VEC_THREADS, RANK_VEC_WIN
    rv = [i32() for _ in range(3)]
    lib.bis_rank_vec_limits.argtypes = [ctypes.POINTER(i32)] * 3
    lib.bis_rank_vec_limits.restype = i32
    lib.bis_rank_vec_limits(*[ctypes.byref(v) for v in rv])
    if tuple(v.value for v in rv) != (RANK_VEC_GROUPS, RANK_VEC_WIN,
                                      RANK_VEC_THREADS):
        raise RuntimeError("RANK_VEC_GROUPS / ops/block_trisolve.RANK_VEC_* "
                           "do not match BIS_RV_* in csrc/block_trisolve.cu")
    from .stencil_op import GS_BOX_FLAT_RESIDENT
    lib.bis_stencil_gs_box_flat_blocks.argtypes = []
    lib.bis_stencil_gs_box_flat_blocks.restype = i32
    if lib.bis_stencil_gs_box_flat_blocks() != GS_BOX_FLAT_RESIDENT:
        raise RuntimeError("stencil_op.GS_BOX_FLAT_RESIDENT does not match "
                           "BIS_GS_BOX_FLAT_BLOCKS in csrc/stencil_spmv.cu")
    box = [i32() for _ in range(4)]
    lib.bis_stencil_box_shape(*[ctypes.byref(v) for v in box])
    if tuple(v.value for v in box) != (BOX_THREADS, BOX_STAGES,
                                       *BOX_RESIDENT):
        raise RuntimeError("stencil_op.BOX_THREADS/BOX_STAGES/BOX_RESIDENT "
                           "do not match BIS_BOX_* in csrc/stencil_spmv.cu")
    return lib
