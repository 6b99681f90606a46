"""Where a brick solve's time goes on the card: kernel #12's brick route
(csrc/block_trisolve.cu: super_solve_brick_kernel) built once more with
clock64() stamps at its phase boundaries, read back for two blocks.

    python3 scripts/mega_brick_stamps.py

Copies csrc/block_trisolve.cu into build/stamps/ with a stamp (thread 0 of
blocks 0 and 60, after a block barrier) at kernel entry, at the end of
the set-up (tables and y in, frame zeroed) and, for each level, after its
frame lines are in, after its cross half, after its parity passes and
after the grid barrier; compiles that file alone (nvcc, as _build does)
and launches it with the wrapper's own tables and shape on the L solves
of the HPCG 128^3 const pair (float32, float64) and the Anderson 128^3
pair from host CSR (float32, per-row D).  Prints each phase in SM cycles
for both blocks, the stamped and the clean kernel's device times (the
stamps' own cost) and the card's name, power limit and SM clock.  Needs a
card; ~1.5 min with the build.
"""
import ctypes
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
import basic_iterative_solvers_tpu_torch as bt  # noqa: E402
from basic_iterative_solvers_tpu_torch import _build  # noqa: E402
from basic_iterative_solvers_tpu_torch.coloring import (  # noqa: E402
    spec_for_device)
from basic_iterative_solvers_tpu_torch.ops import (  # noqa: E402
    block_trisolve as bk)

STAMP = ("if (threadIdx.x == 0 && threadIdx.y == 0 && (blockIdx.x == 0 || "
         "blockIdx.x == 60)) bis_stamps[(blockIdx.x ? 64 : 0) + (%s)] = "
         "clock64();")
#: (text of the kernel, text with a stamp): each must occur once
PATCHES = [
    ("#define BIS_SB_BRICK_THREADS 512",
     "__device__ long long bis_stamps[128];\n"
     "#define BIS_SB_BRICK_THREADS 512"),
    ("    const int nt = blockDim.x * blockDim.y;\n    const int nby",
     "    const int nt = blockDim.x * blockDim.y;\n    " + STAMP % "0"
     + "\n    const int nby"),
    ("    for (int li = 0; li < n_levels; ++li) {\n"
     "        const int* const lt = tab + li * shared;",
     "    __syncthreads(); " + STAMP % "1" + "\n"
     "    for (int li = 0; li < n_levels; ++li) {\n"
     "        const int* const lt = tab + li * shared;"),
    ("            __pipeline_wait_prior(0);\n            __syncthreads();\n"
     "            if (nc == 0)",
     "            __pipeline_wait_prior(0);\n            __syncthreads();\n"
     + STAMP % "2 + li * 4" + "\n            if (nc == 0)"),
    ("            __syncthreads();\n"
     "            T* const ds = drows ? dstage : nullptr;",
     "            __syncthreads();\n" + STAMP % "3 + li * 4" + "\n"
     "            T* const ds = drows ? dstage : nullptr;"),
    ("            if (drows && li + 1 < n_levels) {\n"
     "                // the next level",
     "            __syncthreads(); " + STAMP % "4 + li * 4" + "\n"
     "            if (drows && li + 1 < n_levels) {\n"
     "                // the next level"),
    ("        if (li + 1 < n_levels) grid.sync();\n    }\n}",
     "        if (li + 1 < n_levels) grid.sync();\n " + STAMP % "5 + li * 4"
     + "\n    }\n}\nextern \"C\" int bis_read_stamps(long long* h) { return "
     "(int)cudaMemcpyFromSymbol(h, bis_stamps, sizeof(bis_stamps)); }"),
]


def build():
    src = open(_build._PKG / "csrc" / "block_trisolve.cu").read()
    for old, new in PATCHES:
        if src.count(old) != 1:
            raise RuntimeError(f"the kernel no longer has: {old!r}")
        src = src.replace(old, new)
    out = os.path.join(_build._PKG.parent, "build", "stamps")
    os.makedirs(out, exist_ok=True)
    cu, so = os.path.join(out, "stamped.cu"), os.path.join(out, "stamped.so")
    open(cu, "w").write(src)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", so,
                    cu], check=True)
    lib = ctypes.CDLL(so)
    for dt in ("f32", "f64"):
        getattr(lib, f"bis_super_solve_brick_{dt}").argtypes = getattr(
            _build.load_library(), f"bis_super_solve_brick_{dt}").argtypes
        getattr(lib, f"bis_super_solve_brick_{dt}").restype = ctypes.c_int
    lib.bis_read_stamps.argtypes = [ctypes.c_void_p]
    return lib


def solves():
    for dt in (torch.float32, torch.float64):
        A = bt.stencil_op.from_source_operator(cs.MAIN_SPEC, dt,
                                               device="cuda")
        yield (f"{cs.MAIN_SPEC} {str(dt)[6:]} L",
               bk.build_superblock_gs_pair_stencil(
                   A, spec_for_device(A), dtype=dt, need_d=True)[0])
    st, _g, _s = cs._colored_host_setup(
        torch, bt, cs.ANDERSON_128, torch.float32, "BICGSTAB",
        "SYMMETRIC_GAUSS_SEIDEL", stencil=True)
    yield "anderson 128^3 float32 L (per-row D)", st.M.L_block


def main():
    name = cs.phase_device(torch)
    print(subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                          "--format=csv"], capture_output=True,
                         text=True).stdout.strip())
    lib = build()
    for label, B in solves():
        y = torch.randn(B.n_rows, dtype=B.dtype, device="cuda")
        out = torch.empty_like(y)
        if bk.mega_route_for(B, y.element_size(), y.device) != "brick":
            raise RuntimeError(f"{label}: the picker does not take the brick")
        tables = bk._brick_tables_on(B, y)
        dt = "f32" if y.element_size() == 4 else "f64"

        def stamped():
            err = getattr(lib, f"bis_super_solve_brick_{dt}")(
                y.device.index, tables.data_ptr(), len(B.levels),
                *bk._brick_args(B, y), y.data_ptr(), out.data_ptr(),
                bk._ptr(B.dinv_rows), torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"stamped launch failed: {err}")

        for _ in range(3):
            stamped()
        torch.cuda.synchronize()
        ref = bk.super_solve_mega_plain(B, y, torch.empty_like(y))
        if not torch.equal(out, ref):
            raise RuntimeError(f"{label}: the stamped kernel disagrees")
        stamps = (ctypes.c_longlong * 128)()
        if lib.bis_read_stamps(ctypes.addressof(stamps)):
            raise RuntimeError("reading the stamps failed")
        n = len(B.levels)
        for blk, at in ((0, 0), (60, 64)):
            st = [stamps[at + i] for i in range(2 + 4 * n)]
            phases = {"setup": st[1] - st[0]}
            last = st[1]
            for li in range(n):
                for j, what in enumerate(("frame", "cross", "parity",
                                          "barrier")):
                    if li + 1 == n and what == "barrier":
                        continue
                    phases[f"L{li} {what}"] = st[2 + 4 * li + j] - last
                    last = st[2 + 4 * li + j]
            print(f"[stamps] {name} {label} block {blk}: SM cycles {phases}"
                  f" total {last - st[0]}")
        times = cs._in_turns(torch, {
            "clean": lambda: bk.super_solve_mega(B, y, out),
            "stamped": stamped}, ("clean", "stamped", "stamped", "clean"))
        print(f"[stamps] {label} device ms in turns: {times}")


if __name__ == "__main__":
    main()
