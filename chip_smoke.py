"""Drive the PyTorch/CUDA port (basic_iterative_solvers_tpu_torch) on one
NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the script
exits non-zero:
  1. device: the card's name and power limit;
  2. build: compile the CUDA kernels from this checkout; [ptxas] prints
     the registers and spills of the basis kernels, the lane-ELL kernels,
     the staged factor-table level, the line route of the plane and const
     levels and the stencil SpMVs #1 and #2 on both routes;
  2b. native ([native], before every host row): build and load the
     port's host library (csrc/bis_host.cpp, g++) from this checkout, its
     path and build seconds; hold its passes against the NumPy branches
     (BIS_TPU_NO_NATIVE=1) bit for bit, each timed on the card's host:
     the hpcg:32x32x32 SGS pair from CSR, the fdm:256 coloured ILU(0) pair
     from CSR and the sband:500000,8,400 lane-ELL planes, each from its
     generator on;
  3. the stencil SpMV kernel against its plain PyTorch version on the card,
     at the main path's shapes, both timed, on the route each shape takes
     (the box route) and bit for bit against the leg-loop route; then the
     two routes timed in turns on bound launches (device time) at 128^3
     and 384^3 f32 beside the byte bound;
  4. the GMRES basis kernels (project_gram, correct_write) at the 128^3
     GMRES(50) shape, both basis dtypes, j = 0, 7, 49: the ring route the
     shape takes and the strided route against their plain versions,
     each route's device-only, host-enqueue and wrapper times in turns,
     the ring route's share of the bound, the library's
     nearest calls; the build prints the kernels' registers, spills and
     resident blocks an SM ([ptxas]);
  5. the same CG solve on the CPU (plain path) and on the card (kernel);
  6. the same BiCGSTAB and GMRES solves on the CPU and on the card;
  7. the main path: CG on HPCG 128^3 in float32 through the public entry
     points, 2500 iterations, counting the kernel's launches; then a
     float64 solve of the same operator to convergence;
  8. the second slice's path: Jacobi, BiCGSTAB and fused-mode GMRES(50)
     with a bfloat16 basis on HPCG 128^3 in float32, the bench's
     iteration counts, counting every kernel's launches (GMRES: every
     step on the basis kernels' ring route); then float64 GMRES(50) and
     BiCGSTAB solves of the same operator to convergence;
  9. capacity: CG on HPCG 384^3 in float32;
 10. the multicolour GS step kernel against its plain version, every
     colour, on the three operators of phase 3, both dtypes, on its box
     route (the route its picker names) bit for bit against its leg
     loop; colour 0 on both routes timed in turns by device time beside
     the coloured-row and the sector bound;
 11. the superblock level kernel against its plain version on every level
     of the L and U solves of HPCG 128^3 (const mode), bit for bit on the
     line route (the shape's) and the direct route, each level timed on
     both in turns beside its bound, and a whole symmetric apply against
     the CPU's and on both routes in turns, both dtypes;
 12. the same GS-family solves on the CPU and on the card (SGS and CG + SGS
     on HPCG 32^3, the superblock route; SGS on fdm:256, the masked
     colour sweeps);
 13. the third slice's path: the bench's gs, sgs, pcg, pgmres and
     pbicgstab rows on HPCG 128^3 in float32, counting every kernel's
     launches (the const levels on the route the picker names); then a float64 CG + SGS solve to convergence; and SGS on
     fdm:2048 through the GS colour-step kernel (its box route, then the
     leg loop and the box route forced, in turns);
 14. the superblock level kernel in factor-table mode (exact ILU(0))
     against its plain version on every level of the L and U solves of
     HPCG 128^3 (both dtypes) and 384^3 (f32) and on a whole ILU(0) apply,
     bit for bit, on the staged route (the shape's) and the direct route
     (the first port's kernel), bit-equal to each other, each level and
     apply timed on both in turns beside its bound; and one whole L solve
     through torch.triangular_solve on the sparse lower triangle, the
     library's nearest call;
 15. the split route's kernels (super_acc, super_parity) against their
     plain versions on every level of the 384^3 pair, f32 and f64, bit for
     bit on the staged and the direct route, each step timed in turns by
     device time beside its byte bound and, for a parity step, its sector
     bound ([ilu0-split]); then whole 384^3 applies in turns: fused, and
     split on both routes;
 16. the same CG + ILU(0) solve on the CPU and on the card (HPCG 32^3);
 17. the fourth slice's path: the bench's pcg_ilu0 rows, HPCG 128^3 (1200
     iterations) and 384^3 (100), fused (every level on the staged route)
     and, at 384^3, split (BIS_SB_ALIGNED=0), counting every kernel's
     launches, with set-up seconds and peak memory; the fused 384^3 row
     again on the staged and the direct route in turns; then a float64
     CG + ILU(0) solve to convergence;
 18. the DIA SpMV kernel against its plain version on the DIA operators of
     HPCG 128^3 (f32, f64) and 384^3 (f32) built on the card, with the
     library's CSR SpMV of the same matrix;
 19. the lane-ELL SpMV kernel against its plain version on
     sband:500000,8,400 (f32, f64), on each route (idx16: each row stopped
     at its count, 16-bit indices; idx32), timed in turns with the first
     port's loop over all K slots (the shard form's padded route over one
     shard of every row), the padded bound beside the bound of the slots
     the routes read, and the library's CSR SpMV;
 20. the rank-space level kernel against its plain version on every level
     with groups of the SGS pair of band:8388608,2 (f32, f64), on its vec
     route (the picker's) bit for bit against the scalar route (y apart
     and y aliasing x), each level timed on both in turns by device time
     beside its bound, whole applies against the CPU's and on both routes
     in turns, and torch.triangular_solve's whole L solve;
 21. the same DIA, lane-ELL and rank-space solves on the CPU and on the
     card (f64, small sizes);
 22. the fifth slice's paths: DIA CG at 128^3 (2500 iterations) and 384^3
     (150), cg@sband on lane-ELL (400) and the gather ELL (40),
     pbicgstab@band (800; every level on #8's vec route, then the row on
     the scalar and the vec route forced, in turns), counting every
     kernel's launches, with set-up seconds (host=native: the native host
     passes); then natural-order f64 CG + SGS and CG + ILU(0) on fdm:256
     on the CPU and on the card, equal iteration counts;
 23. the slice-5b rows ([slice5b]): the coloured host route under the
     source's grid colour spec, pcg_ilu0@fdm2048 (CG + ILU(0), 1200
     iterations, the pair from host CSR: L in plane mode, U const with a
     per-row D, the JAX CLI's route: the JAX bench's stencil injection
     takes the factor-table pair here) and pbicgstab@anderson128
     (BiCGSTAB + SGS, 800, the stencil injected: const mode with a per-row
     D), with every kernel's launches (the plane and const levels on the
     route the picker names), set-up seconds (host=native) and peak
     memory, and
     pcg_ilu0@fdm2048 on the line and the direct route in turns; f64
     CG + ILU(0) on fdm:256 on that route on the CPU and on the card;
 24. the plane mode of the superblock level kernel and the per-row D of
     its const mode ([plane-level]) against their plain versions on every
     level of the fdm:2048 pair and of the Anderson 128^3 SGS pair, f32
     and widened to f64, bit for bit on the line and the direct route,
     each level (f32) and whole fdm:2048 applies timed on both in turns
     beside the bound, the split route's kernels in plane mode
     ([plane-split], f32 and f64: the line and the direct route bit for
     bit, each step timed in turns beside its bounds) and whole applies
     in turns (fused, split on both routes), torch.triangular_solve's
     whole L solve,
     and the hpcg:32x32x32 plane pair against its factor-table pair;
 25. the one-launch const solve ([mega]) on its brick route (the
     picker's: each block keeps its brick of x in shared memory for the
     whole solve) and its direct route against the per-level route and
     the plain loop, bit for bit, on the HPCG 128^3 SGS pair (L, U, U in
     place, f32 and f64), the Anderson 128^3 SGS pair and the fdm:2048
     ILU(0) pair's U (const, per-row D, f32): the direct route re-timed
     alone by device time, then brick, direct, per-level and the brick
     launch with no rows (the barrier floor) in turns, beside the
     per-level byte bound and the on-chip solve bound;
     torch.triangular_solve's whole const L solve; then the bench's sgs
     and pcg rows with BIS_SB_MEGA's switch (the module attribute MEGA) on
     and off in turns, the one-launch solves counted by route;
 26. kernel #2 (the SpMV with x staged in shared memory, [stream]) against
     its plain version and bit for bit against #1 and both kernels'
     leg-loop routes at 128^3 f32 (every dot set) and f64, 384^3 f32,
     Anderson 128^3, fdm:2048 and the 64^3 Galerkin level of the 128^3
     multigrid hierarchy; #2's box and leg-loop routes timed in turns and
     #1's box route, by device time of bound launches, with the share of
     the byte bound;
     Then [routes]: #1's and #2's routes on every operator of both lists
     in f32 and f64, bit for bit;
 27. CG + MG, CG + Chebyshev, pipelined CG and CG + MG with refinement on
     HPCG 32^3 in float64 on the CPU and on the card ([cpu-vs-card-slice6]);
 28. slice 6's rows ([slice6]): pcg_mg at 128^3 (CG + V-cycle, 400
     iterations, the bench's 1200 cut), cg (2500), cg@384 (150) and
     pcg_mg@384 (100), f32, with
     BIS_STENCIL_STREAM's switch (the module attribute STREAM) off and on in
     turns, cg@384 and pcg_mg@384 also on the leg-loop route (the four
     configurations in turns), launches of #1 and #2 an iteration, each
     counted on its configuration's route only, set-up seconds, peak
     memory;
 29. cg_mg_refine at 128^3 ([refine]): float32 CG + MG inners, float64
     outers to 1e-11·||r0||, held to the explicit float64 residual;
 30. pipelined against classic CG at 128^3 in turns ([pipelined]);
 31. slice 6b's kernel forms ([bf16]): #4 with bf16 data on the DIA HPCG
     128^3 and 384^3, #5 with bf16 values on sband:500000,8,400, #1, #2
     and #3 with Anderson 128^3's diagonal in bf16, each against its plain
     version and against the same kernel on the data widened to float32
     (bit for bit), timed beside the plain version, the float32-data
     kernel and the library's CSR SpMV (run after phase 22); #5's idx16
     route and the first port's padded loop timed in turns;
 32. the command line on the CPU and on the card, float64 vectors over
     bf16 data ([cpu-vs-card-slice7]), then on the card ([slice7]) through
     cli.run in process: DIA CG at 128^3 (2500 iterations), 384^3 (150)
     f32 and bf16 in turns with equal histories, cg@sband with bf16
     values (400), BiCGSTAB + Jacobi and GS on the Anderson 128^3 stencil
     with its bf16 diagonal (the first again with STREAM set),
     --kernel-timers fused and host, --iter-times and --profile; each
     row's printed count and residual parsed and checked;
 33. the module entry point ([entry-point]): `python -m
     basic_iterative_solvers_tpu_torch hpcg:32x32x32 -cg` in a subprocess,
     exit 0, converged, no jax imported;
 34. slice 8's kernels ([mesh-kernel], run after phase 31): the shard-local
     forms of #1, #3, #4 and #5 on an 8-shard mesh on the card, each shard
     against its plain twin on its own window and the shards' outputs
     concatenated against the single-device kernel, bit for bit, in every
     type each takes (#1 at 128^3 with every dot kind, #3 on every colour
     of fdm:2048, #4 at 128^3, #5 on sband:500000,8,400; the bf16 forms);
     the 8 launches of one mesh call timed beside the single-device
     kernel, the whole mesh call and the library's CSR SpMV; #1 on the
     mesh's line-aligned windows on the route its picker names and on
     both routes forced (box, legs), y bit-equal across them, every dot
     within TOL of plain, each type's 8 launches timed in turns (legs,
     box, box, legs: the kernels alone, then through the wrapper), and
     one launch over the whole grid's window (the GSPMD mode at world
     size 1) on both routes in turns; #5 on each
     route (the launch shape's, padded on sband's shards; counted; padded
     with int32 indices, the first port's kernel; timed in turns) beside
     8 CSR SpMVs over the shards' rows; #3 on its box route, each shard
     bit for bit against its leg loop, the 8 launches of both routes
     timed in turns;
 35. slice 8's rows ([slice8]): CG on the 128^3 stencil (500, the
     bench's 2500 cut), DIA CG at 128^3 (500), cg@sband (400; the mesh
     also with #5's shard launches
     forced onto the counted route), SGS on fdm:2048 (200; the mesh also
     with #3's shard launches forced onto the leg loop), single-device
     and 8-shard mesh in turns, with ms/iter, launches (#1's shard
     launches by route, every one on the route its picker named) and the
     mesh's
     exchanges an iteration, the mesh's vectors row-sharded MeshVectors
     (a shard's rows its own tensor) and the mesh census of each row (no
     vector gathered whole in the loop); f64 CG + Jacobi to 1e-8 at 128^3
     on both, equal counts; one step and a solve of the standalone
     distributed CG (make_sharded_cg) on the DIA 128^3 matrix;
 35b. the GSPMD mode ([gspmd], after [slice8]): NCCL in this process at
     world size 1, `make_device_mesh()`; CG on the 128^3 stencil (300),
     single-device, 8-shard mesh and GSPMD in turns, with ms/iter, equal
     counts, #1's halo form launched every GSPMD iteration (by route,
     every launch on the route its picker named) and the single-device
     kernels never; f64 CG + Jacobi to 1e-8 at 128^3, GSPMD
     against single-device (equal counts, histories within 1e-8); GSPMD
     rows of #4's, #3's and #5's halo forms (DIA CG at 128^3, SGS on
     fdm:2048, CG on sband:524288,8,400); the census on the card (no full
     gather); the group destroyed after.  World size 1 moves no halo: the
     numbers are host and DTensor dispatch;
 36. slice 8b's kernel ([mesh-super-level], run after phase 25): kernel
     #9's mesh form on an 8-shard mesh on the card, every level of L and U
     in const (128^3 GS pair), factor-table (128^3 ILU(0) pair) and plane
     mode (the fdm:2048 pair of phase 23), f32 and f64, each shard
     bit-equal to its plain twin and the shards together to the
     single-device level, on each route of the mode (staged (f32) and
     direct; line and direct); the 8 launches of the last L level of each
     mode and of the fdm:2048 pair's U levels (const, per-row D) timed on
     both routes in turns, beside the single-device level, the plain
     twins, the whole mesh level with its exchange and whole solves;
 37. slice 8b's rows ([slice8b]): pcg, pcg_ilu0, pbicgstab@anderson128 and
     pcg_ilu0@fdm2048 at full size, a quarter of the bench's iteration
     counts (300, 300, 200, 300),
     single-device and 8-shard mesh in turns (pcg_ilu0@fdm2048 on the
     line and the direct route too, the four in turns), with ms/iter, #9's
     mesh launches by mode and route, exchanges and peak memory, and the
     mesh census of each row (no vector gathered whole in the loop); f64
     CG + SGS to 1e-8 at 128^3 on both, equal counts;
 37b. the mesh over every card ([mesh-cards], after [slice8b]): with two
     or more cards, CG and DIA CG at 128^3, SGS on fdm:2048 and pcg_ilu0
     at 128^3 on make_mesh() against one device (equal counts, histories
     within 1e-3, every shard's data on its card, no gather in the loop),
     f64 CG + Jacobi to 1e-8 within 1e-8; with one card it prints that it
     did not run.  After every mesh phase the process's current card is
     checked to be the one it was before;
 38. the basis kernels' device time a GMRES(50) iteration ([orthog], run
     last): the slice-2 GMRES row with the ring and the strided route in
     turns, ms/iter and the profiler's phase table of two restart cycles.
Each phase's seconds are printed as a [time] line.
The second-to-last line is a JSON object describing each kernel: launches
on the main paths, error against plain, kernel, plain and library times,
and the bound (the larger of the bytes it must move over the card's
memory rate and its operations over the float32 rate); the last is
{"ok": true, "device": {...}}.
"""
import contextlib
import dataclasses
import json
import os
import re
import statistics
import subprocess
import time

MAIN_SPEC = "hpcg:128x128x128"
KERNEL_SPECS = (MAIN_SPEC, "fdm:2048",
                "anderson:Lx=128,Ly=128,Lz=128,t=1.0,ranpot=4.0,seed=1")
#: kernel-vs-plain bound on max|y_k - y_p| / max|y_p|, and on a dot's
#: difference relative to Σ|y_i·v_i| (a dot of random vectors may cancel,
#: its rounding scales with that sum): reduction order differs
TOL = {"float32": 1e-5, "float64": 1e-12}
#: one H100 SXM's published peaks at 700 W (NVIDIA's data sheet): HBM
#: bytes/s, and float32 operations/s outside the tensor cores
PEAK_BYTES_S, PEAK_F32_OPS_S = 3.35e12, 67e12
ILU_384 = "hpcg:384x384x384"


def _bound(nbytes, ops):
    """{bound_ms, bound_by}: the least time the card could take, the larger
    of `nbytes` over its memory rate and `ops` float32 operations over its
    peak rate."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_OPS_S
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _median_ms(fn, torch, reps=20, batch=10):
    """Median over `reps` runs of the CUDA-event time per call of `batch`
    back-to-back calls (one call alone would time the host's launch gap)."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def _device_ms(fn, torch, reps=10, batch=10, sleep_cycles=100_000_000,
               host=None):
    """Median device time per call of `fn`, the host's launch cost hidden:
    each batch is enqueued behind a sleeping kernel (~50 ms), so the events
    around it time the device's work only.  A batch whose enqueuing took
    the host longer than the sleep ahead of it (a host stall: the host
    would then show) is timed again behind a sleep twice as long, up to
    three times, then raises; only batches the sleep covered are kept.
    With a list `host`, appends the median host time per call of
    enqueuing a batch (the wrapper's cost alone: no call waits for the
    device)."""
    fn()
    times, host_times = [], []
    for _ in range(reps):
        for again in range(4):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            torch.cuda.synchronize()
            ev[0].record()
            torch.cuda._sleep(sleep_cycles << again)
            ev[1].record()
            t0 = time.perf_counter()
            for _ in range(batch):
                fn()
            host_ms = 1e3 * (time.perf_counter() - t0)
            ev[2].record()
            ev[2].synchronize()
            if host_ms < ev[0].elapsed_time(ev[1]):
                break
            if again == 3:
                raise RuntimeError(f"enqueuing took {host_ms:.2f} ms, "
                                   "longer than the sleep ahead of it")
        times.append(ev[1].elapsed_time(ev[2]) / batch)
        host_times.append(host_ms / batch)
    if host is not None:
        host.append(statistics.median(host_times))
    return statistics.median(times)


def phase_device(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"count {torch.cuda.device_count()} name {name}; nvidia-smi "
          "name, power limit:")
    print(smi)
    return name


#: kernels whose ptxas lines [ptxas] prints beside the basis kernels'
PTXAS_KERNELS = ("lane_ell_spmv_kernel", "lane_ell_spmv_halo_kernel",
                 "lane_ell_spmv_halo_padded_kernel",
                 "super_level_staged_kernel", "super_level_line_kernel",
                 "super_acc_staged_kernel", "super_parity_staged_kernel",
                 "super_acc_line_kernel", "super_parity_line_kernel",
                 "stencil_spmv_kernel",
                 "stencil_spmv_stream_kernel", "stencil_spmv_box_kernel",
                 "stencil_spmv_stream_box_kernel",
                 "stencil_spmv_halo_kernel", "stencil_spmv_halo_box_kernel",
                 "super_solve_brick_kernel")
#: Itanium codes of the template arguments those kernels take
_MANGLED = {"f": "float", "d": "double", "t": "u16", "h": "u8", "i": "int",
            "13__nv_bfloat16": "bf16"}


def _template_args(code):
    """'ff13__nv_bfloat16th' -> 'float, float, bf16, u16, u8'; 'fLi24E'
    -> 'float, 24'; 'fLi24ELb1E' -> 'float, 24, 1'."""
    out = []
    while code:
        m = re.match(r"\d+__nv_bfloat16|[fdthi]|L[ib](\d+)E", code)
        if not m:
            out.append(code)
            break
        out.append(m.group(1) or _MANGLED[m.group(0)])
        code = code[m.end():]
    return ", ".join(out)


def phase_build(torch):
    """Build and load the kernels; beside the build, compile the basis
    kernels', the lane-ELL SpMV's, the level kernels' and the stencil
    SpMVs' sources once more with -Xptxas -v (all started together) and
    print the registers, spills and shared memory of the basis kernels,
    the lane-ELL kernels, the staged factor-table level and the stencil
    SpMVs #1 and #2 on both routes, then the ring kernels' resident
    blocks an SM (the occupancy their launches are sized to)."""
    import tempfile
    from basic_iterative_solvers_tpu_torch import _build
    from basic_iterative_solvers_tpu_torch.ops import gmres_basis as gb
    t0 = time.perf_counter()
    names = ("gmres_basis", "sparse_spmv", "block_trisolve", "stencil_spmv")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
             os.path.join(tmp, f"{name}.o"),
             str(_build._PKG / "csrc" / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for name in names]
        _build.load_library()
        outs = [(p.communicate(timeout=600)[0], p.returncode) for p in procs]
    print(f"[build] {', '.join(f.name for f in _build.SOURCES)} built "
          f"and loaded in {time.perf_counter() - t0:.2f} s")
    for name, (out, rc) in zip(names, outs):
        if rc != 0:
            raise RuntimeError(f"nvcc -Xptxas -v of {name}.cu failed:\n{out}")
        kernel = None
        for line in out.splitlines():
            m = re.search(r"entry function '_Z\d+(\w+?kernel_\w+?)I(\w+?)E",
                          line)
            m2 = re.search(r"entry function '_Z\d+(%s)I(\w+?)Ev" % "|".join(
                PTXAS_KERNELS), line)
            if m2:
                kernel = f"{m2.group(1)}<{_template_args(m2.group(2))}>"
            elif m and name == "gmres_basis":
                dt = m.group(2).lstrip("0123456789")
                kernel = f"{m.group(1)}<{'float' if dt == 'f' else dt}>"
            elif "entry function" in line:
                kernel = None
            elif kernel and re.search(r"spill|registers", line):
                print(f"[ptxas] {kernel}: {line.strip()}")
    for (name, dt) in gb._RING_KERNELS:
        slots = gb._slots(0, name, dt)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        print(f"[ptxas] {name}_kernel_ring<{str(dt)[6:]}>: "
              f"{slots // sms} resident blocks an SM x {sms} SMs")


NATIVE_SGS, NATIVE_ILU0 = "hpcg:32x32x32", "fdm:256"


def _host_branch(bt):
    """"native" or "numpy": the branch the host passes take now."""
    from basic_iterative_solvers_tpu_torch import _native
    return "native" if _native.available() else "numpy"


@contextlib.contextmanager
def _numpy_branch():
    """The NumPy branches of the host passes (BIS_TPU_NO_NATIVE=1)."""
    os.environ["BIS_TPU_NO_NATIVE"] = "1"
    try:
        yield
    finally:
        del os.environ["BIS_TPU_NO_NATIVE"]


def _same_superblock(a, b):
    """True when two superblock solves agree bit for bit: levels, mode,
    const coefficients, planes and per-row diagonals."""
    import torch
    fields = ("levels", "m", "S", "fused", "unit", "dtype", "const_cross",
              "const_self", "reach")
    if any(getattr(a, f) != getattr(b, f) for f in fields):
        return False
    tensors = lambda B: ([B.dinv_rows, B.d_rows] + list(  # noqa: E731
        B.vals_cross or ()) + list(B.vals_self or ()))
    ta, tb = tensors(a), tensors(b)
    return len(ta) == len(tb) and all(
        (x is None) == (y is None) and (x is None or (
            x.dtype == y.dtype and torch.equal(x, y))) for x, y in zip(ta, tb))


def phase_native(torch, bt, device="cuda", sgs=NATIVE_SGS, ilu0=NATIVE_ILU0,
                 sband=None):
    """Build and load the host library, then hold each native pass against
    the NumPy branch bit for bit, from the generator on: the SGS pair from
    CSR (hpcg:32x32x32), the coloured ILU(0) pair from CSR (fdm:256; the
    native pair packed off the permuted CSR, the NumPy one through the
    triplets), the lane-ELL planes of sband:500000,8,400.  Prints each
    branch's host seconds."""
    from basic_iterative_solvers_tpu_torch import _native
    from basic_iterative_solvers_tpu_torch.ops import lane_ell
    sband = SBAND if sband is None else sband
    t0 = time.perf_counter()
    _native._library()
    print(f"[native] host library {_native.build()} built in "
          f"{_native.build_seconds:.3f} s (0: found built); built and "
          f"loaded in {time.perf_counter() - t0:.3f} s")
    if not _native.available():
        raise RuntimeError("the host library is switched off "
                           "(BIS_TPU_NO_NATIVE is set)")
    P = bt.PrecondType

    def pair(spec, precond):
        A = bt.generators.from_source(spec)
        cfg = bt.SolverConfig(
            preconditioner=precond, dtype=torch.float32, gs_mode="colored",
            color_spec=bt.generators.color_spec_for_source(spec))
        M = bt.setup_preconditioner(A, cfg, device=device)
        return M.L_block, M.U_block

    def planes():
        M = lane_ell.csr_to_lane_ell(bt.generators.from_source(sband),
                                     torch.float32, device=device)
        return M.vals, M.idx, M.row_len, M.idx16

    same_pair = lambda a, b: all(map(_same_superblock, a, b))  # noqa: E731
    for label, build, same in (
            (f"{sgs} f32 SGS pair from CSR",
             lambda: pair(sgs, P.SYMMETRIC_GAUSS_SEIDEL), same_pair),
            (f"{ilu0} f32 coloured ILU(0) pair from CSR",
             lambda: pair(ilu0, P.ILU0), same_pair),
            (f"{sband} f32 lane-ELL planes", planes,
             lambda a, b: all(torch.equal(x, y) for x, y in zip(a, b)))):
        t0 = time.perf_counter()
        got = build()
        native_s = time.perf_counter() - t0
        with _numpy_branch():
            t0 = time.perf_counter()
            ref = build()
            numpy_s = time.perf_counter() - t0
        ok = same(got, ref)
        print(f"[native] {label}: native {native_s:.3f} s, numpy "
              f"{numpy_s:.3f} s (host, from the generator on), bit-equal "
              f"{ok}")
        if not ok:
            raise RuntimeError(f"[native] {label}: the native and NumPy "
                               "branches differ")
        del got, ref


def _route_ab(torch, so, A, x, dots, aux, stream):
    """Kernel #2 (`stream`) or #1 on its box route and its leg-loop route,
    each with its operands bound once (`stencil_op._bind_spmv`: the ctypes
    call alone): y of the two routes bit for bit, then device ms of each
    in turns (box, legs, legs, box).  Returns ((box ms, box ms), (legs ms,
    legs ms))."""
    launch_b, y_b, _, _ = so._bind_spmv(A, x, dots, aux, stream, "box")
    launch_l, y_l, _, _ = so._bind_spmv(A, x, dots, aux, stream, "legs")
    launch_b()
    launch_l()
    torch.cuda.synchronize()
    if not torch.equal(y_b, y_l):
        raise RuntimeError(f"{'#2' if stream else '#1'}'s box route is not "
                           f"bit-equal to its leg loop on {A.dims}")
    t = [_device_ms(f, torch) for f in (launch_b, launch_l, launch_l,
                                        launch_b)]
    return (t[0], t[3]), (t[1], t[2])


#: [kernel]'s route A/B: #1 at the main path's and the capacity run's size
ROUTE_AB_SPECS = (MAIN_SPEC, "hpcg:384x384x384")


def phase_kernel_vs_plain(torch, so):
    """Every SpMV form the main path and the explicit residual use, plus
    the other dot kinds, on the card, on the route each takes (the box
    route), held to plain and bit for bit to the leg-loop route; then the
    two routes timed in turns on bound launches (device time) at 128^3
    and 384^3 f32 with y.x, beside the byte bound.  Returns the main-path
    record."""
    record = None
    for spec in KERNEL_SPECS:
        for dt in (torch.float32, torch.float64):
            A = so.from_source_operator(spec, dt, device="cuda")
            g = torch.Generator(device="cuda").manual_seed(0)
            x = torch.randn(A.n_rows, dtype=dt, device="cuda", generator=g)
            aux = torch.randn(A.n_rows, dtype=dt, device="cuda", generator=g)
            tol = TOL[str(dt).split(".")[1]]
            for dots in ((), ("x",), ("self",), ("aux",)):
                before = so.stencil_spmv.launches
                k = so.stencil_spmv(A, x, dots, aux)
                p = so.stencil_spmv_plain(A, x, dots, aux)
                torch.cuda.synchronize()
                if so.stencil_spmv.launches != before + 1:
                    raise RuntimeError("the launch count did not grow")
                legs = so._stencil_spmv_cuda(A, x, dots, aux, route="legs")
                k, p, legs = (k, p, legs) if dots else ((k,), (p,), (legs,))
                if not torch.equal(k[0], legs[0]):
                    raise RuntimeError(f"the box route is not bit-equal to "
                                       f"the leg loop: {spec} {dt} {dots}")
                abs_err = float((k[0] - p[0]).abs().max())
                rel = abs_err / float(p[0].abs().max())
                partner = {"x": x, "self": p[0], "aux": aux}
                dot_rel = [abs(float(dk - dp))
                           / float((p[0] * partner[kind]).abs().sum())
                           for kind, dk, dp in zip(dots, k[1:], p[1:])]
                ms = _median_ms(lambda: so.stencil_spmv(A, x, dots, aux),
                                torch)
                plain_ms = _median_ms(
                    lambda: so.stencil_spmv_plain(A, x, dots, aux), torch)
                # bytes the kernel must move: x and y, plus diag and aux
                n_vec = 2 + (A.diag is not None) + ("aux" in dots)
                gbs = n_vec * A.n_rows * x.element_size() / (ms * 1e6)
                print(f"[kernel] {spec} {str(dt)[6:]} "
                      f"dots={','.join(dots) or '-'} route="
                      f"{so.route_for(A, x, aux, stream=False)} "
                      f"max_rel_err={rel:.3e} bit_equal_to_legs=True "
                      f"dot_rel_err={[f'{e:.3e}' for e in dot_rel]} "
                      f"call_ms={ms:.4f} "
                      f"plain_ms={plain_ms:.4f} call_GB/s={gbs:.0f}")
                if not (rel <= tol and all(e <= tol for e in dot_rel)):
                    raise RuntimeError(f"kernel disagrees with plain beyond "
                                       f"{tol}: {spec} {dt} {dots}")
                if (spec, dt, dots) == (MAIN_SPEC, torch.float32, ("x",)):
                    record = {"max_abs_err": abs_err, "call_ms": ms,
                              "plain_ms": plain_ms}
    for spec in ROUTE_AB_SPECS:
        A = so.from_source_operator(spec, torch.float32, device="cuda")
        g = torch.Generator(device="cuda").manual_seed(0)
        x = torch.randn(A.n_rows, device="cuda", generator=g)
        box, legs = _route_ab(torch, so, A, x, ("x",), None, False)
        bound = _bound(2 * A.n_rows * 4, 2 * len(A.legs) * A.n_rows)
        b = bound["bound_ms"]
        print(f"[kernel] route A/B {spec} f32 dots=x, device ms of bound "
              f"launches in turns (box, legs, legs, box): box="
              f"{[f'{t:.5f}' for t in box]} legs="
              f"{[f'{t:.5f}' for t in legs]} bound_ms={b:.5f} "
              f"({bound['bound_by']}) share_of_bound box={b / min(box):.3f} "
              f"legs={b / min(legs):.3f}")
        if spec == MAIN_SPEC:
            record.update({"ms": min(box), "legs_ms": min(legs)})
        else:
            record.update({"ms_384": min(box), "legs_ms_384": min(legs),
                           "bound_ms_384": b})
        del A, x
        torch.cuda.empty_cache()
    # the main path's call: y = A·x and y·x, f32; the library's nearest
    # call is one cuSPARSE SpMV of the assembled matrix (no dot)
    A = so.from_source_operator(MAIN_SPEC, torch.float32, device="cuda")
    n = A.n_rows
    x = torch.randn(n, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(0))
    M = _stencil_csr(torch, A)
    y_lib = M @ x
    lib_rel = float((y_lib - so.stencil_spmv_plain(A, x)).abs().max()
                    / so.stencil_spmv_plain(A, x).abs().max())
    record["library_ms"] = _median_ms(lambda: M @ x, torch)
    nnz = int(M.values().numel())
    record.update(_bound(2 * n * 4, 2 * nnz - n + 2 * n))
    print(f"[library] {MAIN_SPEC} f32 torch.sparse_csr_tensor @ x "
          f"(nnz={nnz}, SpMV only): ms={record['library_ms']:.4f} "
          f"max_rel_err={lib_rel:.3e}; kernel bound_ms="
          f"{record['bound_ms']:.4f} ({record['bound_by']})")
    if not lib_rel <= TOL["float32"]:
        raise RuntimeError("the library SpMV disagrees with plain")
    return record


def _stencil_csr(torch, A):
    """A DeviceStencil on the card assembled as a torch.sparse_csr_tensor
    (rows in order, columns ascending: legs sorted by flat offset)."""
    nx, ny, nz = A.dims
    i = torch.arange(A.n_rows, device="cuda")
    gx, gy, gz = i % nx, (i // nx) % ny, i // (nx * ny)
    legs = sorted(zip(A.legs, A.coeff_values),
                  key=lambda lc: lc[0][0] + nx * (lc[0][1] + ny * lc[0][2]))
    cols, ok = [], []
    for (dx, dy, dz), _c in legs:
        ok.append((gx + dx >= 0) & (gx + dx < nx) & (gy + dy >= 0)
                  & (gy + dy < ny) & (gz + dz >= 0) & (gz + dz < nz))
        cols.append(i + (dx + nx * (dy + ny * dz)))
    ok = torch.stack(ok, 1)
    col = torch.stack(cols, 1)[ok]
    del cols
    val = torch.tensor([c for _l, c in legs], dtype=A.dtype,
                       device="cuda").expand(A.n_rows, -1)[ok]
    crow = torch.zeros(A.n_rows + 1, dtype=torch.int64, device="cuda")
    crow[1:] = ok.sum(1).cumsum(0)
    return torch.sparse_csr_tensor(crow, col, val, (A.n_rows, A.n_rows))


#: the 128^3 GMRES(50) basis: rows of n entries, and the rows it checks
BASIS_N, BASIS_M, BASIS_JS = 2097152, 50, (0, 7, 49)
#: bound on a basis kernel's Pw/Pv against plain, relative to
#: Σ|V_i·w| of its row (float32 sums in different orders)
BASIS_TOL = 1e-5


def _basis_check(torch, gb, V, w, vc, ht, j, route):
    """Both basis kernels on `route` against their plain versions on the
    same tensors (Pw/Pv within BASIS_TOL, zeros beyond row j, the written
    row and vnext bit for bit, nrm2 within 1e-5 relative), each launch
    counted on its route; returns (the line's fields, Pw/Pv's and vnext's
    largest absolute errors)."""
    counters = [(f, f.launches, getattr(f, f"{route}_launches"))
                for f in (gb.project_gram, gb.correct_write)]
    Pk = gb._project_gram_cuda(V, w, vc, j, route)
    Pp = gb.project_gram_plain(V, w, vc, j)
    Vk, Vp = V.clone(), V.clone()
    vk, nk = gb._correct_write_cuda(Vk, w, ht, j, route)
    vp, np_ = gb.correct_write_plain(Vp, w, ht, j)
    torch.cuda.synchronize()
    for f, total, on_route in counters:
        if (f.launches, getattr(f, f"{route}_launches")) != (total + 1,
                                                             on_route + 1):
            raise RuntimeError(f"{f.__name__}'s {route} launch count did "
                               "not grow by one")
    Vf = V[:j + 1].float()
    pg_err = max(float(((k[:j + 1] - p[:j + 1]).abs()
                        / (Vf * v).abs().sum(1)).max())
                 for k, p, v in zip(Pk, Pp, (w, vc)))
    tail = max(float(k[j + 1:].abs().max()) for k in Pk)  # j < m
    rows_equal = torch.equal(Vk, Vp) and torch.equal(vk, vp)
    nrm_rel = abs(float(nk) - float(np_)) / float(np_)
    fields = (f"{route}: project_gram_rel_err={pg_err:.3e} tail={tail:.1e} "
              f"correct_write_rows_equal={rows_equal} "
              f"nrm2_rel_err={nrm_rel:.3e}")
    if not (pg_err <= BASIS_TOL and tail == 0.0 and rows_equal
            and nrm_rel <= 1e-5):
        raise RuntimeError(f"basis kernels disagree with plain: j={j} "
                           f"{fields}")
    return fields, (max(float((k - p).abs().max()) for k, p in zip(Pk, Pp)),
                    float((vk - vp).abs().max()))


def phase_basis_vs_plain(torch, gb):
    """project_gram (#6) and correct_write (#7) at the 128^3 GMRES(50)
    shape, both basis dtypes, every j of BASIS_JS: raises unless the shape
    takes the ring route; each route against the plain versions
    (_basis_check); for each route in turns (ring, strided, strided,
    ring) its device-only ms (_device_ms), the host's ms to enqueue one
    call behind a sleeping kernel (the route's wrapper code alone) and its
    wrapper's ms back to back (_median_ms, the host's enqueue included);
    the public wrapper's ms, GB/s and share of the bound of the ring route,
    and the library's nearest calls on the device in the same run; the
    plain versions timed at j = 49.  Returns the kernel records: bf16 at j = 49
    (the main path's basis), with float32's beside."""
    records = {"project_gram": {}, "correct_write": {}}
    g = torch.Generator(device="cuda").manual_seed(1)
    n, m = BASIS_N, BASIS_M
    for dt in (torch.float32, torch.bfloat16):
        V = torch.randn(m + 1, n, device="cuda", generator=g).to(dt)
        w = torch.randn(n, device="cuda", generator=g)
        vc = torch.randn(n, device="cuda", generator=g)
        ht = torch.randn(m + 1, device="cuda", generator=g)
        routes = (gb.route_for(V, w, vc), gb.route_for(V, w))
        if routes != ("ring", "ring"):
            raise RuntimeError(f"the main path's basis shape took the "
                               f"{routes} routes, not the ring")
        row = n * V.element_size()
        Vk = V.clone()
        for j in BASIS_JS:
            checks = [_basis_check(torch, gb, V, w, vc, ht, j, rt)
                      for rt in gb.ROUTES]
            # bytes each must move: rows 0..j, plus w and vc, or plus
            # w, vnext and the written row
            pg_bytes = (j + 1) * row + 2 * 4 * n
            cw_bytes = (j + 2) * row + 2 * 4 * n
            t = {}
            for rt in ("ring", "strided", "strided", "ring"):
                for name, fn in (
                        ("pg", lambda: gb._project_gram_cuda(V, w, vc, j,
                                                             rt)),
                        ("cw", lambda: gb._correct_write_cuda(Vk, w, ht, j,
                                                              rt))):
                    t.setdefault(f"{name}_{rt}", []).append(
                        _device_ms(fn, torch, host=t.setdefault(
                            f"{name}_{rt}_enqueue", [])))
                    t.setdefault(f"{name}_{rt}_wrapper", []).append(
                        _median_ms(fn, torch))
            t["pg_wrapper"] = _median_ms(
                lambda: gb.project_gram(V, w, vc, j), torch)
            t["cw_wrapper"] = _median_ms(
                lambda: gb.correct_write(Vk, w, ht, j), torch)
            # the library's nearest calls, in the basis dtype: one matmul
            # of rows 0..j with [w, vc]; one addmv w − Vᵀh, which leaves
            # out the row write, the float32 vnext and the norm
            W = torch.stack([w, vc], 1).to(dt)
            hb, wb = ht[:j + 1].to(dt), w.to(dt)
            t["matmul"] = _device_ms(lambda: torch.matmul(V[:j + 1], W),
                                     torch)
            t["addmv"] = _device_ms(lambda: torch.addmv(
                wb, V[:j + 1].t(), hb, alpha=-1), torch)
            pg_bound, cw_bound = (_bound(pg_bytes, 4 * (j + 1) * n),
                                  _bound(cw_bytes, 2 * (j + 1) * n + 2 * n))
            pg_ms, cw_ms = min(t["pg_ring"]), min(t["cw_ring"])
            print(f"[basis] n={n} m={m} {str(dt)[6:]} j={j} "
                  f"{'; '.join(c[0] for c in checks)}")
            print(f"[basis] n={n} m={m} {str(dt)[6:]} j={j} routes' host "
                  "cost in turns (ring, strided, strided, ring): "
                  + "; ".join(
                      f"{kernel} {rt} enqueue_ms="
                      f"{[round(x, 5) for x in t[f'{key}_{rt}_enqueue']]} "
                      f"wrapper_ms="
                      f"{[round(x, 5) for x in t[f'{key}_{rt}_wrapper']]}"
                      for kernel, key in (("project_gram", "pg"),
                                          ("correct_write", "cw"))
                      for rt in gb.ROUTES))
            print(f"[basis] n={n} m={m} {str(dt)[6:]} j={j} route=ring "
                  f"project_gram device_ms={t['pg_ring']} "
                  f"(strided {t['pg_strided']}) "
                  f"wrapper_ms={t['pg_wrapper']:.4f} "
                  f"GB/s={pg_bytes / (pg_ms * 1e6):.0f} "
                  f"bound_ms={pg_bound['bound_ms']:.4f} "
                  f"share={pg_bound['bound_ms'] / pg_ms:.3f} "
                  f"matmul_ms={t['matmul']:.4f}; correct_write "
                  f"device_ms={t['cw_ring']} (strided {t['cw_strided']}) "
                  f"wrapper_ms={t['cw_wrapper']:.4f} "
                  f"GB/s={cw_bytes / (cw_ms * 1e6):.0f} "
                  f"bound_ms={cw_bound['bound_ms']:.4f} "
                  f"share={cw_bound['bound_ms'] / cw_ms:.3f} "
                  f"addmv_ms={t['addmv']:.4f}")
            if j != BASIS_JS[-1]:
                continue
            plain = {"pg": _median_ms(
                lambda: gb.project_gram_plain(V, w, vc, j), torch),
                "cw": _median_ms(
                lambda: gb.correct_write_plain(Vk, w, ht, j), torch)}
            print(f"[basis] n={n} m={m} {str(dt)[6:]} j={j} plain: "
                  f"project_gram_ms={plain['pg']:.4f} "
                  f"correct_write_ms={plain['cw']:.4f}")
            ring_err = checks[gb.ROUTES.index("ring")][1]
            for kernel, key, lib, bound, err in (
                    ("project_gram", "pg", "matmul", pg_bound, ring_err[0]),
                    ("correct_write", "cw", "addmv", cw_bound,
                     ring_err[1])):
                rec = {"max_abs_err": err, "ms": min(t[f"{key}_ring"]),
                       "plain_ms": plain[key], "library_ms": t[lib],
                       "wrapper_ms": t[f"{key}_wrapper"],
                       "strided_ms": min(t[f"{key}_strided"]), **bound}
                if dt == torch.bfloat16:
                    records[kernel].update(rec)
                else:
                    records[kernel].update(
                        {f"f32_{k}": rec[k] for k in ("ms", "library_ms",
                                                      "bound_ms",
                                                      "strided_ms")})
        del V, Vk
    return records


def phase_cpu_vs_card(torch, bt):
    """The same f64 solve with CPU tensors (plain path) and CUDA tensors
    (kernel): the same iterations, histories to rtol 1e-8."""
    import numpy as np
    results = {}
    for device in ("cpu", "cuda"):
        A = bt.stencil_op.from_source_operator("hpcg:32x32x32",
                                               torch.float64, device=device)
        cfg = bt.SolverConfig(dtype=torch.float64, harness="fused",
                              tolerance=1e-10, max_iters=1000)
        n = A.n_rows
        results[device] = bt.solve(bt.preprocessing_device(
            A, cfg, b=torch.full((n,), 2.0, dtype=torch.float64,
                                 device=device),
            x0=torch.full((n,), 1.0, dtype=torch.float64, device=device)))
    c, g = results["cpu"], results["cuda"]
    print(f"[cpu-vs-card] hpcg:32x32x32 f64 iters cpu={c.iter_count} "
          f"card={g.iter_count} final cpu={c.final_residual_norm:.6e} "
          f"card={g.final_residual_norm:.6e}")
    if c.iter_count != g.iter_count or not (c.converged and g.converged):
        raise RuntimeError("CPU and card solves differ in iterations")
    np.testing.assert_allclose(g.residual_norms[:-1], c.residual_norms[:-1],
                               rtol=1e-8)


def _setup(torch, bt, spec, dtype, device, method, **cfg_kw):
    A = bt.stencil_op.from_source_operator(spec, dtype, device=device)
    n = A.n_rows
    cfg = bt.SolverConfig(method=method, dtype=dtype, harness="fused",
                          **cfg_kw)
    # the bench's reference setup: b = 2, x0 = 1
    return bt.preprocessing_device(
        A, cfg, b=torch.full((n,), 2.0, dtype=dtype, device=device),
        x0=torch.full((n,), 1.0, dtype=dtype, device=device))


def _hpcg_cg(torch, bt, spec, dtype, **cfg_kw):
    return _setup(torch, bt, spec, dtype, "cuda",
                  bt.SolverType.CONJUGATE_GRADIENT, **cfg_kw)


def phase_main_path(torch, bt):
    import math
    from basic_iterative_solvers_tpu_torch.solvers import make_method
    so = bt.stencil_op
    setup = _hpcg_cg(torch, bt, MAIN_SPEC, torch.float32, max_iters=2500,
                     tolerance=0.0, breakdown_stall=True)
    method = make_method(setup)
    bt.solve(setup, method=method)                 # warm-up solve
    for attr in ("launches", "box_launches", "legs_launches"):
        setattr(so.stencil_spmv, attr, 0)
    res = bt.solve(setup, method=method)
    launches = so.stencil_spmv.launches
    by_route = {"box": so.stencil_spmv.box_launches,
                "legs": so.stencil_spmv.legs_launches}
    ms = 1e3 * res.solve_seconds / max(1, res.iter_count)
    print(f"[main] {MAIN_SPEC} f32 CG fused: iters={res.iter_count} "
          f"ms/iter={ms:.5f} r0={res.residual_norms[0]:.6e} "
          f"final_explicit_f64={res.final_residual_norm:.6e} "
          f"spmv_launches={launches} by_route={by_route}")
    if not (res.iter_count == 2500 and math.isfinite(res.final_residual_norm)
            and launches >= 2500 and res.x_star.shape == (setup.n,)
            and by_route == {"box": launches, "legs": 0}
            and bool(torch.isfinite(res.x_star).all())):
        raise RuntimeError("main path run failed its checks")

    setup64 = _hpcg_cg(torch, bt, MAIN_SPEC, torch.float64, max_iters=2000,
                       tolerance=1e-8)
    res64 = bt.solve(setup64)
    r0 = res64.residual_norms[0]
    print(f"[main] {MAIN_SPEC} f64 CG to tol 1e-8: iters={res64.iter_count} "
          f"converged={res64.converged} "
          f"final_explicit/r0={res64.final_residual_norm / r0:.3e} "
          f"ms/iter={1e3 * res64.solve_seconds / res64.iter_count:.5f}")
    if not (res64.converged and res64.final_residual_norm <= 10 * 1e-8 * r0):
        raise RuntimeError("f64 main-path solve did not converge")
    return launches, ms, by_route


def _check_history(got, ref):
    """got's history against ref's: rtol 1e-8 while ref is above
    1e-3·||r0||, then rtol 1e-2 down to 1e-7·||r0||, below which the
    float64 norms are rounding noise.  BiCGSTAB and restarted GMRES amplify
    the rounding of reduction order as they go: on the CPU the JAX package
    and the port part the same way (HPCG 32^3 BiCGSTAB: 6e-9 at
    2.5e-3·||r0||, 1e-6 at 8e-5·||r0||, 2e-3 at the end)."""
    import numpy as np
    g, h = got.residual_norms[:-1], ref.residual_norms[:-1]
    for above, rtol in ((1e-3, 1e-8), (1e-7, 1e-2)):
        keep = h >= above * h[0]
        np.testing.assert_allclose(g[keep], h[keep], rtol=rtol)


def phase_cpu_vs_card_slice2(torch, bt):
    """f64 BiCGSTAB and GMRES(50) lowsync on HPCG 32^3 on the CPU and on the
    card: the same iteration and restart counts, histories as
    _check_history says; f32 fused GMRES(50) with a bf16 basis: iteration
    counts within 2 (float32 reductions in other orders)."""
    S = bt.SolverType
    cases = [("f64 BiCGSTAB", torch.float64, S.BICGSTAB,
              dict(tolerance=1e-10, max_iters=1000)),
             ("f64 GMRES(50) lowsync", torch.float64, S.GMRES,
              dict(tolerance=1e-10, max_iters=1000, restart_length=50,
                   orthog_mode="lowsync")),
             ("f32 GMRES(50) fused bf16", torch.float32, S.GMRES,
              dict(tolerance=1e-5, max_iters=1000, restart_length=50,
                   orthog_mode="fused", gmres_basis_dtype="bfloat16"))]
    for label, dt, method, kw in cases:
        c, g = (bt.solve(_setup(torch, bt, "hpcg:32x32x32", dt, dev, method,
                                **kw)) for dev in ("cpu", "cuda"))
        print(f"[cpu-vs-card] hpcg:32x32x32 {label}: iters cpu="
              f"{c.iter_count} card={g.iter_count} restarts cpu="
              f"{c.gmres_restart_count} card={g.gmres_restart_count} "
              f"final cpu={c.final_residual_norm:.6e} "
              f"card={g.final_residual_norm:.6e}")
        if not (c.converged and g.converged):
            raise RuntimeError(f"{label}: a solve did not converge")
        if dt == torch.float32:
            if abs(c.iter_count - g.iter_count) > 2:
                raise RuntimeError(f"{label}: iteration counts differ by "
                                   "more than 2")
            continue
        if (c.iter_count, c.gmres_restart_count) != (
                g.iter_count, g.gmres_restart_count):
            raise RuntimeError(f"{label}: CPU and card counts differ")
        _check_history(g, c)


def phase_slice_path(torch, bt):
    """The bench's rows for Jacobi (2500 iterations), BiCGSTAB (1500) and
    fused-mode GMRES(50) with a bf16 basis (1500 steps, restarts counted)
    on HPCG 128^3, f32, tolerance 0; each after a warm-up solve, with every
    kernel counter set to 0 just before the timed solve and read just
    after.  Returns the GMRES run's launch counts."""
    import math
    from basic_iterative_solvers_tpu_torch.ops import gmres_basis as gb
    from basic_iterative_solvers_tpu_torch.solvers import make_method
    so = bt.stencil_op
    S = bt.SolverType
    rows = [("jacobi", S.JACOBI, dict(max_iters=2500)),
            ("bicgstab", S.BICGSTAB, dict(max_iters=1500)),
            ("gmres", S.GMRES, dict(max_iters=1500, restart_length=50,
                                    orthog_mode="fused",
                                    gmres_basis_dtype="bfloat16"))]
    counts = {}
    for name, method, kw in rows:
        setup = _setup(torch, bt, MAIN_SPEC, torch.float32, "cuda", method,
                       tolerance=0.0, breakdown_stall=True, **kw)
        solver = make_method(setup)
        bt.solve(setup, method=solver)                # warm-up solve
        so.stencil_spmv.launches = 0
        for f in (gb.project_gram, gb.correct_write):
            f.launches = f.ring_launches = f.strided_launches = 0
        res = bt.solve(setup, method=solver)
        counts = {"stencil_spmv": so.stencil_spmv.launches,
                  **{f"{f.__name__}{suffix}": getattr(f, attr)
                     for f in (gb.project_gram, gb.correct_write)
                     for suffix, attr in (("", "launches"),
                                          ("_ring", "ring_launches"),
                                          ("_strided", "strided_launches"))}}
        ms = 1e3 * res.solve_seconds / max(1, res.iter_count)
        print(f"[slice2] {MAIN_SPEC} f32 {name} fused: iters={res.iter_count} "
              f"restarts={res.gmres_restart_count} ms/iter={ms:.5f} "
              f"r0={res.residual_norms[0]:.6e} "
              f"final_explicit_f64={res.final_residual_norm:.6e} "
              f"launches={counts}")
        steps = res.iter_count + res.gmres_restart_count
        ok = (steps == kw["max_iters"]
              and math.isfinite(res.final_residual_norm)
              and bool(torch.isfinite(res.x_star).all())
              and counts["stencil_spmv"] >= res.iter_count)
        if method == S.GMRES:
            # every step through the ring route
            ok = ok and all(
                counts[f"{k}_ring"] == counts[k] >= res.iter_count
                and counts[f"{k}_strided"] == 0
                for k in ("project_gram", "correct_write"))
        if not ok:
            raise RuntimeError(f"slice-2 {name} run failed its checks")
    gmres_counts = counts

    for name, method, kw in (
            ("GMRES(50) lowsync", S.GMRES,
             dict(restart_length=50, orthog_mode="lowsync")),
            ("BiCGSTAB", S.BICGSTAB, {})):
        res = bt.solve(_setup(torch, bt, MAIN_SPEC, torch.float64, "cuda",
                              method, tolerance=1e-8, max_iters=3000, **kw))
        r0 = res.residual_norms[0]
        print(f"[slice2] {MAIN_SPEC} f64 {name} to tol 1e-8: "
              f"iters={res.iter_count} restarts={res.gmres_restart_count} "
              f"converged={res.converged} "
              f"final_explicit/r0={res.final_residual_norm / r0:.3e} "
              f"ms/iter={1e3 * res.solve_seconds / res.iter_count:.5f}")
        if not (res.converged and res.final_residual_norm <= 10 * 1e-8 * r0):
            raise RuntimeError(f"f64 {name} solve did not converge")
    return gmres_counts


def phase_orthog_share(torch, bt):
    """The basis kernels' device time in a GMRES(50) iteration (the slice-2
    row: 128^3, f32, fused, bf16 basis, 1500 steps), each route in turns
    (ring, strided, strided, ring; the strided route forced by replacing
    gmres_basis.route_for for the run): the timed solve's ms/iter, then
    its fused loop re-run under torch.profiler for two restart cycles (100
    iterations + 2 restarts) with its kernels summed by phase bucket
    (utils/profile.py).  Raises unless the orthog bucket holds the route's
    kernels only."""
    from basic_iterative_solvers_tpu_torch.ops import gmres_basis as gb
    from basic_iterative_solvers_tpu_torch.solvers import make_method
    from basic_iterative_solvers_tpu_torch.utils.profile import (
        bucket_of, measure_phase_table)
    setup = _setup(torch, bt, MAIN_SPEC, torch.float32, "cuda",
                   bt.SolverType.GMRES, tolerance=0.0, breakdown_stall=True,
                   max_iters=1500, restart_length=50, orthog_mode="fused",
                   gmres_basis_dtype="bfloat16")
    solver = make_method(setup)
    bt.solve(setup, method=solver)                    # warm-up solve
    iters, restarts = 100, 2
    route_for = gb.route_for
    try:
        for route in ("ring", "strided", "strided", "ring"):
            gb.route_for = lambda *tensors, route=route: route
            res = bt.solve(setup, method=solver)
            table, meta = measure_phase_table(solver, iters, restarts)
            kernels = sum(table.values())
            orthog = {name: t for name, t in meta["per_op"].items()
                      if bucket_of(name) == "orthog"}
            print(f"[orthog] {MAIN_SPEC} f32 GMRES(50) fused bf16, route "
                  f"{route}: solve ms/iter="
                  f"{1e3 * res.solve_seconds / res.iter_count:.5f}; "
                  f"{iters} iterations + {restarts} restarts under "
                  f"torch.profiler: orthog "
                  f"{1e3 * table.get('orthog', 0.0) / iters:.5f} ms/iter of "
                  f"{1e3 * kernels / iters:.5f} ms/iter of device activity "
                  f"({table.get('orthog', 0.0) / kernels:.3f}); device wall "
                  f"{1e3 * meta['device_wall'] / iters:.5f} ms/iter; by "
                  f"bucket (ms/iter) "
                  f"{ {k: round(1e3 * v / iters, 5) for k, v in table.items()} }"
                  f"; orthog kernels (ms/iter) "
                  f"{ {k[:40]: round(1e3 * v / iters, 5) for k, v in orthog.items()} }")
            if not orthog or not all(f"_{route}<" in k for k in orthog):
                raise RuntimeError(f"the orthog bucket is not the {route} "
                                   f"kernels: {list(orthog)}")
    finally:
        gb.route_for = route_for


def phase_capacity(torch, bt):
    setup = _hpcg_cg(torch, bt, "hpcg:384x384x384", torch.float32,
                     max_iters=150, tolerance=0.0, breakdown_stall=True)
    from basic_iterative_solvers_tpu_torch.solvers import make_method
    method = make_method(setup)
    bt.solve(setup, method=method)                 # warm-up solve
    res = bt.solve(setup, method=method)
    ms = 1e3 * res.solve_seconds / max(1, res.iter_count)
    print(f"[capacity] hpcg:384x384x384 f32 CG fused: iters="
          f"{res.iter_count} ms/iter={ms:.5f} "
          f"final_explicit_f64={res.final_residual_norm:.6e}")
    if res.iter_count != 150:
        raise RuntimeError("capacity run stopped early")


@contextlib.contextmanager
def _route_forced(module, picker, route):
    """Every call inside the block that asks `module.picker` for its route
    takes `route` (the picker replaced for it); None: the picker's own."""
    saved = getattr(module, picker)
    if route is not None:
        setattr(module, picker, lambda *args, **kwargs: route)
    try:
        yield
    finally:
        setattr(module, picker, saved)


def _gs_bounds(torch, A, cs, c, item):
    """(coloured-row bound, sector bound) of one GS colour step: x read and
    x' written whole, rhs and dinv on colour c's rows only, or on every row
    whose 32-byte sector of rhs holds a row of colour c (the card fetches
    those sectors whole); per coloured row its legs' products and sums,
    then rhs - s, ·dinv and + x."""
    from basic_iterative_solvers_tpu_torch.coloring import color_ids
    ids = color_ids(cs, A)
    n, n_c = A.n_rows, int((ids == c).sum())
    per = 32 // item
    hit = (ids[:n - n % per].view(-1, per) == c).any(dim=1)
    n_s = per * int(hit.sum()) + int((ids[n - n % per:] == c).any()) * (
        n % per)
    ops = n_c * (2 * len(A.legs) + 2)
    return (_bound(item * (2 * n + 2 * n_c), ops),
            _bound(item * (2 * n + 2 * n_s), ops))


def phase_gs_step_vs_plain(torch, bt):
    """stencil_gs_color_step against its plain version on every colour of
    the three operators, f32 and f64, within TOL of max|x'|, on the route
    gs_route_for names (the box route; the leg loop for float64 on the
    3-D grids), the box route bit for bit against the leg loop; colour 0
    timed on both routes in
    turns by device time (box, legs, legs, box), beside its two bounds
    (rhs and dinv on the coloured rows; on the sectors holding them).
    Returns the record of fdm:2048 f32 (the masked route that phase 13
    drives)."""
    from basic_iterative_solvers_tpu_torch.coloring import spec_for_device
    so = bt.stencil_op
    fn = so.stencil_gs_color_step
    record = None
    for spec in KERNEL_SPECS:
        for dt in (torch.float32, torch.float64):
            A = so.from_source_operator(spec, dt, device="cuda")
            cs = spec_for_device(A)
            g = torch.Generator(device="cuda").manual_seed(2)
            x = torch.randn(A.n_rows, dtype=dt, device="cuda", generator=g)
            rhs = torch.randn(A.n_rows, dtype=dt, device="cuda", generator=g)
            dinv = 1.0 / so.stencil_diag(A)
            tol = TOL[str(dt).split(".")[1]]
            # the box route everywhere but float64 on a 3-D grid, where
            # the picker keeps the leg loop (it measured no slower there)
            route = ("box" if dt == torch.float32 or A.dims[2] == 1
                     else "legs")
            if so.gs_route_for(A, x, rhs, dinv, cs) != route:
                raise RuntimeError(f"{spec} {dt}: #3 did not pick its "
                                   f"{route} route")
            worst_rel, worst_abs = 0.0, 0.0
            for c in range(cs.n_colors):
                before = (fn.launches, getattr(fn, f"{route}_launches"))
                k = fn(A, x, rhs, dinv, cs, c)
                box = so._stencil_gs_color_step_cuda(A, x, rhs, dinv, cs, c,
                                                     route="box")
                legs = so._stencil_gs_color_step_cuda(A, x, rhs, dinv, cs, c,
                                                      route="legs")
                p = so.stencil_gs_color_step_plain(A, x, rhs, dinv, cs, c)
                torch.cuda.synchronize()
                if (fn.launches, getattr(fn, f"{route}_launches")) != (
                        before[0] + 3, before[1] + 2):
                    raise RuntimeError("the GS step's launch counts did not "
                                       "grow by route")
                if not (torch.equal(k, legs) and torch.equal(box, legs)):
                    raise RuntimeError(f"#3's box route differs from its leg "
                                       f"loop: {spec} {dt} colour {c}")
                abs_err = float((k - p).abs().max())
                worst_abs = max(worst_abs, abs_err)
                worst_rel = max(worst_rel, abs_err / float(p.abs().max()))
            turns = _in_turns(torch, {
                rt: (lambda rt=rt: so._stencil_gs_color_step_cuda(
                    A, x, rhs, dinv, cs, 0, route=rt))
                for rt in ("box", "legs")}, ("box", "legs", "legs", "box"))
            plain_ms = _median_ms(lambda: so.stencil_gs_color_step_plain(
                A, x, rhs, dinv, cs, 0), torch, reps=5)
            rows_b, sector_b = _gs_bounds(torch, A, cs, 0, x.element_size())
            ms = min(turns["box"])
            print(f"[gs-step] {spec} {str(dt)[6:]} {cs.kind} "
                  f"colors={cs.n_colors} route={route}; box bit-equal to "
                  f"legs on every colour, max_rel_err_vs_plain="
                  f"{worst_rel:.3e}; colour 0 "
                  f"device ms in turns box={turns['box']} "
                  f"legs={turns['legs']} plain_ms={plain_ms:.4f} "
                  f"bound_ms={rows_b['bound_ms']:.5f} (coloured rows, "
                  f"{100 * rows_b['bound_ms'] / ms:.0f}% on box) "
                  f"sector_bound_ms={sector_b['bound_ms']:.5f} "
                  f"({100 * sector_b['bound_ms'] / ms:.0f}%)")
            if not worst_rel <= tol:
                raise RuntimeError(f"GS step kernel disagrees with plain "
                                   f"beyond {tol}: {spec} {dt}")
            if (spec, dt) == ("fdm:2048", torch.float32):
                record = {"max_abs_err": worst_abs, "ms": ms,
                          "legs_ms": min(turns["legs"]),
                          "plain_ms": plain_ms, "library_ms": None,
                          "sector_bound_ms": sector_b["bound_ms"], **rows_b}
    return record


def phase_super_level_vs_plain(torch, bt):
    """super_level against its plain version on every level of the L and U
    solves of HPCG 128^3 (x random, so every source superblock holds
    values), bit for bit on both routes (line, the shape's; direct), each
    level timed on both in turns by device time beside its bound (f32);
    blocked_sgs whole against the CPU's plain solve within TOL, and on
    both routes in turns, f32 and f64.  Returns the f32 record (ms: the
    mean level on the line route; direct_ms beside it)."""
    from basic_iterative_solvers_tpu_torch.coloring import spec_for_device
    from basic_iterative_solvers_tpu_torch.ops import block_trisolve as bk
    record = None
    for dt in (torch.float32, torch.float64):
        A = bt.stencil_op.from_source_operator(MAIN_SPEC, dt, device="cuda")
        L, U = bk.build_superblock_gs_pair_stencil(
            A, spec_for_device(A), dtype=dt, need_d=True)
        g = torch.Generator(device="cuda").manual_seed(3)
        y = torch.randn(A.n_rows, dtype=dt, device="cuda", generator=g)
        x = torch.randn(A.n_rows, dtype=dt, device="cuda", generator=g)
        tol = TOL[str(dt).split(".")[1]]
        label = f"{MAIN_SPEC} {str(dt)[6:]}"
        ms, plain_ms, worst, by_level = [], [], 0.0, []
        for B in (L, U):
            k, p, e = _check_levels(torch, bk, label, B, y, x,
                                    range(len(B.levels)),
                                    timed=dt == torch.float32,
                                    tag="super-level", by_level=by_level)
            ms += k
            plain_ms += p
            worst = max(worst, e)
        zk = bk.blocked_sgs(L, U, y)
        before = bk.super_level.launches
        zp = bk.blocked_sgs(L, U, y.cpu()).to("cuda")
        if bk.super_level.launches != before:
            raise RuntimeError("a CPU solve launched a kernel")
        zd = _direct(bk.blocked_sgs, L, U, y)
        sgs_rel = float((zk - zp).abs().max()) / float(zp.abs().max())
        sgs_ms = _in_turns(torch, {
            "line": lambda: bk.blocked_sgs(L, U, y),
            "direct": lambda: _direct(bk.blocked_sgs, L, U, y)},
            ("direct", "line", "line", "direct"))
        print(f"[super-level] {label} blocked_sgs (2x{L.S} levels) against "
              f"the CPU's plain solve: max_rel_err={sgs_rel:.3e}; the direct "
              f"route's bit_equal={torch.equal(zd, zk)}; device ms in turns "
              f"{sgs_ms}")
        if not (sgs_rel <= tol and torch.equal(zd, zk)):
            raise RuntimeError(f"blocked_sgs disagrees with plain beyond "
                               f"{tol} or across routes: {dt}")
        if dt == torch.float32:
            record = {"max_abs_err": worst,
                      "ms": statistics.mean(ms),
                      "direct_ms": statistics.mean(t[1] for t in by_level),
                      "plain_ms": statistics.mean(plain_ms),
                      "library_ms": None,
                      **_mean_bound([_level_work(B, li, 4) for B in (L, U)
                                     for li in range(len(B.levels))])}
    return record


def _axis_count(n, s, p, d):
    """Rows a ≡ p (mod s) of an axis of n points whose neighbour a + d lies
    inside."""
    return sum(1 for a in range(p, n, s) if 0 <= a + d < n)


def _level_work(B, li, itemsize, part="level", p=None):
    """(bytes, operations) that one level of B must move and do: `part`
    "level" (the fused kernel), "acc" (the split route's acc step) or
    "parity" (its step for x-parity p).  Bytes: each input read once (y or
    acc on the level's rows, x on the source superblocks' rows or the self
    legs' source columns, the factor-table values of _table_values) and
    each output written once; operations: a product and a difference per
    in-grid leg, and the pivot multiply."""
    nx, ny, nz, sx, sy, sz = B.spec_params
    sb, cross, selfs = B.levels[li]
    py, pz = sb % sy, sb // sy
    lines = (ny // sy) * (nz // sz)
    legs = B.table_cross[li] if B.is_table else B.const_cross[li]
    cross_terms = sum((nx - abs(dx)) * _axis_count(ny, sy, py, dy)
                      * _axis_count(nz, sz, pz, dz)
                      for _f, dx, dy, dz in legs)
    n_src = len({src for src, _d in cross})
    scaled = not B.is_table or B.table_dinv is not None
    parities = range(sx) if part == "level" else (() if part == "acc"
                                                  else (p,))
    self_terms, src_cols, rows = 0, set(), 0
    self_rows = {dx: [] for dx in selfs}
    for x in range(nx):
        if x % sx not in parities:
            continue
        rows += lines
        for dx in selfs:
            ps = (x + dx) % sx
            if 0 <= x + dx < nx and (ps > x % sx if B.upper
                                     else ps < x % sx):
                self_terms += lines
                src_cols.add(x + dx)
                self_rows[dx].append(x)
    table = (_table_values(B, li, self_rows, parities, part != "parity")
             if B.is_table else 0)
    if part == "acc":
        nbytes = B.m * (2 + n_src) + table
        ops = 2 * cross_terms
    elif part == "parity":
        nbytes = 2 * rows + lines * len(src_cols) + table
        ops = 2 * self_terms + (rows if scaled else 0)
    else:
        nbytes = B.m * (2 + n_src) + table
        ops = 2 * (cross_terms + self_terms) + (B.m if scaled else 0)
    return nbytes * itemsize, ops


def _table_values(B, li, self_rows, parities, cross):
    """The factor-table values one part of level li reads: for each self
    leg dx, its table row at the distinct classes of self_rows[dx] (the x
    of the rows it updates); with `cross`, each cross leg's row at the
    distinct classes of the level's rows whose neighbour lies in the grid;
    and U's inverse pivot at the classes of the rows of `parities`.  Class
    and grid test both factor per axis, so each count is a product of
    three axis counts."""
    from basic_iterative_solvers_tpu_torch.ops import block_trisolve
    nx, ny, nz, sx, sy, sz = B.spec_params
    sb = B.levels[li][0]
    cx, cy, cz = (c.tolist() for c in
                  block_trisolve._axis_classes(B, li, "cpu"))

    def distinct(cls, coords, n, d):
        return len({cls[i] for i, a in enumerate(coords) if 0 <= a + d < n})

    yz = len(set(cy)) * len(set(cz))
    values = yz * sum(len({cx[x] for x in xs}) for xs in self_rows.values())
    if B.table_dinv is not None:
        values += yz * len({cx[x] for x in range(nx) if x % sx in parities})
    if cross:
        ys, zs = range(sb % sy, ny, sy), range(sb // sy, nz, sz)
        values += sum(distinct(cx, range(nx), nx, dx)
                      * distinct(cy, ys, ny, dy) * distinct(cz, zs, nz, dz)
                      for _f, dx, dy, dz in B.table_cross[li])
    return values


def _mean_bound(works):
    """The mean bound of several calls' (bytes, operations), bound by what
    bounds most of them."""
    bounds = [_bound(b, o) for b, o in works]
    by = [b["bound_by"] for b in bounds]
    return {"bound_ms": statistics.mean(b["bound_ms"] for b in bounds),
            "bound_by": max(set(by), key=by.count)}


def phase_cpu_vs_card_slice3(torch, bt):
    """f64 SGS and CG + SGS on HPCG 32^3 (the superblock route) and SGS on
    fdm:256 (the masked sweeps, 300 iterations: it needs ~10^5 to reach
    the tolerance) on the CPU and on the card: the same iteration counts,
    histories as _check_history says."""
    S, P = bt.SolverType, bt.PrecondType
    cases = [("hpcg:32x32x32", "SGS", S.SYMMETRIC_GAUSS_SEIDEL, P.NONE,
              dict(tolerance=1e-10, max_iters=2000), True),
             ("hpcg:32x32x32", "CG + SGS", S.CONJUGATE_GRADIENT,
              P.SYMMETRIC_GAUSS_SEIDEL,
              dict(tolerance=1e-10, max_iters=1000), True),
             ("fdm:256", "SGS", S.SYMMETRIC_GAUSS_SEIDEL, P.NONE,
              dict(tolerance=1e-10, max_iters=300), False)]
    for spec, label, method, precond, kw, converges in cases:
        c, g = (bt.solve(_setup(torch, bt, spec, torch.float64, dev, method,
                                preconditioner=precond, **kw))
                for dev in ("cpu", "cuda"))
        print(f"[cpu-vs-card] {spec} f64 {label}: iters cpu={c.iter_count} "
              f"card={g.iter_count} final cpu={c.final_residual_norm:.6e} "
              f"card={g.final_residual_norm:.6e}")
        if c.iter_count != g.iter_count or (
                converges and not (c.converged and g.converged)):
            raise RuntimeError(f"{spec} {label}: CPU and card solves differ")
        _check_history(g, c)


#: the bench's GS-family rows (bench.py:50-60, 83-86): name, method,
#: preconditioner, iterations, extra config
SLICE3_ROWS = (("gs", "GAUSS_SEIDEL", "NONE", 1200, {}),
               ("sgs", "SYMMETRIC_GAUSS_SEIDEL", "NONE", 1200, {}),
               ("pcg", "CONJUGATE_GRADIENT", "SYMMETRIC_GAUSS_SEIDEL", 1200,
                {}),
               ("pgmres", "GMRES", "SYMMETRIC_GAUSS_SEIDEL", 800,
                dict(restart_length=50, orthog_mode="fused",
                     gmres_basis_dtype="bfloat16")),
               ("pbicgstab", "BICGSTAB", "SYMMETRIC_GAUSS_SEIDEL", 800, {}))


def _counters(so, gb, bk, reset=False):
    """Every kernel's launch count (the factor-table level's is
    super_level.table_launches); `reset` sets them all to 0 first."""
    kernels = {"stencil_spmv": (so.stencil_spmv, "launches"),
               "stencil_gs_color_step": (so.stencil_gs_color_step,
                                         "launches"),
               "stencil_gs_color_step_box": (so.stencil_gs_color_step,
                                             "box_launches"),
               "stencil_gs_color_step_legs": (so.stencil_gs_color_step,
                                              "legs_launches"),
               "project_gram": (gb.project_gram, "launches"),
               "correct_write": (gb.correct_write, "launches"),
               "project_gram_ring": (gb.project_gram, "ring_launches"),
               "correct_write_ring": (gb.correct_write, "ring_launches"),
               "super_level": (bk.super_level, "launches"),
               "super_level_table": (bk.super_level, "table_launches"),
               "super_level_table_staged": (bk.super_level,
                                            "table_staged_launches"),
               "super_level_table_direct": (bk.super_level,
                                            "table_direct_launches"),
               "super_level_plane": (bk.super_level, "plane_launches"),
               **{f"super_level_{k}_{rt}": (bk.super_level,
                                            f"{k}_{rt}_launches")
                  for k in ("const", "plane") for rt in ("line", "direct")},
               "super_acc": (bk.super_acc, "launches"),
               "super_parity": (bk.super_parity, "launches"),
               **{f"{k}_{rt}": (getattr(bk, k), f"{rt}_launches")
                  for k in ("super_acc", "super_parity")
                  for rt in ("staged", "line", "direct")},
               "super_solve_mega": (bk.super_solve_mega, "launches"),
               **{f"super_solve_mega_{rt}": (bk.super_solve_mega,
                                             f"{rt}_launches")
                  for rt in ("brick", "direct")},
               "stencil_spmv_stream": (so.stencil_spmv_stream, "launches")}
    if reset:
        for fn, attr in kernels.values():
            setattr(fn, attr, 0)
    return {name: getattr(fn, attr) for name, (fn, attr) in kernels.items()}


def _picked_routes(bk, item, *solves):
    """{route: launches} that level_route_for names for one launch of every
    plane and const level of the solves (None skipped; a mesh solve: each
    shard that owns lines of the level), vectors of `item` bytes."""
    import torch
    dev = torch.device("cuda", torch.cuda.current_device())
    out = {}
    for s in solves:
        if s is None:
            continue
        if hasattr(s, "shards"):
            calls = [(s.inner, li, Bs) for Bs in s.shards
                     for li in range(len(s.inner.levels))
                     if Bs.lines[li][1] > Bs.lines[li][0]]
        else:
            calls = [(s, li, None) for li in range(len(s.levels))]
        for B, li, Bs in calls:
            if not B.is_table:
                rt = bk.level_route_for(B, li, item, Bs, dev)
                out[rt] = out.get(rt, 0) + 1
    return out


def _all_on_route(counts, route, prefix="super_level"):
    """Every plane and const launch in `counts` (a _counters dict; prefix
    super_level_halo for the mesh form's) counted on `route`."""
    total = counts[prefix] + counts[f"{prefix}_plane"]
    return total == counts[f"{prefix}_const_{route}"] + counts[
        f"{prefix}_plane_{route}"]


def phase_slice3_path(torch, bt):
    """The bench's gs, sgs, pcg, pgmres and pbicgstab rows on HPCG 128^3,
    f32, tolerance 0, b = 2, x0 = 1, each after a warm-up solve, with every
    kernel counter set to 0 just before the timed solve and read just
    after; a float64 CG + SGS solve to 1e-8; then SGS on fdm:2048, f32, 200
    iterations through the GS colour-step kernel.  Returns the launches of
    super_level summed over the five rows, and of stencil_gs_color_step in
    the fdm:2048 run."""
    import math
    from basic_iterative_solvers_tpu_torch.ops import block_trisolve as bk
    from basic_iterative_solvers_tpu_torch.ops import gmres_basis as gb
    from basic_iterative_solvers_tpu_torch.solvers import make_method
    so = bt.stencil_op
    S, P = bt.SolverType, bt.PrecondType
    super_launches = 0
    by_route = {"line": 0, "direct": 0}
    for name, method, precond, iters, kw in SLICE3_ROWS:
        setup = _setup(torch, bt, MAIN_SPEC, torch.float32, "cuda",
                       S[method], preconditioner=P[precond],
                       max_iters=iters, tolerance=0.0, breakdown_stall=True,
                       precond_inner_iters=1, **kw)
        if setup.gs_L_block is None and setup.M.L_block is None:
            raise RuntimeError(f"{name} did not take the superblock route")
        solver = make_method(setup)
        picked = _picked_routes(bk, 4, setup.gs_L_block, setup.gs_U_block,
                                getattr(setup.M, "L_block", None),
                                getattr(setup.M, "U_block", None))
        bt.solve(setup, method=solver)                # warm-up solve
        _counters(so, gb, bk, reset=True)
        res = bt.solve(setup, method=solver)
        counts = _counters(so, gb, bk)
        super_launches += counts["super_level"]
        for rt in ("line", "direct"):
            by_route[rt] += counts[f"super_level_const_{rt}"]
        ms = 1e3 * res.solve_seconds / max(1, res.iter_count)
        print(f"[slice3] {MAIN_SPEC} f32 {name} fused: "
              f"iters={res.iter_count} restarts={res.gmres_restart_count} "
              f"ms/iter={ms:.5f} r0={res.residual_norms[0]:.6e} "
              f"final_explicit_f64={res.final_residual_norm:.6e} "
              f"levels by the picker's route {picked} launches={counts}")
        if not (res.iter_count + res.gmres_restart_count == iters
                and len(picked) == 1 and _all_on_route(counts, *picked)
                and math.isfinite(res.final_residual_norm)
                and bool(torch.isfinite(res.x_star).all())
                and counts["super_level"] >= res.iter_count
                and counts["stencil_spmv"] >= res.iter_count
                and counts["stencil_gs_color_step"] == 0
                and (name != "pgmres" or all(
                    counts[f"{k}_ring"] == counts[k] >= res.iter_count
                    for k in ("project_gram", "correct_write")))):
            raise RuntimeError(f"slice-3 {name} run failed its checks")

    res = bt.solve(_setup(torch, bt, MAIN_SPEC, torch.float64, "cuda",
                          S.CONJUGATE_GRADIENT,
                          preconditioner=P.SYMMETRIC_GAUSS_SEIDEL,
                          tolerance=1e-8, max_iters=1000))
    r0 = res.residual_norms[0]
    print(f"[slice3] {MAIN_SPEC} f64 CG + SGS to tol 1e-8: "
          f"iters={res.iter_count} converged={res.converged} "
          f"final_explicit/r0={res.final_residual_norm / r0:.3e} "
          f"ms/iter={1e3 * res.solve_seconds / res.iter_count:.5f}")
    if not (res.converged and res.final_residual_norm <= 10 * 1e-8 * r0):
        raise RuntimeError("f64 CG + SGS solve did not converge")

    setup = _setup(torch, bt, "fdm:2048", torch.float32, "cuda",
                   S.SYMMETRIC_GAUSS_SEIDEL, max_iters=200, tolerance=0.0)
    if setup.gs_L_block is not None:
        raise RuntimeError("fdm:2048 SGS took the superblock route")
    solver = make_method(setup)
    bt.solve(setup, method=solver)                    # warm-up solve
    # the main path (#3's route its picker names, box) first, then the
    # leg loop and the box route forced, in turns
    runs, main = {}, None
    for rt in (None, "legs", "legs", "box"):
        with _route_forced(so, "gs_route_for", rt):
            if rt == "legs" and "legs" not in runs:
                bt.solve(setup, method=solver)        # warm-up solve
            _counters(so, gb, bk, reset=True)
            res = bt.solve(setup, method=solver)
        counts = _counters(so, gb, bk)
        ms = 1e3 * res.solve_seconds / max(1, res.iter_count)
        runs.setdefault(rt or "box", []).append(ms)
        print(f"[slice3] fdm:2048 f32 SGS fused (masked sweeps), #3 on "
              f"{rt or 'the picker'}'s route: iters={res.iter_count} "
              f"ms/iter={ms:.5f} r0={res.residual_norms[0]:.6e} "
              f"final_explicit_f64={res.final_residual_norm:.6e} "
              f"launches={ {k: v for k, v in counts.items() if v} }")
        route = rt or "box"
        if not (res.iter_count == 200
                and math.isfinite(res.final_residual_norm)
                and bool(torch.isfinite(res.x_star).all())
                and counts["stencil_gs_color_step"] >= 4 * res.iter_count
                and counts[f"stencil_gs_color_step_{route}"]
                == counts["stencil_gs_color_step"]
                and counts["super_level"] == 0):
            raise RuntimeError("fdm:2048 SGS run failed its checks")
        if main is None:
            main = counts
    print(f"[slice3] fdm:2048 f32 SGS ms/iter in turns (box, legs, legs, "
          f"box): box={runs['box']} legs={runs['legs']}")
    return super_launches, by_route, main["stencil_gs_color_step"], {
        rt: main[f"stencil_gs_color_step_{rt}"] for rt in ("box", "legs")}


def _ilu0_pair(torch, bt, spec, dt):
    """(A, L, U, set-up seconds) of the factor-table ILU(0) pair on the
    card."""
    from basic_iterative_solvers_tpu_torch.coloring import spec_for_device
    from basic_iterative_solvers_tpu_torch.ops import block_trisolve as bk
    A = bt.stencil_op.from_source_operator(spec, dt, device="cuda")
    t0 = time.perf_counter()
    L, U = bk.build_superblock_ilu0_pair_stencil(A, spec_for_device(A),
                                                 dtype=dt)
    torch.cuda.synchronize()
    return A, L, U, time.perf_counter() - t0


def _plain_ilu0(bk, L, U, y):
    """A whole ILU(0) apply through the plain level, on y's device."""
    x = y.new_empty(y.shape)
    for li in range(len(L.levels)):
        bk.super_level_plain(L, li, y, x)
    for li in range(len(U.levels)):
        bk.super_level_plain(U, li, x, x)
    return x


def _split_pair(L, U):
    """The same pair on the split route (what BIS_SB_ALIGNED=0 builds where
    128 % nx != 0)."""
    return (dataclasses.replace(L, fused=False, _args={}),
            dataclasses.replace(U, fused=False, _args={}))


def _owners(solves):
    """(route cache owner, levels) of each superblock solve in `solves`:
    a SuperBlockTriSolve or SuperBlockShard itself, a mesh's
    MeshSuperBlockTriSolve through its shards; other arguments skipped."""
    out = []
    for s in solves:
        if hasattr(s, "shards"):
            out += [(Bs, len(s.inner.levels)) for Bs in s.shards]
        elif hasattr(s, "_args"):
            out.append((s, len((s.B if hasattr(s, "B") else s).levels)))
    return out


@contextlib.contextmanager
def _on_route(route, *solves):
    """Every level of `solves` (see _owners) launched inside the block takes
    `route`: set in the route caches that block_trisolve.level_route_for
    keeps (each solve's, or each mesh shard's), for both vector types on
    the current card, and restored after."""
    import torch
    idx = torch.cuda.current_device()
    saved = []
    for owner, levels in _owners(solves):
        for li in range(levels):
            for item in (4, 8):
                key = ("route", li, item, idx)
                saved.append((owner._args, key, owner._args.get(key)))
                owner._args[key] = route
    try:
        yield
    finally:
        for cache, key, old in reversed(saved):
            if old is None:
                cache.pop(key, None)
            else:
                cache[key] = old


def _routes_of(B, itemsize):
    """The routes of B's level kernel on vectors of `itemsize` bytes,
    "direct" last (the staged route takes float32 only)."""
    if B.is_table:
        return ("staged", "direct") if itemsize == 4 else ("direct",)
    return ("line", "direct")


def _direct(fn, *args):
    """fn(*args) with every level of the solves among args on the direct
    route."""
    with _on_route("direct", *args):
        return fn(*args)


def _check_levels(torch, bk, label, B, y, x, levels, timed=True,
                  tag="ilu0-level", by_level=None):
    """super_level against super_level_plain on the given levels of B, bit
    for bit, on both routes of its mode (_routes_of: factor table staged
    and direct, plane and const line and direct), each launch counted in
    its mode's counter and in its route's; with `timed`, both routes
    timed by device time in turns (second, first, first, second) beside
    the level's bound (_level_work; _plane_level_work where B has a
    per-row D) and the plain level.  Returns ([ms on the route the shape
    takes], [plain ms], worst abs error); with a list `by_level`, appends
    each level's (ms on the first route, ms on direct, bound ms)."""
    attr = ("table_launches" if B.is_table else
            "plane_launches" if B.is_plane else "launches")
    mode = "table" if B.is_table else "plane" if B.is_plane else "const"
    routes = _routes_of(B, x.element_size())
    first = routes[0]
    work = _plane_level_work if B.dinv_rows is not None else _level_work
    ms, plain_ms, worst = [], [], 0.0
    for li in levels:
        route = bk.level_route_for(B, li, x.element_size(), device=x.device)
        outs, counts = {}, {}
        for rt in routes:
            before = (getattr(bk.super_level, attr),
                      getattr(bk.super_level, f"{mode}_{rt}_launches"))
            outs[rt] = x.clone()
            with _on_route(rt, B):
                bk.super_level(B, li, y, outs[rt])
            counts[rt] = (getattr(bk.super_level, attr) - before[0],
                          getattr(bk.super_level, f"{mode}_{rt}_launches")
                          - before[1])
        xp = x.clone()
        bk.super_level_plain(B, li, y, xp)
        torch.cuda.synchronize()
        if any(c != (1, 1) for c in counts.values()):
            raise RuntimeError(f"the {attr} or a route's count did not grow "
                               f"by one: {counts}")
        xk = outs[route]
        equal = torch.equal(xk, xp) and torch.equal(outs["direct"], xk)
        worst = max(worst, float((xk - xp).abs().max()))
        line = (f"[{tag}] {label} {'U' if B.upper else 'L'} level {li} "
                f"({_mode(B)}, superblock {B.levels[li][0]}, "
                f"{len(B.levels[li][1])} cross legs) bit_equal="
                f"{torch.equal(xk, xp)} route={route} "
                f"{'direct' if route == first else first}_route_bit_equal="
                f"{torch.equal(outs['direct'], outs[first])}")
        if timed:
            def launch(rt):
                def run():
                    with _on_route(rt, B):
                        bk.super_level(B, li, y, outs[rt])
                return run
            turns = _in_turns(torch, {rt: launch(rt) for rt in routes},
                              ("direct", first, first, "direct"))
            bound = _bound(*work(B, li, x.element_size()))
            ms.append(min(turns[route]))
            if by_level is not None:
                by_level.append((min(turns[first]), min(turns["direct"]),
                                 bound["bound_ms"]))
            line += (f" device_ms in turns {first}={turns[first]} "
                     f"direct={turns['direct']} bound_ms="
                     f"{bound['bound_ms']:.5f} ({bound['bound_by']})")
            plain_ms.append(_median_ms(
                lambda: bk.super_level_plain(B, li, y, xp), torch, reps=3,
                batch=3))
            line += f" plain_ms={plain_ms[-1]:.4f}"
        print(line)
        if not equal:
            raise RuntimeError(f"level disagrees with plain: {line}")
    return ms, plain_ms, worst


def _ilu_lower_csr(torch, bk, A, L):
    """L's unit lower triangle in the colour-sorted ordering as a
    torch.sparse_csr_tensor, and the permutation (new → old): entry (i, j)
    of a leg whose source colour is lower, valued from the class table."""
    nx, ny, nz, sx = L.spec_params[:4]
    n = A.n_rows
    i, (gx, gy, gz), color, perm, inv = _colour_order(torch, L)
    base = torch.empty(n, dtype=torch.int64, device="cuda")
    for li in range(len(L.levels)):
        rows = i.view(nz, ny, nx)[bk._rows(L, li)[5]]
        base[rows.reshape(-1)] = bk._class_base(L, li, "cuda").reshape(-1)
    h = L.radius // (L.S * sx)
    w = 2 * h + 1
    r_all, c_all, v_all = [inv], [inv], [torch.ones(n, dtype=L.dtype,
                                                    device="cuda")]
    for (dx, dy, dz) in A.legs:
        ok = ((gx + dx >= 0) & (gx + dx < nx) & (gy + dy >= 0)
              & (gy + dy < ny) & (gz + dz >= 0) & (gz + dz < nz))
        j = (i + (dx + nx * (dy + ny * dz))).clamp(0, n - 1)
        ok &= color[j] < color
        kd = (dx + h) + w * ((dy + h) + w * (dz + h))
        r_all.append(inv[ok])
        c_all.append(inv[j[ok]])
        v_all.append(L.table[kd][base[ok]])
    return _sorted_csr(torch, r_all, c_all, v_all, n), perm


def _colour_order(torch, L):
    """The rows, their grid coordinates and colours under L's grid spec,
    the colour-sorted permutation (new → old) and its inverse."""
    nx, ny, nz, sx, sy, sz = L.spec_params
    i = torch.arange(L.n_rows, device="cuda")
    gx, gy, gz = i % nx, (i // nx) % ny, i // (nx * ny)
    color = gx % sx + sx * (gy % sy + sy * (gz % sz))
    perm = torch.sort(color, stable=True).indices
    inv = torch.empty_like(perm)
    inv[perm] = i
    return i, (gx, gy, gz), color, perm, inv


def _sorted_csr(torch, r_all, c_all, v_all, n):
    """The (n, n) torch.sparse_csr_tensor of the triplet pieces."""
    r, c, v = torch.cat(r_all), torch.cat(c_all), torch.cat(v_all)
    order = torch.argsort(r * n + c)
    crow = torch.zeros(n + 1, dtype=torch.int64, device="cuda")
    crow[1:] = torch.bincount(r, minlength=n).cumsum(0)
    return torch.sparse_csr_tensor(crow, c[order], v[order], (n, n))


def _const_lower_csr(torch, A, L):
    """The const pair's L, the colour-lower part of the stencil A and its
    diagonal, in the colour-sorted ordering as a torch.sparse_csr_tensor,
    and the permutation (new → old)."""
    nx, ny, nz = L.spec_params[:3]
    n = A.n_rows
    i, (gx, gy, gz), color, perm, inv = _colour_order(torch, L)
    r_all, c_all, v_all = [], [], []
    for (dx, dy, dz), cv in zip(A.legs, A.coeff_values):
        ok = ((gx + dx >= 0) & (gx + dx < nx) & (gy + dy >= 0)
              & (gy + dy < ny) & (gz + dz >= 0) & (gz + dz < nz))
        j = (i + (dx + nx * (dy + ny * dz))).clamp(0, n - 1)
        if (dx, dy, dz) != (0, 0, 0):
            if cv == 0.0:
                continue
            ok &= color[j] < color
        r_all.append(inv[ok])
        c_all.append(inv[j[ok]])
        v_all.append(torch.full((int(ok.sum()),), cv, dtype=L.dtype,
                                device="cuda"))
    return _sorted_csr(torch, r_all, c_all, v_all, n), perm


def phase_ilu0_level_vs_plain(torch, bt):
    """The factor-table level kernel against its plain version, bit for
    bit: every level of the L and U solves of HPCG 128^3 (f32, f64) and
    384^3 (f32) and a whole blocked_ilu0; each level on both routes
    (staged, the shape's; direct, the first port's kernel), bit-equal to
    each other, timed by device time in turns beside its bound
    (_level_work), and the whole apply on both routes in turns.  Then one
    whole L solve of 128^3 through torch.triangular_solve (the library's
    sparse triangular solve) against blocked_trisolve.  Returns the 128^3
    f32 record (ms: the mean level; the 384^3 means beside it) and the two
    L solves' ms."""
    from basic_iterative_solvers_tpu_torch.ops import block_trisolve as bk
    record = whole_l = None
    for spec, dt in ((MAIN_SPEC, torch.float32), (MAIN_SPEC, torch.float64),
                     (ILU_384, torch.float32)):
        A, L, U, setup_s = _ilu0_pair(torch, bt, spec, dt)
        g = torch.Generator(device="cuda").manual_seed(4)
        y = torch.randn(A.n_rows, dtype=dt, device="cuda", generator=g)
        x = torch.randn(A.n_rows, dtype=dt, device="cuda", generator=g)
        label = f"{spec} {str(dt)[6:]}"
        print(f"[ilu0-level] {label}: pair built in {setup_s:.3f} s "
              f"(prototype {L.proto}, radius {L.radius}, table "
              f"{tuple(L.table.shape)})")
        ms, plain_ms, worst, by_level = [], [], 0.0, []
        for B in (L, U):
            k, p, e = _check_levels(torch, bk, label, B, y, x,
                                    range(len(B.levels)),
                                    timed=dt == torch.float32,
                                    by_level=by_level)
            ms += k
            plain_ms += p
            worst = max(worst, e)
        zk = bk.blocked_ilu0(L, U, y)
        zp = _plain_ilu0(bk, L, U, y)
        zd = _direct(bk.blocked_ilu0, L, U, y)
        torch.cuda.synchronize()
        # float64 takes the direct route (block_trisolve.level_route_for)
        applies = (_in_turns(torch, {
            "staged": lambda: bk.blocked_ilu0(L, U, y),
            "direct": lambda: _direct(bk.blocked_ilu0, L, U, y)},
            ("staged", "direct", "direct", "staged"))
            if dt == torch.float32 else
            {"direct": [_median_ms(lambda: bk.blocked_ilu0(L, U, y),
                                   torch)]})
        works = [_level_work(B, li, A.coeffs.element_size())
                 for B in (L, U) for li in range(len(B.levels))]
        bound = _bound(sum(b for b, _o in works), sum(o for _b, o in works))
        equal = torch.equal(zk, zp) and torch.equal(zd, zk)
        print(f"[ilu0-level] {label} blocked_ilu0 (2x{L.S} levels) against "
              f"the plain levels: bit_equal={torch.equal(zk, zp)} (direct "
              f"route {torch.equal(zd, zk)}) device ms {applies} "
              f"bound_ms={bound['bound_ms']:.4f} ({bound['bound_by']}, at "
              f"the float32 rate); levels (staged, direct, bound) ms: "
              f"{[tuple(round(v, 5) for v in t) for t in by_level]}")
        if not equal:
            raise RuntimeError(f"{label}: whole ILU(0) apply disagrees")
        if spec == MAIN_SPEC and dt == torch.float32:
            record = {"max_abs_err": worst, "ms": statistics.mean(ms),
                      "direct_ms": statistics.mean(t[1] for t in by_level),
                      "plain_ms": statistics.mean(plain_ms),
                      "library_ms": None,
                      **_mean_bound([_level_work(B, li, 4) for B in (L, U)
                                     for li in range(len(B.levels))])}
            M, perm = _ilu_lower_csr(torch, bk, A, L)
            ref = bk.blocked_trisolve(L, y)[perm]
            yp = y[perm].unsqueeze(1).contiguous()
            sol = torch.triangular_solve(yp, M, upper=False).solution
            rel = float((sol[:, 0] - ref).abs().max() / ref.abs().max())
            lib_ms = _median_ms(
                lambda: torch.triangular_solve(yp, M, upper=False), torch,
                reps=5, batch=2)
            own_ms = _median_ms(lambda: bk.blocked_trisolve(L, y), torch)
            whole_l = {"library_ms": lib_ms, "blocked_trisolve_ms": own_ms}
            print(f"[library] {label} one whole L solve (nnz "
                  f"{M.values().numel()}): torch.triangular_solve on the "
                  f"colour-sorted sparse CSR triangle ms={lib_ms:.4f} "
                  f"max_rel_err={rel:.3e}; blocked_trisolve "
                  f"({L.S} level launches) ms={own_ms:.4f}")
            if not rel <= TOL["float32"]:
                raise RuntimeError("the library's L solve disagrees")
            del M
        if spec == ILU_384:
            record.update(
                ms_384=statistics.mean(t[0] for t in by_level),
                direct_ms_384=statistics.mean(t[1] for t in by_level),
                bound_ms_384=statistics.mean(t[2] for t in by_level),
                apply_ms_384=min(applies["staged"]),
                direct_apply_ms_384=min(applies["direct"]),
                bound_apply_ms_384=bound["bound_ms"])
        del A, L, U, x, y, zk, zp, zd
        torch.cuda.empty_cache()
    return record, whole_l


def _split_routes(B):
    """The routes of a split step of B: its mode's new route ("staged" for
    a factor table, "line" in plane mode), then "direct"."""
    return ("staged" if B.is_table else "line", "direct")


def _sectors(starts, cols, item):
    """The 32-byte sectors holding elements s + c, s of `starts` (an array
    of offsets in elements from a 32-byte aligned base), c of `cols`."""
    import numpy as np
    per = 32 // item
    cols = np.asarray(sorted(cols), dtype=np.int64)
    if not cols.size:
        return 0
    phase, count = np.unique(np.asarray(starts) % per, return_counts=True)
    return int(sum(int(c) * np.unique((ph + cols) // per).size
                   for ph, c in zip(phase, count)))


def _parity_sector_bytes(B, li, p, itemsize, has_acc):
    """The bytes of the 32-byte sectors one parity step must move: those
    holding parity p's rows of acc (or of y) read, of x written, and of
    each plane (vs) and the per-row 1/D read; those holding the solved
    source rows of x read; the factor-table values as _level_work counts
    them."""
    import numpy as np
    nx, ny, nz, sx, sy, sz = B.spec_params
    sb, _cross, selfs = B.levels[li]
    line = np.arange(B.m // nx)
    my = ny // sy
    rows = nx * (sy * (line % my) + sb % sy + ny * (sz * (line // my)
                                                    + sb // sy))
    slots = line * nx
    own = range(p, nx, sx)
    src = {x + dx for x in own for dx in selfs if 0 <= x + dx < nx
           and (((x + dx) % sx > p) if B.upper else ((x + dx) % sx < p))}
    sectors = (_sectors(slots if has_acc else rows, own, itemsize)
               + _sectors(rows, src, itemsize) + _sectors(rows, own, itemsize))
    table = 0
    if B.is_plane:
        sectors += sum(_sectors(l * B.m + slots, own, itemsize)
                       for l in range(len(selfs)))
        sectors += _sectors(rows, own, itemsize)
    elif B.is_table:
        self_rows = {dx: [x for x in own if 0 <= x + dx < nx and (
            ((x + dx) % sx > p) if B.upper else ((x + dx) % sx < p))]
            for dx in selfs}
        table = _table_values(B, li, self_rows, (p,), False) * itemsize
    return 32 * sectors + table


def _split_steps(torch, bk, tag, label, B, y, x, work):
    """super_acc and super_parity against their plain versions on every
    level of the split solve B, bit for bit on both routes of its mode
    (_split_routes), each launch counted on its route; each step timed by
    device time in turns (direct, new, new, direct) beside its byte bound
    (`work`: _level_work or _plane_level_work) and, for a parity step,
    its sector bound.  Returns {step: {route: [ms a launch],
    "bound": [(bytes, ops)], "sector_bound_ms": [...], "plain": [ms]}}."""
    item = x.element_size()
    out = {step: {"bound": [], "sector_bound_ms": [], "plain": []}
           for step in ("acc", "par")}
    acc_k = torch.empty(B.m, dtype=x.dtype, device=x.device)
    acc_p = torch.empty_like(acc_k)
    nap = 2_000_000           # ~1 ms of sleep ahead of each timed batch
    routes = _split_routes(B)

    def launches(fn, route, *args):
        counter = bk.super_acc if fn is bk.super_acc else bk.super_parity
        before = (counter.launches, getattr(counter, f"{route}_launches"))
        with _on_route(route, B):
            fn(B, *args)
        grew = (counter.launches - before[0],
                getattr(counter, f"{route}_launches") - before[1])
        if grew != (1, 1):
            raise RuntimeError(f"{counter.__name__} on {route} did not count "
                               f"one launch on its route: {grew}")

    def timed(fn, *args):
        def run(route):
            def call():
                with _on_route(route, B):
                    fn(B, *args)
            return call
        return _in_turns(torch, {rt: run(rt) for rt in routes},
                         ("direct", routes[0], routes[0], "direct"),
                         sleep_cycles=nap)

    for li, (_sb, cross, _s) in enumerate(B.levels):
        line = (f"[{tag}] {label} {'U' if B.upper else 'L'} level {li} "
                f"({len(cross)} cross legs):")
        if cross:
            bk.super_acc_plain(B, li, y, x, acc_p)
            for route in routes:
                acc_k.fill_(float("nan"))
                launches(bk.super_acc, route, li, y, x, acc_k)
                torch.cuda.synchronize()
                if not torch.equal(acc_k, acc_p):
                    raise RuntimeError(f"{line} super_acc on {route} "
                                       "disagrees with plain")
            turns = timed(bk.super_acc, li, y, x, acc_k)
            for route in routes:
                out["acc"].setdefault(route, []).append(min(turns[route]))
            out["acc"]["bound"].append(work(B, li, item, "acc"))
            out["acc"]["plain"].append(_median_ms(
                lambda: bk.super_acc_plain(B, li, y, x, acc_p), torch,
                reps=3, batch=3))
            bound = _bound(*out["acc"]["bound"][-1])
            line += (f" super_acc bit_equal=True on {','.join(routes)}, "
                     f"device_ms in turns {turns} bound_ms="
                     f"{bound['bound_ms']:.5f} ({bound['bound_by']});")
        a = acc_p if cross else None
        for p in bk._parity_order(B):
            xp = x.clone()
            bk.super_parity_plain(B, li, p, y, a, xp)
            outs = {}
            for route in routes:
                outs[route] = x.clone()
                launches(bk.super_parity, route, li, p, y, a, outs[route])
            torch.cuda.synchronize()
            if not all(torch.equal(xk, xp) for xk in outs.values()):
                raise RuntimeError(f"{line} super_parity disagrees with "
                                   f"plain at parity {p}")
            xk = outs[routes[0]]
            turns = timed(bk.super_parity, li, p, y, a, xk)
            for route in routes:
                out["par"].setdefault(route, []).append(min(turns[route]))
            out["par"]["bound"].append(work(B, li, item, "parity", p))
            out["par"]["plain"].append(_median_ms(
                lambda: bk.super_parity_plain(B, li, p, y, a, xp), torch,
                reps=3, batch=3))
            bound = _bound(*out["par"]["bound"][-1])
            sector = 1e3 * _parity_sector_bytes(
                B, li, p, item, cross != ()) / PEAK_BYTES_S
            out["par"]["sector_bound_ms"].append(sector)
            line += (f" super_parity p={p} bit_equal=True on "
                     f"{','.join(routes)}, device_ms in turns {turns} "
                     f"bound_ms={bound['bound_ms']:.5f} ({bound['bound_by']})"
                     f" sector_bound_ms={sector:.5f};")
            x = xp              # the next parity reads this one's rows
        print(line)
        # the plain steps' plan of this level (tens of GB over a 384^3
        # pair's levels if kept)
        bk._whole(B)._args.pop(("plain", li, str(x.device)), None)
    return out


def _split_record(steps, step):
    """A #10 or #11 record from _split_steps' results: the new route's
    mean device time as ms, the direct route's as direct_ms, the plain
    version's, the mean byte bound and, for parity, the mean sector
    bound."""
    s = steps[step]
    new = next(k for k in s if k in ("staged", "line"))
    rec = {"max_abs_err": 0.0, "ms": statistics.mean(s[new]),
           "direct_ms": statistics.mean(s["direct"]),
           "plain_ms": statistics.mean(s["plain"]), "library_ms": None,
           **_mean_bound(s["bound"])}
    if s["sector_bound_ms"]:
        rec["sector_bound_ms"] = statistics.mean(s["sector_bound_ms"])
    return rec


def _release(torch, *solves):
    """Drop the launch tables and plain plans cached on `solves` (a solve
    and its one-shard view refer to each other, so they wait for the
    cycle collector otherwise: the 384^3 levels' plans take tens of GB),
    then return the freed blocks to the card."""
    import gc
    for B in solves:
        B._args.clear()
    gc.collect()
    torch.cuda.empty_cache()


def _split_applies(torch, bk, tag, label, fused, split, y):
    """Whole ILU(0) applies in turns by device time: the fused pair, the
    split pair on the routes the picker names and on the direct route;
    all bit-equal.  Returns {name: [ms, ...]}."""
    fns = {"fused": lambda: bk.blocked_ilu0(*fused, y),
           "split": lambda: bk.blocked_ilu0(*split, y),
           "split_direct": lambda: _direct(bk.blocked_ilu0, *split, y)}
    outs = {k: fn() for k, fn in fns.items()}
    torch.cuda.synchronize()
    equal = all(torch.equal(o, outs["fused"]) for o in outs.values())
    turns = _in_turns(torch, fns, ("fused", "split", "split_direct",
                                   "split_direct", "split", "fused"))
    print(f"[{tag}] {label} whole apply, device ms in turns: {turns} "
          f"bit_equal={equal}")
    if not equal:
        raise RuntimeError(f"{label}: split and fused applies differ")
    return turns


def phase_split_vs_plain(torch, bt):
    """super_acc and super_parity against their plain versions on every
    level of the 384^3 pair in float32 and float64, bit for bit on the
    staged and the direct route, each step timed in turns beside its bounds
    (_split_steps); then whole applies: the fused pair and the split pair
    on both routes, in turns, bit-equal.  Returns the #10 and #11 records
    and the applies' times."""
    from basic_iterative_solvers_tpu_torch.ops import block_trisolve as bk
    records, applies = {}, {}
    for dt in (torch.float32, torch.float64):
        A, L, U, _s = _ilu0_pair(torch, bt, ILU_384, dt)
        Ls, Us = _split_pair(L, U)
        g = torch.Generator(device="cuda").manual_seed(5)
        y = torch.randn(A.n_rows, dtype=dt, device="cuda", generator=g)
        x = torch.randn(A.n_rows, dtype=dt, device="cuda", generator=g)
        label = f"{ILU_384} {str(dt)[6:]}"
        steps = {}
        for B in (Ls, Us):
            for step, res in _split_steps(torch, bk, "ilu0-split", label, B,
                                          y, x, _level_work).items():
                for k, v in res.items():
                    steps.setdefault(step, {}).setdefault(k, []).extend(v)
        applies[label] = _split_applies(torch, bk, "ilu0-split", label,
                                        (L, U), (Ls, Us), y)
        recs = {name: _split_record(steps, step) for name, step in
                (("super_acc", "acc"), ("super_parity", "par"))}
        print(f"[ilu0-split] {label} means over the levels: " + "; ".join(
            f"{name} " + " ".join(f"{k}={v:.5f}" for k, v in r.items()
                                  if isinstance(v, float))
            for name, r in recs.items()))
        if dt == torch.float32:
            records = recs
        else:
            for name, r in recs.items():
                records[name]["by_mode"] = {f"table, {label}": r}
        _release(torch, L, U, Ls, Us)
        del A, L, U, Ls, Us, B, x, y
    return records, applies


def phase_cpu_vs_card_ilu0(torch, bt):
    """f64 CG + ILU(0) on HPCG 32^3 on the CPU and on the card: the same
    iteration count, histories to rtol 1e-8."""
    import numpy as np
    S, P = bt.SolverType, bt.PrecondType
    c, g = (bt.solve(_setup(torch, bt, "hpcg:32x32x32", torch.float64, dev,
                            S.CONJUGATE_GRADIENT, preconditioner=P.ILU0,
                            tolerance=1e-10, max_iters=1000))
            for dev in ("cpu", "cuda"))
    print(f"[cpu-vs-card] hpcg:32x32x32 f64 CG + ILU(0): iters cpu="
          f"{c.iter_count} card={g.iter_count} final cpu="
          f"{c.final_residual_norm:.6e} card={g.final_residual_norm:.6e}")
    if c.iter_count != g.iter_count or not (c.converged and g.converged):
        raise RuntimeError("CG + ILU(0): CPU and card solves differ")
    np.testing.assert_allclose(g.residual_norms[:-1], c.residual_norms[:-1],
                               rtol=1e-8)


#: the bench's exact-ILU(0) rows (bench.py:554-559, 591-595; iterations
#: DEFAULT_ITERS["pcg"], bench.py:83-86): name, spec, iterations
SLICE4_ROWS = (("pcg_ilu0", MAIN_SPEC, 1200),
               ("pcg_ilu0@384", ILU_384, 100))


def phase_slice4_path(torch, bt):
    """The bench's pcg_ilu0 rows, f32, fused harness, tolerance 0, b = 2,
    x0 = 1, each after a warm-up solve with every counter set to 0 just
    before the timed solve and read just after: 8 factor-table level
    launches per preconditioner apply (one per iteration and the initial
    one); the 384^3 row again on the split route (BIS_SB_ALIGNED=0, which
    the package reads at import: set here on the module), every acc and
    parity launch on the staged route, then on the staged and the direct
    route in turns.  Set-up seconds
    and peak memory per row.  Then float64 CG + ILU(0) on 128^3 to 1e-8.
    Returns each row's launches of the factor-table level and of the split
    pair, by row name."""
    import math
    from basic_iterative_solvers_tpu_torch.ops import block_trisolve as bk
    from basic_iterative_solvers_tpu_torch.ops import gmres_basis as gb
    from basic_iterative_solvers_tpu_torch.solvers import make_method
    so = bt.stencil_op
    S, P = bt.SolverType, bt.PrecondType
    launches, row_ms = {}, {}
    rows = [(name, spec, iters, False) for name, spec, iters in SLICE4_ROWS]
    rows.append(("pcg_ilu0@384 split", ILU_384, 100, True))
    for name, spec, iters, split in rows:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        bk.NO_ALIGNED = split
        try:
            t0 = time.perf_counter()
            setup = _setup(torch, bt, spec, torch.float32, "cuda",
                           S.CONJUGATE_GRADIENT, preconditioner=P.ILU0,
                           max_iters=iters, tolerance=0.0,
                           breakdown_stall=True)
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t0
        finally:
            bk.NO_ALIGNED = False
        L, U = setup.M.L_block, setup.M.U_block
        if not (L.is_table and L.fused != split and U.fused != split):
            raise RuntimeError(f"{name} did not take the factor-table "
                               f"{'split' if split else 'fused'} route")
        solver = make_method(setup)
        bt.solve(setup, method=solver)                # warm-up solve
        _counters(so, gb, bk, reset=True)
        res = bt.solve(setup, method=solver)
        counts = _counters(so, gb, bk)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        ms = 1e3 * res.solve_seconds / max(1, res.iter_count)
        applies = res.iter_count + 1
        print(f"[slice4] {spec} f32 {name} fused harness: "
              f"iters={res.iter_count} ms/iter={ms:.5f} setup_s={setup_s:.3f} "
              f"peak_GB={peak_gb:.3f} r0={res.residual_norms[0]:.6e} "
              f"final_explicit_f64={res.final_residual_norm:.6e} "
              f"launches={counts}")
        ok = (res.iter_count == iters
              and math.isfinite(res.final_residual_norm)
              and bool(torch.isfinite(res.x_star).all())
              and counts["stencil_spmv"] >= res.iter_count
              and counts["super_level"] == 0)
        n_acc = sum(1 for B in (L, U) for lv in B.levels if lv[1])
        split_counts = (n_acc * applies, 2 * L.S * L.sx * applies)
        if split:
            # every split launch on the picker's route: staged (f32)
            ok = ok and counts["super_level_table"] == 0 and (
                counts["super_acc"], counts["super_parity"]) == (
                counts["super_acc_staged"], counts["super_parity_staged"]) \
                == split_counts
        else:
            ok = ok and counts["super_level_table"] == 2 * L.S * applies and (
                counts["super_acc"] == counts["super_parity"] == 0) and (
                counts["super_level_table_staged"]
                == counts["super_level_table"])
        if not ok:
            raise RuntimeError(f"slice-4 {name} run failed its checks")
        launches[name] = {k: counts[k] for k in counts
                          if k.startswith(("super_level_table", "super_acc",
                                           "super_parity"))}
        row_ms[name] = ms
        if split:
            # both split routes in turns, every count set to 0 just before
            # each solve and read just after, beside the fused row
            turns = {}
            for route in ("staged", "direct", "direct", "staged"):
                _counters(so, gb, bk, reset=True)
                with _on_route(route, L, U):
                    r = bt.solve(setup, method=solver)
                c = _counters(so, gb, bk)
                if not (r.iter_count == iters and (
                        c["super_acc"], c["super_parity"]) == (
                        c[f"super_acc_{route}"], c[f"super_parity_{route}"])
                        == split_counts and c["super_level_table"] == 0):
                    raise RuntimeError(f"{name} on the {route} route failed "
                                       f"its checks: {c}")
                turns.setdefault(route, []).append(
                    1e3 * r.solve_seconds / r.iter_count)
            print(f"[slice4] {spec} f32 {name}: ms/iter in turns (staged, "
                  f"direct, direct, staged): staged={turns['staged']} "
                  f"direct={turns['direct']}; the fused row in this run "
                  f"{row_ms['pcg_ilu0@384']:.5f}; launches a solve by "
                  f"route: super_acc {split_counts[0]}, super_parity "
                  f"{split_counts[1]}")
        if spec == ILU_384 and not split:
            # both factor-table routes in turns, every count set to 0 just
            # before each solve and read just after
            turns = {}
            for route in ("staged", "direct", "direct", "staged"):
                _counters(so, gb, bk, reset=True)
                with _on_route(route, L, U):
                    r = bt.solve(setup, method=solver)
                c = _counters(so, gb, bk)
                if not (r.iter_count == iters and c["super_level_table"]
                        == c[f"super_level_table_{route}"]
                        == 2 * L.S * applies):
                    raise RuntimeError(f"{name} on the {route} route failed "
                                       "its checks")
                turns.setdefault(route, []).append(
                    1e3 * r.solve_seconds / r.iter_count)
            print(f"[slice4] {spec} f32 {name}: ms/iter in turns (staged, "
                  f"direct, direct, staged): staged={turns['staged']} "
                  f"direct={turns['direct']}")
        del setup, solver, res, L, U

    res = bt.solve(_setup(torch, bt, MAIN_SPEC, torch.float64, "cuda",
                          S.CONJUGATE_GRADIENT, preconditioner=P.ILU0,
                          tolerance=1e-8, max_iters=1000))
    r0 = res.residual_norms[0]
    print(f"[slice4] {MAIN_SPEC} f64 CG + ILU(0) to tol 1e-8: "
          f"iters={res.iter_count} converged={res.converged} "
          f"final_explicit/r0={res.final_residual_norm / r0:.3e} "
          f"ms/iter={1e3 * res.solve_seconds / res.iter_count:.5f}")
    if not (res.converged and res.final_residual_norm <= 10 * 1e-8 * r0):
        raise RuntimeError("f64 CG + ILU(0) solve did not converge")
    return launches


# ---------------------------------------------------------------------------
# Slice 5: DIA, lane-ELL, rank-space levels, natural-order level solves
# ---------------------------------------------------------------------------

DIA_384 = "hpcg:384x384x384"
#: the JAX bench's cg@sband matrix (bench.py:295-331) and the rank-space
#: row's band (bench pbicgstab's budget, bench.py:83-86)
SBAND = "sband:500000,8,400"
BAND = "band:8388608,2"


def _sparse_counters(bt, reset=False):
    """The launch counts of the slice-5 kernels, and of each lane-ELL
    route (`reset`: set to 0 first)."""
    from basic_iterative_solvers_tpu_torch.ops import block_trisolve as bk
    from basic_iterative_solvers_tpu_torch.ops import dia_spmv, lane_ell
    fns = {"dia_spmv": (dia_spmv.dia_spmv, "launches"),
           "lane_ell_spmv": (lane_ell.lane_ell_spmv, "launches"),
           "rank_level": (bk.rank_level, "launches"),
           "rank_level_vec": (bk.rank_level, "vec_launches"),
           "rank_level_scalar": (bk.rank_level, "scalar_launches"),
           "stencil_spmv": (bt.stencil_op.stencil_spmv, "launches")}
    for route in lane_ell.ROUTES:
        fns[f"lane_ell_spmv_{route}"] = (lane_ell.lane_ell_spmv,
                                         f"{route}_launches")
    if reset:
        for fn, attr in fns.values():
            setattr(fn, attr, 0)
    return {name: getattr(fn, attr) for name, (fn, attr) in fns.items()}


def _in_turns(torch, fns, order, sleep_cycles=20_000_000):
    """Each callable of `fns` timed by its device time (_device_ms, behind
    a sleep of `sleep_cycles`, by default ~10 ms: most batches enqueue in
    well under that) in the order given, names repeating (in turns);
    returns {name: [ms, ...]}."""
    out = {}
    for name in order:
        out.setdefault(name, []).append(
            _device_ms(fns[name], torch, sleep_cycles=sleep_cycles))
    return out


def _padded_whole(torch, le, M, x):
    """The first port's loop over all K slots with int32 indices, on one
    device: the padded route of #5's shard form over one shard holding
    M's rows (the x2-rows up to n, its planes copied once), its window x
    with S x2-rows of zeros a side.  Returns a callable giving y (n rows),
    which the turns time beside the counted routes."""
    R = -(-M.n_rows // le.LANES)
    vals, idx = (t[:, :R].contiguous() for t in (M.vals, M.idx))
    h = M.S * le.LANES
    xw = torch.nn.functional.pad(x, (h, R * le.LANES - M.n_rows + h))
    out = torch.empty(R * le.LANES, dtype=x.dtype, device=x.device)
    return lambda: le._lane_ell_spmv_halo_cuda(
        M, vals, idx, xw, 0, M.S, out, "padded")[:M.n_rows]


def _lane_ell_bytes(torch, M, item, idx_bytes):
    """(padded bytes, counted bytes, slots read, slots a warp fetches) of
    one SpMV of M: the padded route reads every slot's value and int32
    index; the counted routes the slots before each row's count (value and
    `idx_bytes` of index), the counts; both x once and y once."""
    n = M.n_rows
    lens = M.row_len.reshape(-1)[:n].long()
    slots = int(lens.sum())
    warps = 32 * int(torch.nn.functional.pad(lens, (0, -n % 32))
                     .view(-1, 32).amax(1).sum())
    xy = 2 * n * item
    return (M.K * n * (item + 4) + xy,
            slots * (item + idx_bytes) + n * M.row_len.element_size() + xy,
            slots, warps)


def _csr_on_card(torch, A, dtype):
    """A host MatrixCSR as a torch.sparse_csr_tensor on the card."""
    return torch.sparse_csr_tensor(
        torch.from_numpy(A.row_ptr).cuda(),
        torch.from_numpy(A.col.astype("int64")).cuda(),
        torch.from_numpy(A.val).to(dtype=dtype, device="cuda"),
        (A.n_rows, A.n_cols))


def _kernel_vs_plain(torch, tag, label, kernel, plain, counter, x,
                     plain_reps=20):
    """kernel(x) against plain(x) on the card, bit for bit, both timed;
    one launch counted per kernel call.  Returns (max_abs_err, ms,
    plain_ms)."""
    before = counter.launches
    yk, yp = kernel(x), plain(x)
    torch.cuda.synchronize()
    if counter.launches != before + 1:
        raise RuntimeError(f"{tag}: the launch count did not grow")
    err = float((yk - yp).abs().max())
    equal = torch.equal(yk, yp)
    ms = _median_ms(lambda: kernel(x), torch)
    plain_ms = _median_ms(lambda: plain(x), torch, reps=plain_reps,
                          batch=max(1, plain_reps // 2))
    print(f"[{tag}] {label}: bit_equal={equal} max_abs_err={err:.3e} "
          f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}")
    if not equal:
        raise RuntimeError(f"{tag} {label}: kernel disagrees with plain")
    return err, ms, plain_ms


def phase_dia_vs_plain(torch, bt):
    """Kernel #4 against its plain version, bit for bit, on the DIA
    operators of HPCG 128^3 (f32, f64) and 384^3 (f32) built on the card;
    the library's CSR SpMV of the same matrix beside it.  Returns the
    128^3 f32 record."""
    from basic_iterative_solvers_tpu_torch.ops import dia_spmv as ds
    record = None
    for spec, dt in ((MAIN_SPEC, torch.float32), (MAIN_SPEC, torch.float64),
                     (DIA_384, torch.float32)):
        t0 = time.perf_counter()
        A = bt.dia.from_source_device(spec, dt, device="cuda")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        x = torch.randn(A.n_rows, dtype=dt, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(6))
        label = (f"{spec} {str(dt)[6:]} ({len(A.offsets)} diagonals, built "
                 f"on the card in {build_s:.3f} s)")
        err, ms, plain_ms = _kernel_vs_plain(
            torch, "dia", label, lambda v: ds.dia_spmv(A, v),
            lambda v: ds.dia_spmv_plain(A, v), ds.dia_spmv, x,
            plain_reps=20 if spec == MAIN_SPEC else 4)
        k, n, item = len(A.offsets), A.n_rows, x.element_size()
        bound = _bound(bt.device_matrix.device_matrix_nnz_bytes(A)
                       + 2 * n * item, 2 * k * n)
        print(f"[dia] {spec} {str(dt)[6:]} bound_ms={bound['bound_ms']:.4f} "
              f"({bound['bound_by']}: {k} diagonals + x + y, "
              f"{item * (k + 2) * n / 1e6:.1f} MB) kernel_GB/s="
              f"{item * (k + 2) * n / (ms * 1e6):.0f}")
        if (spec, dt) == (MAIN_SPEC, torch.float32):
            So = bt.stencil_op.from_source_operator(spec, dt, device="cuda")
            M = _stencil_csr(torch, So)
            del So
            lib_ms = _median_ms(lambda: M @ x, torch)
            lib_rel = float((M @ x - ds.dia_spmv(A, x)).abs().max()
                            / ds.dia_spmv(A, x).abs().max())
            print(f"[library] {spec} f32 torch.sparse_csr_tensor @ x of the "
                  f"same matrix: ms={lib_ms:.4f} max_rel_err={lib_rel:.3e}")
            if not lib_rel <= TOL["float32"]:
                raise RuntimeError("the library SpMV disagrees")
            del M
            record = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "library_ms": lib_ms, **bound}
        del A, x
        torch.cuda.empty_cache()
    return record


def _lane_ell_route_checks(torch, tag, label, le, M, x, twin=None):
    """Every route of kernel #5 on M against its plain version, bit for bit
    (and against `twin`, the float32-value kernel on the widened values,
    where given), each launch counted in its route's counter.  Returns the
    largest abs error against plain."""
    yp = le.lane_ell_spmv_plain(M, x)
    yt = None if twin is None else twin(x)
    err = 0.0
    for route in le.ROUTES:
        before = getattr(le.lane_ell_spmv, f"{route}_launches")
        yk = le._lane_ell_spmv_cuda(M, x, route)
        torch.cuda.synchronize()
        if getattr(le.lane_ell_spmv, f"{route}_launches") != before + 1:
            raise RuntimeError(f"{tag} {label}: the {route} count did not "
                               "grow")
        err = max(err, float((yk - yp).abs().max()))
        equal = torch.equal(yk, yp)
        twin_equal = yt is None or torch.equal(yk, yt)
        print(f"[{tag}] {label} route {route}: bit_equal_plain={equal}"
              + ("" if yt is None else
                 f" bit_equal_widened_twin={twin_equal}"))
        if not (equal and twin_equal):
            raise RuntimeError(f"{tag} {label}: route {route} disagrees")
    return err


def phase_lane_ell_vs_plain(torch, bt):
    """Kernel #5 against its plain version, bit for bit, on the lane-ELL
    planes of sband:500000,8,400 (f32, f64), on each route: idx16 (the
    16-bit index plane, the shape's route) and idx32 (the int32 plane),
    both stopping each row at its count; and padded, the first port's loop
    over all K slots (_padded_whole).  The device times in turns (padded,
    idx16, idx32, idx32, idx16, padded) beside the library's CSR SpMV of
    the same matrix (f32, device time too), the padded bound and the bound
    of the slots the counted routes read.  Returns the f32 record and the host
    matrix."""
    from basic_iterative_solvers_tpu_torch.ops import lane_ell as le
    t0 = time.perf_counter()
    A = bt.generators.from_source(SBAND)
    gen_s = time.perf_counter() - t0
    record = None
    for dt in (torch.float32, torch.float64):
        t0 = time.perf_counter()
        M = bt.from_csr(A, dt, "lane_ell", device="cuda")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        if le.route_for(M) != "idx16":
            raise RuntimeError(f"{SBAND} did not take the idx16 route")
        x = torch.randn(A.n_rows, dtype=dt, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(7))
        label = (f"{SBAND} {str(dt)[6:]} (nnz {A.nnz}, K={M.K}, S={M.S}, "
                 f"R={M.R}; host CSR {gen_s:.2f} s, planes {build_s:.2f} s)")
        err = _lane_ell_route_checks(torch, "lane-ell", label, le, M, x)
        fns = {rt: lambda rt=rt: le._lane_ell_spmv_cuda(M, x, rt)
               for rt in le.ROUTES}
        fns["padded"] = _padded_whole(torch, le, M, x)
        if not torch.equal(fns["padded"](), le.lane_ell_spmv_plain(M, x)):
            raise RuntimeError(f"[lane-ell] {label}: the padded loop "
                               "disagrees with plain")
        turns = _in_turns(torch, fns, ("padded", "idx16", "idx32", "idx32",
                                       "idx16", "padded"))
        wrapper_ms = _median_ms(lambda: le.lane_ell_spmv(M, x), torch)
        plain_ms = _median_ms(lambda: le.lane_ell_spmv_plain(M, x), torch)
        n, item = A.n_rows, x.element_size()
        padded, counted, slots, warps = _lane_ell_bytes(torch, M, item, 2)
        bound = _bound(counted, 2 * slots)
        pad_bound = _bound(padded, 2 * M.K * n)
        ms = min(turns["idx16"])
        print(f"[lane-ell] {SBAND} {str(dt)[6:]} device ms in turns "
              f"(padded, idx16, idx32, idx32, idx16, padded): {turns}; "
              f"idx16 through the wrapper (batches of 10) {wrapper_ms:.4f}; "
              f"plain {plain_ms:.4f}")
        print(f"[lane-ell] {SBAND} {str(dt)[6:]} bound_ms="
              f"{bound['bound_ms']:.4f} ({bound['bound_by']}: {slots} slots "
              f"read x ({item} + 2) B + counts + x + y = {counted / 1e6:.1f} "
              f"MB; a warp fetches {warps / (M.K * n):.3f} of the K*n slots) "
              f"against the padded bound {pad_bound['bound_ms']:.4f} "
              f"({M.K} slots x {n} rows x {item + 4} B + x + y = "
              f"{padded / 1e6:.1f} MB): idx16 {bound['bound_ms'] / ms:.3f} "
              f"of its bound ({counted / (ms * 1e6):.0f} GB/s), padded "
              f"{pad_bound['bound_ms'] / min(turns['padded']):.3f} of its")
        if dt == torch.float32:
            C = _csr_on_card(torch, A, dt)
            lib_ms = _device_ms(lambda: C @ x, torch)
            lib_events_ms = _median_ms(lambda: C @ x, torch)
            y = le.lane_ell_spmv(M, x)
            lib_rel = float((C @ x - y).abs().max() / y.abs().max())
            print(f"[library] {SBAND} f32 torch.sparse_csr_tensor @ x: "
                  f"device ms={lib_ms:.4f} (batches of 10 "
                  f"{lib_events_ms:.4f}) max_rel_err={lib_rel:.3e}; idx16 "
                  f"against it {ms / lib_ms:.3f}x")
            if not lib_rel <= TOL["float32"]:
                raise RuntimeError("the library SpMV disagrees")
            record = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "library_ms": lib_ms, "wrapper_ms": wrapper_ms,
                      "padded_ms": min(turns["padded"]),
                      "idx32_ms": min(turns["idx32"]),
                      "padded_bound_ms": pad_bound["bound_ms"], **bound}
            del C
        del M, x
    torch.cuda.empty_cache()
    return record, A


def _rank_level_work(B, li, itemsize):
    """(bytes, operations) of one rank-space level over the m real slots:
    y, dinv and each group's value plane read once, each source colour's
    x once, x written once; a product and a difference per group and
    slot, and the pivot multiply."""
    _c, groups = B.levels[li]
    n_src = len({sc for sc, _d, _g in groups})
    return (itemsize * B.m * (3 + len(groups) + n_src),
            B.m * (2 * len(groups) + 1))


def _band_lower_csr(torch, A, colors):
    """(L_c + D) of the colour-sorted ordering as a torch.sparse_csr_tensor
    on the card, and the permutation (new → old)."""
    import numpy as np
    from basic_iterative_solvers_tpu_torch.coloring import colors_to_perm
    perm, inv = colors_to_perm(colors)
    rows, cols = A.rows(), A.col.astype(np.int64)
    keep = (colors[cols] < colors[rows]) | (rows == cols)
    r, c = inv[rows[keep]].astype(np.int64), inv[cols[keep]].astype(np.int64)
    order = np.lexsort((c, r))
    crow = np.zeros(A.n_rows + 1, dtype=np.int64)
    np.cumsum(np.bincount(r, minlength=A.n_rows), out=crow[1:])
    M = torch.sparse_csr_tensor(
        torch.from_numpy(crow).cuda(), torch.from_numpy(c[order]).cuda(),
        torch.from_numpy(A.val[keep][order]).float().cuda(),
        (A.n_rows, A.n_rows))
    return M, torch.from_numpy(perm.astype(np.int64)).cuda()


def phase_rankspace_vs_plain(torch, bt):
    """Kernel #8 against its plain version, bit for bit, on every level
    with groups of the SGS pair of band:8388608,2 under its mod-3
    colouring (f32, f64), each timed, and whole blocked_sgs applies on the
    card against the plain solve on the CPU; one whole L solve through
    torch.triangular_solve on the sparse colour-sorted triangle beside
    blocked_trisolve.  Returns the f32 record (ms: the mean level) and the
    host matrix."""
    import numpy as np
    from basic_iterative_solvers_tpu_torch.coloring import spec_colors_np
    from basic_iterative_solvers_tpu_torch.ops import block_trisolve as bk
    t0 = time.perf_counter()
    A = bt.generators.from_source(BAND)
    spec = bt.generators.color_spec_for_source(BAND)
    colors = spec_colors_np(spec, A.n_rows)
    D = A.diagonal()
    gen_s = time.perf_counter() - t0
    record = None
    for dt in (torch.float32, torch.float64):
        t0 = time.perf_counter()
        L, U = bk.build_best_trisolve_pair(A, D, D, colors, spec, dtype=dt,
                                           need_d=True, device="cuda")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        g = torch.Generator(device="cuda").manual_seed(8)
        Y = torch.randn((L.n_colors, L.M), dtype=dt, device="cuda",
                        generator=g)
        X = torch.randn((L.n_colors, L.M), dtype=dt, device="cuda",
                        generator=g)
        ms, scalar_ms, plain_ms, worst, works = [], [], [], 0.0, []
        for B in (L, U):
            for li, (c, groups) in enumerate(B.levels):
                if not groups:
                    continue
                label = (f"{BAND} {str(dt)[6:]} {'U' if B is U else 'L'} "
                         f"level {li} (colour {c}, {len(groups)} groups; "
                         f"host CSR {gen_s:.2f} s, pair {build_s:.2f} s)")
                # vec, but for float64 levels of more than two groups,
                # which the picker keeps on the scalar route
                route = ("vec" if dt == torch.float32 or len(groups) <= 2
                         else "scalar")
                if bk.rank_route_for(B, li, Y, X) != route:
                    raise RuntimeError(f"{label}: not on the {route} route")
                before = getattr(bk.rank_level, f"{route}_launches")
                e, _k, p = _kernel_vs_plain(
                    torch, "rankspace", label,
                    lambda v: bk.rank_level(B, li, Y, v.clone()),
                    lambda v: bk.rank_level_plain(B, li, Y, v.clone()),
                    bk.rank_level, X, plain_reps=6)
                xs = bk.rank_level(B, li, Y, X.clone(), route="scalar")
                xa = X.clone()                   # y aliasing x, in place
                bk.rank_level(B, li, xa, xa, route="vec")
                xb = X.clone()
                bk.rank_level(B, li, xb, xb, route="scalar")
                xv = bk.rank_level(B, li, Y, X.clone(), route="vec")
                if not (torch.equal(xs, xv) and torch.equal(xa, xb)
                        and getattr(bk.rank_level, f"{route}_launches")
                        > before):
                    raise RuntimeError(f"{label}: the vec and scalar routes "
                                       "differ")
                turns = _in_turns(torch, {
                    rt: (lambda rt=rt: bk.rank_level(B, li, Y, X, route=rt))
                    for rt in ("vec", "scalar")},
                    ("vec", "scalar", "scalar", "vec"))
                work = _rank_level_work(B, li, X.element_size())
                bound = _bound(*work)["bound_ms"]
                k = min(turns["vec"])
                print(f"[rankspace] {label}: route={route}; vec bit-equal "
                      f"to scalar (y apart and y = x); device ms in turns "
                      f"vec={turns['vec']} scalar={turns['scalar']} "
                      f"bound_ms={bound:.5f} ({100 * bound / k:.0f}% on vec)")
                worst = max(worst, e)
                ms, plain_ms = ms + [k], plain_ms + [p]
                scalar_ms.append(min(turns["scalar"]))
                works.append(work)
        y = torch.randn(A.n_rows, dtype=dt, device="cuda", generator=g)
        before = (bk.rank_level.launches, bk.rank_level.vec_launches)
        zk = bk.blocked_sgs(L, U, y)
        launches = bk.rank_level.launches - before[0]
        vec = bk.rank_level.vec_launches - before[1]
        Lc, Uc = (dataclasses.replace(B, vals=B.vals.cpu(), dinv=B.dinv.cpu(),
                                      d=None if B.d is None else B.d.cpu(),
                                      _tables={}) for B in (L, U))
        zp = bk.blocked_sgs(Lc, Uc, y.cpu()).cuda()
        def apply(rt):
            with _route_forced(bk, "rank_route_for", rt):
                return bk.blocked_sgs(L, U, y)
        zs = apply("scalar")
        apply_turns = _in_turns(torch, {rt: (lambda rt=rt: apply(rt))
                                        for rt in ("vec", "scalar")},
                                ("scalar", "vec", "vec", "scalar"))
        print(f"[rankspace] {BAND} {str(dt)[6:]} blocked_sgs ({launches} "
              f"level launches, {vec} on vec) against the CPU's plain "
              f"solve: bit_equal={torch.equal(zk, zp)} (scalar route "
              f"{torch.equal(zs, zp)}); device ms in turns (scalar, vec, "
              f"vec, scalar) vec={apply_turns['vec']} "
              f"scalar={apply_turns['scalar']}")
        if not (torch.equal(zk, zp) and torch.equal(zs, zp)) \
                or launches != 4 or vec != (4 if dt == torch.float32 else 2):
            raise RuntimeError(f"{BAND} {dt}: blocked_sgs disagrees or took "
                               f"{launches} level launches ({vec} vec), not "
                               "4")
        if dt == torch.float32:
            record = {"max_abs_err": worst, "ms": statistics.mean(ms),
                      "scalar_ms": statistics.mean(scalar_ms),
                      "plain_ms": statistics.mean(plain_ms),
                      **_mean_bound(works)}
            Mlib, perm = _band_lower_csr(torch, A, colors)
            ref = bk.blocked_trisolve(L, y)[perm]
            yp = y[perm].unsqueeze(1).contiguous()
            sol = torch.triangular_solve(yp, Mlib, upper=False).solution
            rel = float((sol[:, 0] - ref).abs().max() / ref.abs().max())
            lib_ms = _median_ms(
                lambda: torch.triangular_solve(yp, Mlib, upper=False),
                torch, reps=5, batch=2)
            own_ms = _median_ms(lambda: bk.blocked_trisolve(L, y), torch)
            # a level has no one-call library counterpart (as #9): the
            # whole L solve is printed beside blocked_trisolve instead
            record["library_ms"] = None
            print(f"[library] {BAND} f32 one whole L solve (nnz "
                  f"{Mlib.values().numel()}): torch.triangular_solve on the "
                  f"colour-sorted sparse CSR triangle ms={lib_ms:.4f} "
                  f"max_rel_err={rel:.3e}; blocked_trisolve (2 level "
                  f"launches, permutes) ms={own_ms:.4f}")
            if not rel <= TOL["float32"]:
                raise RuntimeError("the library's L solve disagrees")
            del Mlib
        del L, U, Lc, Uc, X, Y, y, zk, zp
        torch.cuda.empty_cache()
    return record, A


def _host_solve(torch, bt, A, device, dt, method, precond="NONE", **kw):
    """preprocessing(A) and solve on `device`, b = 2, x0 = 1, fused;
    returns (result, setup, set-up seconds)."""
    cfg = bt.SolverConfig(method=bt.SolverType[method],
                          preconditioner=bt.PrecondType[precond], dtype=dt,
                          harness="fused", **kw)
    n = A.n_rows
    t0 = time.perf_counter()
    setup = bt.preprocessing(
        A, cfg, b=torch.full((n,), 2.0, dtype=dt, device=device),
        x0=torch.full((n,), 1.0, dtype=dt, device=device), device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    return setup, time.perf_counter() - t0


def phase_cpu_vs_card_slice5(torch, bt):
    """f64 solves on the CPU and on the card at small sizes, one per new
    path: DIA CG on HPCG 32^3 (device builder), lane-ELL CG on
    sband:20000,8,400, rank-space BiCGSTAB + SGS on band:30000,2: the
    same iteration counts, histories as _check_history says."""
    cases = [("DIA CG", "hpcg:32x32x32", None),
             ("lane-ELL CG", "sband:20000,8,400",
              dict(method="CONJUGATE_GRADIENT", matrix_format="lane_ell")),
             ("rank-space BiCGSTAB + SGS", "band:30000,2",
              dict(method="BICGSTAB", precond="SYMMETRIC_GAUSS_SEIDEL",
                   gs_mode="colored"))]
    for label, spec, kw in cases:
        res = {}
        for dev in ("cpu", "cuda"):
            if kw is None:
                A = bt.dia.from_source_device(spec, torch.float64,
                                              device=dev)
                n = A.n_rows
                res[dev] = bt.solve(bt.preprocessing_device(
                    A, bt.SolverConfig(dtype=torch.float64, harness="fused",
                                       tolerance=1e-10),
                    b=torch.full((n,), 2.0, dtype=torch.float64, device=dev),
                    x0=torch.full((n,), 1.0, dtype=torch.float64,
                                  device=dev)))
                continue
            k = dict(kw)
            if k.get("gs_mode") == "colored":
                k["color_spec"] = bt.generators.color_spec_for_source(spec)
            setup, _s = _host_solve(torch, bt, bt.generators.from_source(spec),
                                    dev, torch.float64, tolerance=1e-10,
                                    **k)
            res[dev] = bt.solve(setup)
        c, g = res["cpu"], res["cuda"]
        print(f"[cpu-vs-card-slice5] {spec} f64 {label}: iters "
              f"cpu={c.iter_count} card={g.iter_count} final "
              f"cpu={c.final_residual_norm:.6e} "
              f"card={g.final_residual_norm:.6e}")
        if c.iter_count != g.iter_count or not (c.converged and g.converged):
            raise RuntimeError(f"{label}: CPU and card solves differ")
        _check_history(g, c)


def _timed_row(torch, bt, tag, label, setup, setup_s, expect):
    """Warm-up solve, every counter to 0, the timed solve, the counters
    read; prints the row and checks `expect(res, counts)`.  Returns the
    counts."""
    from basic_iterative_solvers_tpu_torch.solvers import make_method
    import math
    solver = make_method(setup)
    bt.solve(setup, method=solver)                    # warm-up solve
    _sparse_counters(bt, reset=True)
    res = bt.solve(setup, method=solver)
    counts = _sparse_counters(bt)
    ms = 1e3 * res.solve_seconds / max(1, res.iter_count)
    per_iter = {k: round(v / max(1, res.iter_count), 3)
                for k, v in counts.items() if v}
    print(f"[{tag}] {label}: iters={res.iter_count} ms/iter={ms:.5f} "
          f"setup_s={setup_s:.3f} host={_host_branch(bt)} "
          f"r0={res.residual_norms[0]:.6e} "
          f"final_explicit_f64={res.final_residual_norm:.6e} "
          f"launches={counts} launches/iter={per_iter}")
    if not (math.isfinite(res.final_residual_norm)
            and bool(torch.isfinite(res.x_star).all())
            and expect(res, counts)):
        raise RuntimeError(f"{tag} {label} failed its checks")
    return counts


def phase_slice5_path(torch, bt, sband, band):
    """The slice's paths on the card, f32, fused harness, tolerance 0,
    b = 2, x0 = 1, each after a warm-up solve with every counter set to 0
    just before the timed solve and read just after:
      DIA CG on HPCG 128^3 (2500 iterations) and 384^3 (150), built on the
      card (dia.from_source_device → preprocessing_device);
      cg@sband: preprocessing(matrix_format="lane_ell"), 400 iterations,
      then the gather ELL ("ell"), 40;
      pbicgstab@band: BiCGSTAB + SGS, gs_mode="colored", the band's mod-3
      colour spec (preprocessing → build_best_trisolve_pair), 800;
    then natural-order f64 CG + SGS and CG + ILU(0) on fdm:256 to 1e-8 on
    the CPU and on the card, equal iteration counts.  Returns the launches
    of each kernel in its row."""
    P = bt.PrecondType
    launches = {}
    for spec, iters in ((MAIN_SPEC, 2500), (DIA_384, 150)):
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        A = bt.dia.from_source_device(spec, torch.float32, device="cuda")
        n = A.n_rows
        setup = bt.preprocessing_device(
            A, bt.SolverConfig(dtype=torch.float32, harness="fused",
                               tolerance=0.0, max_iters=iters,
                               breakdown_stall=True),
            b=torch.full((n,), 2.0, device="cuda"),
            x0=torch.full((n,), 1.0, device="cuda"))
        torch.cuda.synchronize()
        counts = _timed_row(
            torch, bt, "slice5", f"{spec} f32 DIA CG fused", setup,
            time.perf_counter() - t0,
            lambda r, c: (r.iter_count == iters and c["dia_spmv"] >= iters
                          and c["stencil_spmv"] == 0))
        if spec == MAIN_SPEC:
            launches["dia_spmv"] = counts["dia_spmv"]
        del A, setup
    for fmt, iters in (("lane_ell", 400), ("ell", 40)):
        setup, setup_s = _host_solve(
            torch, bt, sband, "cuda", torch.float32, "CONJUGATE_GRADIENT",
            matrix_format=fmt, tolerance=0.0, max_iters=iters,
            breakdown_stall=True)
        kind = type(setup.A).__name__
        counts = _timed_row(
            torch, bt, "slice5", f"{SBAND} f32 cg@sband {fmt} ({kind})",
            setup, setup_s,
            lambda r, c: (r.iter_count == iters and (
                c["lane_ell_spmv"] >= iters
                and c["lane_ell_spmv_idx16"] == c["lane_ell_spmv"]
                if fmt == "lane_ell" else c["lane_ell_spmv"] == 0)))
        if fmt == "lane_ell":
            launches["lane_ell_spmv"] = counts["lane_ell_spmv"]
            launches["lane_ell_spmv_by_route"] = {
                rt: counts[f"lane_ell_spmv_{rt}"] for rt in ("idx16",
                                                             "idx32")}
        del setup
    setup, setup_s = _host_solve(
        torch, bt, band, "cuda", torch.float32, "BICGSTAB",
        "SYMMETRIC_GAUSS_SEIDEL", gs_mode="colored",
        color_spec=bt.generators.color_spec_for_source(BAND), tolerance=0.0,
        max_iters=800, breakdown_stall=True)
    if type(setup.M.L_block).__name__ != "BlockedTriSolve":
        raise RuntimeError("pbicgstab@band did not take the rank-space "
                           "route")
    counts = _timed_row(
        torch, bt, "slice5", f"{BAND} f32 pbicgstab@band (rank-space SGS, "
        f"{type(setup.A).__name__})", setup, setup_s,
        lambda r, c: (r.iter_count == 800
                      and c["rank_level"] == 4 * (2 * 800 + 1)
                      and c["rank_level_vec"] == c["rank_level"]
                      and c["dia_spmv"] >= 2 * 800))
    launches["rank_level"] = counts["rank_level"]
    launches["rank_level_by_route"] = {
        rt: counts[f"rank_level_{rt}"] for rt in ("vec", "scalar")}
    # the row again with #8 on each route forced, in turns (the main path
    # above took vec): scalar, scalar, vec
    from basic_iterative_solvers_tpu_torch.ops import block_trisolve as bk
    from basic_iterative_solvers_tpu_torch.solvers import make_method
    solver = make_method(setup)
    turns = {"vec": [], "scalar": []}
    for rt in ("scalar", "scalar", "vec"):
        with _route_forced(bk, "rank_route_for", rt):
            _sparse_counters(bt, reset=True)
            res = bt.solve(setup, method=solver)
        c = _sparse_counters(bt)
        turns[rt].append(1e3 * res.solve_seconds / max(1, res.iter_count))
        if not (res.iter_count == 800
                and c[f"rank_level_{rt}"] == c["rank_level"] == 6404):
            raise RuntimeError(f"pbicgstab@band on the {rt} route failed "
                               "its checks")
    print(f"[slice5] {BAND} f32 pbicgstab@band ms/iter in turns (the main "
          f"path's vec, scalar, scalar, vec): vec={turns['vec']} "
          f"scalar={turns['scalar']}")
    del setup, solver
    torch.cuda.empty_cache()

    A = bt.generators.from_source("fdm:256")
    for precond in ("SYMMETRIC_GAUSS_SEIDEL", "ILU0"):
        res = {}
        for dev in ("cpu", "cuda"):
            setup, setup_s = _host_solve(torch, bt, A, dev, torch.float64,
                                         "CONJUGATE_GRADIENT", precond,
                                         tolerance=1e-8, max_iters=2000)
            res[dev] = (bt.solve(setup), setup_s, setup.M.L_solve.n_levels)
        (c, cs, lv), (g, gs, _lv) = res["cpu"], res["cuda"]
        r0 = g.residual_norms[0]
        print(f"[slice5] fdm:256 f64 CG + {P[precond].value} natural order "
              f"({lv} levels per triangular solve) to tol 1e-8: iters "
              f"cpu={c.iter_count} card={g.iter_count} "
              f"final_explicit/r0 card={g.final_residual_norm / r0:.3e} "
              f"ms/iter cpu={1e3 * c.solve_seconds / c.iter_count:.3f} "
              f"card={1e3 * g.solve_seconds / g.iter_count:.3f} setup_s "
              f"cpu={cs:.2f} card={gs:.2f} host={_host_branch(bt)}")
        if (c.iter_count != g.iter_count
                or not (c.converged and g.converged)
                or g.final_residual_norm > 10 * 1e-8 * r0):
            raise RuntimeError(f"fdm:256 CG + {precond}: CPU and card "
                               "differ or did not converge")
        _check_history(g, c)
    return launches


# ---------------------------------------------------------------------------
# Slice 5b: superblock solves built from host CSR (plane mode, const mode
# with a per-row D), the one-launch const solve
# ---------------------------------------------------------------------------

FDM_5B = "fdm:2048"
ANDERSON_128 = KERNEL_SPECS[2]


def _colored_host_setup(torch, bt, spec, dt, method, precond, device="cuda",
                        stencil=False, **kw):
    """The coloured host-CSR route under the source's grid colour spec
    (gs_mode "colored"), b = 2, x0 = 1, fused harness: the host CSR of
    `spec` through preprocessing, with the stencil injected as the solve
    operator (`stencil`, the JAX bench's fallback, bench.py:227-259) or the
    operator from the CSR (the JAX CLI's host route, cli.py:290-309).
    Returns (setup, generator seconds, preprocessing seconds)."""
    t0 = time.perf_counter()
    A = bt.generators.from_source(spec)
    gen_s = time.perf_counter() - t0
    A_dev = (bt.stencil_op.from_source_operator(spec, dt, device=device)
             if stencil else None)
    cfg = bt.SolverConfig(
        method=bt.SolverType[method], preconditioner=bt.PrecondType[precond],
        dtype=dt, harness="fused", gs_mode="colored",
        color_spec=bt.generators.color_spec_for_source(spec), **kw)
    n = A.n_rows
    t0 = time.perf_counter()
    setup = bt.preprocessing(
        A, cfg, b=torch.full((n,), 2.0, dtype=dt, device=device),
        x0=torch.full((n,), 1.0, dtype=dt, device=device), A_dev=A_dev,
        device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    return setup, gen_s, time.perf_counter() - t0


def _mode(B):
    """A superblock solve's mode as the [slice5b] lines print it."""
    if B.is_table:
        return "table"
    if B.is_plane:
        return "plane"
    return "const, per-row D" if B.dinv_rows is not None else "const"


def _widen(B, torch):
    """The same solve at float64: its planes and diagonal widened (their
    values exact), so the f64 kernel runs on the f32 pair's structure."""
    import dataclasses
    f64 = lambda t: None if t is None else t.double()  # noqa: E731
    return dataclasses.replace(
        B, dtype=torch.float64,
        vals_cross=None if B.vals_cross is None else tuple(
            f64(v) for v in B.vals_cross),
        vals_self=None if B.vals_self is None else tuple(
            f64(v) for v in B.vals_self),
        dinv_rows=f64(B.dinv_rows), d_rows=f64(B.d_rows), _args={})


def _as_planes(B, torch):
    """B in plane mode on the split route: the planes a const-mode level
    stands for (coeff × leg mask, what the builder tested them against),
    as BIS_SB_ALIGNED=0 builds the pair for 128 % nx != 0, where no const
    detection runs."""
    import dataclasses
    import numpy as np
    from basic_iterative_solvers_tpu_torch.ops import block_trisolve as bk
    if B.is_plane:
        return dataclasses.replace(B, fused=False, _args={})
    np_dt = bk._np_dtype(B.dtype)
    dev = B.dinv_rows.device
    vc, vs = [], []
    for li, (sb, cross, selfs) in enumerate(B.levels):
        c_planes = [c * bk._leg_mask_np(sb, (dx, dy, dz), B.spec_params, B.m)
                    for c, dx, dy, dz in B.const_cross[li]]
        s_planes = [c * bk._leg_mask_np(sb, (dx, 0, 0), B.spec_params, B.m,
                                        self_upper=B.upper)
                    for c, dx in B.const_self[li]]
        vc.append(torch.from_numpy(np.array(c_planes, dtype=np_dt)).to(dev)
                  if cross else None)
        vs.append(torch.from_numpy(np.array(s_planes, dtype=np_dt)).to(dev)
                  if selfs else None)
    return dataclasses.replace(B, const_cross=(), const_self=(),
                               vals_cross=tuple(vc), vals_self=tuple(vs),
                               fused=False, _args={})


def _plane_level_work(B, li, itemsize, part="level"):
    """(bytes, operations) of one level of a pair built from host CSR:
    each plane value the part reads, y or acc on the level's rows, each
    source superblock's x once, the per-row 1/D, x written once; a product
    and a difference per plane value (const mode: per in-grid leg, no
    planes) and the pivot multiply.  `part` "acc" is the split route's
    acc step (cross planes); "parity" one parity step (1/sx of the rows,
    their self planes, and x on the level's other parities)."""
    nx, ny, nz, sx, sy, sz = B.spec_params
    sb, cross, selfs = B.levels[li]
    m = B.m
    n_src = len({src for src, _d in cross})
    if B.is_plane:
        planes_c, planes_s = len(cross) * m, len(selfs) * m
        terms_c, terms_s = planes_c, planes_s
    else:
        py, pz = sb % sy, sb // sy
        planes_c = planes_s = 0
        terms_c = sum((nx - abs(dx)) * _axis_count(ny, sy, py, dy)
                      * _axis_count(nz, sz, pz, dz)
                      for _c, dx, dy, dz in B.const_cross[li])
        terms_s = (m // nx) * sum(
            1 for _c, dx in B.const_self[li] for x in range(nx)
            if 0 <= x + dx < nx and ((x + dx) % sx > x % sx if B.upper
                                     else (x + dx) % sx < x % sx))
    if part == "acc":
        return itemsize * (planes_c + m * (2 + n_src)), 2 * terms_c
    if part == "parity":
        rows = m // sx
        return (itemsize * (planes_s // sx + 3 * rows
                            + (m - rows if selfs else 0)),
                2 * terms_s // sx + rows)
    return (itemsize * (planes_c + planes_s + m * (3 + n_src)),
            2 * (terms_c + terms_s) + m)


def _plane_lower_csr(torch, bk, L):
    """L (unit diagonal, strict part from its planes) in the colour-sorted
    ordering as a torch.sparse_csr_tensor on the card, and the permutation
    (new → old)."""
    n = L.n_rows
    i, _coords, _color, perm, inv = _colour_order(torch, L)
    r_all, c_all, v_all = [inv], [inv], [1.0 / L.dinv_rows]
    for li, (sb, cross, selfs) in enumerate(L.levels):
        rows = bk._slots(L, i, sb).reshape(-1)
        for g, (src, delta) in enumerate(cross):
            src_rows = bk._slots(L, i, src).reshape(-1)
            t = torch.arange(L.m, device="cuda")
            ok = (t + delta >= 0) & (t + delta < L.m)
            v = L.vals_cross[li][g]
            ok &= v != 0
            r_all.append(inv[rows[ok]])
            c_all.append(inv[src_rows[(t + delta)[ok]]])
            v_all.append(v[ok])
        for g, dx in enumerate(selfs):
            v = L.vals_self[li][g]
            ok = v != 0
            r_all.append(inv[rows[ok]])
            c_all.append(inv[rows[ok] + dx])
            v_all.append(v[ok])
    return _sorted_csr(torch, r_all, c_all, v_all, n), perm


def phase_slice5b_build(torch, bt):
    """The fdm:2048 CG + ILU(0) pair on the coloured host route, built once:
    f32, 1200 iterations, tolerance 0, peak memory from here.  Returns
    (setup, generator seconds, set-up seconds)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    setup, gen_s, setup_s = _colored_host_setup(
        torch, bt, FDM_5B, torch.float32, "CONJUGATE_GRADIENT", "ILU0",
        max_iters=1200, tolerance=0.0, breakdown_stall=True)
    L, U = setup.M.L_block, setup.M.U_block
    print(f"[slice5b] {FDM_5B} f32 CG + ILU(0) pair from host CSR: L "
          f"{_mode(L)}, U {_mode(U)}, {L.S} levels a triangle, "
          f"{type(setup.A).__name__} operator; host CSR {gen_s:.3f} s, "
          f"preprocessing {setup_s:.3f} s, host={_host_branch(bt)}")
    if not (L.is_plane and type(L).__name__ == "SuperBlockTriSolve"):
        raise RuntimeError(f"{FDM_5B} ILU(0) did not build a plane pair")
    return setup, gen_s, setup_s


def phase_plane_level_vs_plain(torch, bt, setup):
    """K1 (plane mode of #9) and the per-row D of const mode against their
    plain versions on every level of the fdm:2048 ILU(0) pair's L and U, f32
    and (the pair widened) f64, bit for bit on the line and the direct
    route, each level timed on both in turns beside its bound; whole
    applies on both routes in turns; the Anderson 128^3 SGS pair's levels
    the same way (_anderson_levels); the split
    route (the pair in plane form, as BIS_SB_ALIGNED=0 builds it):
    super_acc and super_parity against plain on every level, and whole
    applies fused and split in turns; one whole L solve through
    torch.triangular_solve; the cross-check of the plane pair of
    hpcg:32x32x32 from CSR against its factor-table pair, f64.  Returns the
    plane record and the split route's."""
    from basic_iterative_solvers_tpu_torch.ops import block_trisolve as bk
    L32, U32 = setup.M.L_block, setup.M.U_block
    n = L32.n_rows
    record = None
    for dt in (torch.float32, torch.float64):
        L, U = (L32, U32) if dt == torch.float32 else (
            _widen(L32, torch), _widen(U32, torch))
        g = torch.Generator(device="cuda").manual_seed(11)
        y = torch.randn(n, dtype=dt, device="cuda", generator=g)
        x = torch.randn(n, dtype=dt, device="cuda", generator=g)
        label = f"{FDM_5B} {str(dt)[6:]}"
        res, by = {}, {}
        for B in (L, U):
            by[B.upper] = []
            res[B.upper] = _check_levels(torch, bk, label, B, y, x,
                                         range(len(B.levels)),
                                         tag="plane-level",
                                         by_level=by[B.upper])
        zk = bk.blocked_ilu0(L, U, y)
        zp = _plain_ilu0(bk, L, U, y)
        zd = _direct(bk.blocked_ilu0, L, U, y)
        torch.cuda.synchronize()
        apply_ms = _in_turns(torch, {
            "line": lambda: bk.blocked_ilu0(L, U, y),
            "direct": lambda: _direct(bk.blocked_ilu0, L, U, y)},
            ("direct", "line", "line", "direct"))
        works = [_plane_level_work(B, li, x.element_size()) for B in (L, U)
                 for li in range(len(B.levels))]
        bound = _bound(sum(b for b, _o in works), sum(o for _b, o in works))
        print(f"[plane-level] {label} blocked_ilu0 (2x{L.S} levels) against "
              f"the plain levels: bit_equal={torch.equal(zk, zp)} (direct "
              f"route {torch.equal(zd, zk)}) device ms in turns {apply_ms} "
              f"bound_ms={bound['bound_ms']:.4f} ({bound['bound_by']}, at "
              f"the float32 rate)")
        if not (torch.equal(zk, zp) and torch.equal(zd, zk)):
            raise RuntimeError(f"{label}: whole ILU(0) apply disagrees")
        if dt == torch.float32:
            ms, plain_ms, worst = res[False]

            def means(rows):
                return {k: statistics.mean(t[j] for t in rows)
                        for j, k in enumerate(("ms", "direct_ms",
                                               "bound_ms"))}

            record = {"max_abs_err": worst, "ms": statistics.mean(ms),
                      "direct_ms": means(by[False])["direct_ms"],
                      "plain_ms": statistics.mean(plain_ms),
                      "library_ms": None,
                      **_mean_bound([_plane_level_work(L, li, 4)
                                     for li in range(len(L.levels))]),
                      "by_mode": {
                          "plane, fdm:2048 L": means(by[False]),
                          "const per-row D, fdm:2048 U": means(by[True]),
                          "apply, fdm:2048": {
                              "ms": min(apply_ms["line"]),
                              "direct_ms": min(apply_ms["direct"]),
                              "bound_ms": bound["bound_ms"]}}}
        del zk, zp, zd, x, y
    record["by_mode"]["const per-row D, Anderson 128^3"] = _anderson_levels(
        torch, bt, bk)
    split_records, applies = _plane_split(torch, bk, L32, U32)
    whole = dict(applies[f"{FDM_5B} float32"])
    M, perm = _plane_lower_csr(torch, bk, L32)
    y = torch.randn(n, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(12))
    ref = bk.blocked_trisolve(L32, y)[perm]
    yp = y[perm].unsqueeze(1).contiguous()
    sol = torch.triangular_solve(yp, M, upper=False).solution
    rel = float((sol[:, 0] - ref).abs().max() / ref.abs().max())
    lib_ms = _median_ms(lambda: torch.triangular_solve(yp, M, upper=False),
                        torch, reps=5, batch=2)
    own_ms = _median_ms(lambda: bk.blocked_trisolve(L32, y), torch)
    print(f"[library] {FDM_5B} f32 one whole L solve (nnz "
          f"{M.values().numel()}): torch.triangular_solve on the "
          f"colour-sorted sparse CSR triangle ms={lib_ms:.4f} "
          f"max_rel_err={rel:.3e}; blocked_trisolve ({L32.S} plane level "
          f"launches) ms={own_ms:.4f}")
    if not rel <= TOL["float32"]:
        raise RuntimeError("the library's L solve disagrees")
    del M, sol, yp
    torch.cuda.empty_cache()
    _plane_vs_table(torch, bt, bk)
    whole.update(library_ms=lib_ms, blocked_trisolve_ms=own_ms)
    return record, split_records, whole


def _anderson_levels(torch, bt, bk):
    """[plane-level] on the pbicgstab@anderson128 SGS pair from host CSR
    (const mode with a per-row D): every level of L and U bit-equal to
    plain on both routes, f32 (timed in turns) and widened to f64.
    Returns the f32 means (ms, direct_ms, bound_ms)."""
    st, gen_s, setup_s = _colored_host_setup(
        torch, bt, ANDERSON_128, torch.float32, "BICGSTAB",
        "SYMMETRIC_GAUSS_SEIDEL", stencil=True)
    L32, U32 = st.M.L_block, st.M.U_block
    if not (L32.is_const and L32.dinv_rows is not None):
        raise RuntimeError("the Anderson pair is not const with a per-row D")
    out = None
    for dt in (torch.float32, torch.float64):
        L, U = (L32, U32) if dt == torch.float32 else (
            _widen(L32, torch), _widen(U32, torch))
        g = torch.Generator(device="cuda").manual_seed(15)
        y = torch.randn(L.n_rows, dtype=dt, device="cuda", generator=g)
        x = torch.randn(L.n_rows, dtype=dt, device="cuda", generator=g)
        by = []
        for B in (L, U):
            _check_levels(torch, bk, f"{ANDERSON_128} {str(dt)[6:]}", B, y,
                          x, range(len(B.levels)), timed=dt == torch.float32,
                          tag="plane-level", by_level=by)
        if dt == torch.float32:
            out = {k: statistics.mean(t[j] for t in by)
                   for j, k in enumerate(("ms", "direct_ms", "bound_ms"))}
    print(f"[plane-level] {ANDERSON_128} (host CSR {gen_s:.2f} s, "
          f"preprocessing {setup_s:.2f} s) f32 means over the levels: {out}")
    del st, L32, U32
    torch.cuda.empty_cache()
    return out


def _plane_split(torch, bk, L32, U32):
    """The split route's kernels in plane mode against plain on every level
    of the pair in plane form, f32 and widened to f64, bit for bit on the
    line and the direct route, each step timed in turns beside its bounds
    (_split_steps); then whole applies: the fused pair and the split pair
    on both routes, in turns, bit-equal.  Returns the #10 and #11 plane
    records ({dtype label: record}) and the f32 applies' times."""
    n = L32.n_rows
    work = lambda B, li, item, part, p=None: _plane_level_work(  # noqa: E731
        B, li, item, part)
    records, applies = {}, {}
    for dt in (torch.float32, torch.float64):
        L, U = (L32, U32) if dt == torch.float32 else (
            _widen(L32, torch), _widen(U32, torch))
        Ls, Us = _as_planes(L, torch), _as_planes(U, torch)
        g = torch.Generator(device="cuda").manual_seed(13)
        y = torch.randn(n, dtype=dt, device="cuda", generator=g)
        x = torch.randn(n, dtype=dt, device="cuda", generator=g)
        label = f"{FDM_5B} {str(dt)[6:]}"
        steps = {}
        for B in (Ls, Us):
            for step, res in _split_steps(torch, bk, "plane-split", label, B,
                                          y, x, work).items():
                for k, v in res.items():
                    steps.setdefault(step, {}).setdefault(k, []).extend(v)
        applies[label] = _split_applies(torch, bk, "plane-split", label,
                                        (L, U), (Ls, Us), y)
        records[label] = {name: _split_record(steps, step) for name, step in
                          (("super_acc", "acc"), ("super_parity", "par"))}
        print(f"[plane-split] {label} plane mode, means over the levels: "
              + "; ".join(f"{name} " + " ".join(
                  f"{k}={v:.5f}" for k, v in r.items()
                  if isinstance(v, float))
                  for name, r in records[label].items()))
        _release(torch, Ls, Us)
        del Ls, Us, B, x, y
    return records, applies


#: the plane pair of hpcg:32x32x32 from CSR against its factor-table
#: pair, f64: both are exact coloured ILU(0), factored by the same NumPy
#: IKJ loop (the table from an 18^3 prototype): max|Δz| / max|z| bound
PLANE_TABLE_TOL = 1e-12


def _plane_vs_table(torch, bt, bk):
    spec = "hpcg:32x32x32"
    t0 = time.perf_counter()
    setup, gen_s, setup_s = _colored_host_setup(
        torch, bt, spec, torch.float64, "CONJUGATE_GRADIENT", "ILU0")
    Lp, Up = setup.M.L_block, setup.M.U_block
    A = bt.stencil_op.from_source_operator(spec, torch.float64, device="cuda")
    from basic_iterative_solvers_tpu_torch.coloring import spec_for_device
    Lt, Ut = bk.build_superblock_ilu0_pair_stencil(A, spec_for_device(A),
                                                   dtype=torch.float64)
    y = torch.randn(A.n_rows, dtype=torch.float64, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(14))
    zp, zt = bk.blocked_ilu0(Lp, Up, y), bk.blocked_ilu0(Lt, Ut, y)
    rel = float((zp - zt).abs().max() / zt.abs().max())
    print(f"[plane-level] {spec} f64 plane pair from host CSR (L {_mode(Lp)}, "
          f"U {_mode(Up)}; host CSR {gen_s:.2f} s, preprocessing "
          f"{setup_s:.2f} s) against the factor-table pair: "
          f"max_rel_err={rel:.3e} (bound {PLANE_TABLE_TOL:.0e}), "
          f"{time.perf_counter() - t0:.2f} s")
    if not (Lp.is_plane and rel <= PLANE_TABLE_TOL):
        raise RuntimeError(f"{spec}: the plane pair disagrees with the "
                           "factor-table pair")


def _mega_on(bk, B, route, y, x):
    """super_solve_mega of B on `route`, forced through the route cache
    (mega_route_for's key), the picked route restored after."""
    key = ("mega_route", x.element_size(), x.device.index)
    picked = bk.mega_route_for(B, x.element_size(), x.device)
    B._args[key] = route
    try:
        return bk.super_solve_mega(B, y, x)
    finally:
        B._args[key] = picked


def _mega_counts(bk):
    m = bk.super_solve_mega
    return m.launches, m.brick_launches, m.direct_launches


def _mega_solve(torch, bk, label, B, y, timed=True):
    """#12 on one solve B: the brick route (the picker's, checked) and the
    direct route forced, apart and in place, against the per-level route
    and the plain loop, bit for bit, each launch counted once in
    `.launches` and in its route's count; with `timed`, the direct route
    re-timed alone by device time, then the brick, direct and per-level
    routes and the brick launch with no rows (the barrier floor) in turns
    (direct, brick, level, floor, floor, level, brick, direct), and the
    brick route in place, beside the per-level byte bound, the on-chip
    solve bound (y read and x written once) and the floor.  Returns the
    record: each route's best device ms, the bounds, the brick grid."""
    item = y.element_size()
    route = bk.mega_route_for(B, item, y.device)
    if route != "brick":
        raise RuntimeError(f"{label}: the picker names {route!r}, not the "
                           "brick route")

    def per_level(yy, xx):
        for li in range(len(B.levels)):
            bk.super_level(B, li, yy, xx)
        return xx

    outs, grew = {}, {}
    for rt in ("brick", "direct"):
        before = _mega_counts(bk)
        outs[rt] = _mega_on(bk, B, rt, y, torch.empty_like(y))
        inplace = y.clone()
        _mega_on(bk, B, rt, inplace, inplace)
        torch.cuda.synchronize()
        outs[rt + " in place"] = inplace
        grew[rt] = tuple(a - b for a, b in zip(_mega_counts(bk), before))
    if grew != {"brick": (2, 2, 0), "direct": (2, 0, 2)}:
        raise RuntimeError(f"{label}: the route counts grew by {grew}")
    xl = per_level(y, torch.empty_like(y))
    tl = y.clone()
    per_level(tl, tl)
    xp = bk.super_solve_mega_plain(B, y, torch.empty_like(y))
    torch.cuda.synchronize()
    equal = {"plain": torch.equal(outs["brick"], xp),
             "direct": torch.equal(outs["brick"], outs["direct"]),
             "per_level": torch.equal(outs["brick"], xl),
             "in_place": all(torch.equal(outs[k], xl) for k in
                             ("brick in place", "direct in place"))
             and torch.equal(tl, xl)}
    shape = B._args[("brick_shape", item, y.device.index)]
    work = _plane_level_work if B.dinv_rows is not None else _level_work
    works = [work(B, li, item) for li in range(len(B.levels))]
    level_bound = _bound(sum(b for b, _o in works), sum(o for _b, o in works))
    # the whole solve with its state on chip: y (and a per-row 1/D) read
    # once, x written once
    solve_bytes = B.n_rows * item * (3 if B.dinv_rows is not None else 2)
    solve_bound = _bound(solve_bytes, sum(o for _b, o in works))
    rec = {"max_abs_err": float((outs["brick"] - xp).abs().max()),
           "bound_ms": solve_bound["bound_ms"],
           "bound_by": solve_bound["bound_by"],
           "level_bound_ms": level_bound["bound_ms"],
           "grid": bk.mega_grid(B, y.device), "brick": shape}
    line = (f"[mega] {label} {'U' if B.upper else 'L'} solve ({len(B.levels)} "
            f"const levels, {[len(lv[1]) for lv in B.levels]} cross legs; "
            f"brick {shape[0]}x{shape[1]} lines, block {shape[2]}x{shape[3]}"
            f", grid {rec['grid']} bricks): bit_equal={equal}")
    if timed:
        out = torch.empty_like(y)
        rec["direct_first_ms"] = _device_ms(
            lambda: _mega_on(bk, B, "direct", y, out), torch)
        turns = _in_turns(torch, {
            "brick": lambda: _mega_on(bk, B, "brick", y, out),
            "direct": lambda: _mega_on(bk, B, "direct", y, out),
            "level": lambda: per_level(y, out),
            "floor": lambda: bk.brick_barrier_floor(B, y, out)},
            ("direct", "brick", "level", "floor", "floor", "level", "brick",
             "direct"))
        inplace = y.clone()
        rec["in_place_ms"] = _device_ms(
            lambda: _mega_on(bk, B, "brick", inplace, inplace), torch)
        rec.update(ms=min(turns["brick"]), direct_ms=min(turns["direct"]),
                   per_level_ms=min(turns["level"]),
                   floor_ms=min(turns["floor"]))
        line += (f" device ms: direct re-timed alone "
                 f"{rec['direct_first_ms']:.5f}; in turns brick="
                 f"{turns['brick']} direct={turns['direct']} per_level="
                 f"{turns['level']} floor={turns['floor']}; brick in place "
                 f"{rec['in_place_ms']:.5f}; brick/per_level="
                 f"{rec['ms'] / rec['per_level_ms']:.3f}; bounds: per-level "
                 f"{level_bound['bound_ms']:.5f}, on-chip solve "
                 f"{solve_bound['bound_ms']:.5f} ({solve_bound['bound_by']})"
                 f", barrier floor {rec['floor_ms']:.5f}")
    print(line)
    if not all(equal.values()):
        raise RuntimeError(f"{label}: the one-launch routes disagree: "
                           f"{equal}")
    return rec


def phase_mega_vs_per_level(torch, bt, setup5b):
    """#12 (the one-launch const solve) on its brick route (the picker's)
    and its direct route against the per-level route and the plain
    per-level loop, bit for bit (_mega_solve): the const SGS pair of HPCG
    128^3, L, U and U in place, f32 and f64, each route timed by device
    time in turns beside the per-level byte bound, the on-chip solve bound
    and the barrier floor; the f32 L solve through torch.triangular_solve
    on the colour-sorted sparse triangle, the library's nearest call; the
    Anderson 128^3 SGS pair from host CSR (const, per-row D) and the
    fdm:2048 ILU(0) pair's U (const, per-row D) in f32 the same way (in
    float64 fdm:2048's x exceeds the card's shared memory: the picker
    names the direct route).  Returns the f32 record (ms: one whole L
    solve on the brick route)."""
    from basic_iterative_solvers_tpu_torch.coloring import spec_for_device
    from basic_iterative_solvers_tpu_torch.ops import block_trisolve as bk
    record, by_mode = None, {}
    for dt in (torch.float32, torch.float64):
        A = bt.stencil_op.from_source_operator(MAIN_SPEC, dt, device="cuda")
        L, U = bk.build_superblock_gs_pair_stencil(A, spec_for_device(A),
                                                   dtype=dt, need_d=True)
        g = torch.Generator(device="cuda").manual_seed(15)
        y = torch.randn(A.n_rows, dtype=dt, device="cuda", generator=g)
        label = f"{MAIN_SPEC} {str(dt)[6:]}"
        for B in (L, U):
            rec = _mega_solve(torch, bk, label, B, y)
            by_mode[f"{label} {'U' if B.upper else 'L'}"] = {
                k: rec[k] for k in ("ms", "direct_ms", "per_level_ms",
                                    "in_place_ms", "floor_ms", "bound_ms",
                                    "level_bound_ms")}
            if dt == torch.float32 and not B.upper:
                xk = bk.super_solve_mega(B, y, torch.empty_like(y))
                M, perm = _const_lower_csr(torch, A, B)
                yp = y[perm].unsqueeze(1).contiguous()
                sol = torch.triangular_solve(yp, M, upper=False).solution
                ref = xk[perm]
                rel = float((sol[:, 0] - ref).abs().max() / ref.abs().max())
                lib_ms = _median_ms(
                    lambda: torch.triangular_solve(yp, M, upper=False),
                    torch, reps=5, batch=2)
                print(f"[library] {label} one whole const L solve (nnz "
                      f"{M.values().numel()}): torch.triangular_solve on "
                      f"the colour-sorted sparse CSR triangle "
                      f"ms={lib_ms:.4f} max_rel_err={rel:.3e} against the "
                      f"one-launch solve")
                if not rel <= TOL["float32"]:
                    raise RuntimeError("the library's const L solve "
                                       "disagrees")
                out = torch.empty_like(y)
                plain_ms = _median_ms(
                    lambda: bk.super_solve_mega_plain(B, y, out), torch,
                    reps=5, batch=2)
                del M, yp, sol, ref, xk
                record = {**rec, "plain_ms": plain_ms, "library_ms": lib_ms}
        del A, L, U, y
        torch.cuda.empty_cache()
    st, gen_s, setup_s = _colored_host_setup(
        torch, bt, ANDERSON_128, torch.float32, "BICGSTAB",
        "SYMMETRIC_GAUSS_SEIDEL", stencil=True)
    g = torch.Generator(device="cuda").manual_seed(16)
    y = torch.randn(st.M.L_block.n_rows, device="cuda", generator=g)
    for B in (st.M.L_block, st.M.U_block):
        if not (B.is_const and B.dinv_rows is not None):
            raise RuntimeError("the Anderson pair is not const with a "
                               "per-row D")
        rec = _mega_solve(torch, bk, f"{ANDERSON_128} f32 (host CSR "
                          f"{gen_s:.2f} s, preprocessing {setup_s:.2f} s)",
                          B, y)
        by_mode[f"Anderson 128^3 f32 {'U' if B.upper else 'L'}"] = {
            k: rec[k] for k in ("ms", "direct_ms", "per_level_ms",
                                "in_place_ms", "floor_ms", "bound_ms",
                                "level_bound_ms")}
    del st, y
    U32 = setup5b.M.U_block
    if not (U32.is_const and U32.dinv_rows is not None):
        raise RuntimeError(f"{FDM_5B}'s U is not const with a per-row D")
    y = torch.randn(U32.n_rows, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(17))
    rec = _mega_solve(torch, bk, f"{FDM_5B} f32", U32, y)
    by_mode["fdm:2048 f32 U"] = {
        k: rec[k] for k in ("ms", "direct_ms", "per_level_ms", "in_place_ms",
                            "floor_ms", "bound_ms", "level_bound_ms")}
    U64 = _widen(U32, torch)
    route64 = bk.mega_route_for(U64, 8, y.device)
    print(f"[mega] {FDM_5B} f64 U solve: the picker names {route64!r} "
          f"(x {8 * U64.n_rows / 2 ** 20:.1f} MiB; brick shape "
          f"{U64._args[('brick_shape', 8, y.device.index)]})")
    if route64 != "direct":
        raise RuntimeError(f"{FDM_5B} f64 should take the direct route")
    del y, U64
    torch.cuda.empty_cache()
    record["by_mode"] = by_mode
    return record


def phase_mega_rows(torch, bt):
    """The bench's sgs and pcg rows on HPCG 128^3 (1200 iterations, f32,
    tolerance 0) with MEGA on and off in turns (on, off, off, on), each
    after a warm-up solve with every counter set to 0 just before the timed
    solve and read just after: 2 one-launch solves an apply with MEGA, all
    on the brick route (the picker's at 128^3), 8 level launches without.
    Returns the one-launch solve's launches over the MEGA runs, in all and
    by route."""
    import math
    from basic_iterative_solvers_tpu_torch.ops import block_trisolve as bk
    from basic_iterative_solvers_tpu_torch.ops import gmres_basis as gb
    from basic_iterative_solvers_tpu_torch.solvers import make_method
    so = bt.stencil_op
    S, P = bt.SolverType, bt.PrecondType
    mega_launches = 0
    by_route = {"brick": 0, "direct": 0}
    rows = [r for r in SLICE3_ROWS if r[0] in ("sgs", "pcg")]
    for name, method, precond, iters, kw in rows:
        setup = _setup(torch, bt, MAIN_SPEC, torch.float32, "cuda",
                       S[method], preconditioner=P[precond],
                       max_iters=iters, tolerance=0.0, breakdown_stall=True,
                       precond_inner_iters=1, **kw)
        solver = make_method(setup)
        ms, counts = {True: [], False: []}, {}
        try:
            for mega in (True, False, False, True):
                bk.MEGA = mega
                bt.solve(setup, method=solver)            # warm-up solve
                _counters(so, gb, bk, reset=True)
                res = bt.solve(setup, method=solver)
                counts[mega] = _counters(so, gb, bk)
                ms[mega].append(1e3 * res.solve_seconds / res.iter_count)
                if mega:
                    mega_launches += counts[mega]["super_solve_mega"]
                    for rt in by_route:
                        by_route[rt] += counts[mega][
                            f"super_solve_mega_{rt}"]
                if not (res.iter_count == iters
                        and math.isfinite(res.final_residual_norm)):
                    raise RuntimeError(f"{name} MEGA={mega} run failed")
        finally:
            bk.MEGA = False
        on, off = counts[True], counts[False]
        keys = ("super_level", "super_solve_mega", "super_solve_mega_brick",
                "super_solve_mega_direct")
        per = {k: {key: round(c[key] / iters, 3) for key in keys}
               for k, c in (("on", on), ("off", off))}
        print(f"[mega] {MAIN_SPEC} f32 {name} fused, MEGA in turns (on, "
              f"off, off, on): ms/iter on={[f'{v:.5f}' for v in ms[True]]} "
              f"off={[f'{v:.5f}' for v in ms[False]]} launches/iter={per}")
        if not (on["super_level"] == 0 and off["super_solve_mega"] == 0
                and on["super_solve_mega"] > 0
                and on["super_solve_mega_brick"] == on["super_solve_mega"]
                and off["super_level"] == 4 * on["super_solve_mega"]):
            raise RuntimeError(f"{name}: the routes' launch counts do not "
                               f"match: {per}")
    return mega_launches, by_route


STREAM_SPECS = ((MAIN_SPEC, "float32", ((), ("x",), ("self",), ("aux",))),
                (MAIN_SPEC, "float64", (("x",),)),
                ("hpcg:384x384x384", "float32", (("x",),)),
                (KERNEL_SPECS[2], "float32", (("self",),)),
                ("fdm:2048", "float32", (("x",),)),
                ("galerkin:64", "float32", (("x",),)))
#: kernel #2's dots against #1's, relative to sum|y_i v_i| (the order of
#: the per-block partial sums differs)
STREAM_DOT_RTOL = {"float32": 1e-6, "float64": 1e-13}


def _galerkin_64(torch, bt, dtype):
    """The 64^3 level of the 128^3 multigrid hierarchy (27 Galerkin legs)."""
    from basic_iterative_solvers_tpu_torch import mg
    A = bt.stencil_op.from_source_operator(MAIN_SPEC, dtype, device="cuda")
    levels = mg.build_mg_hierarchy(A, bt.SolverConfig(
        preconditioner=bt.PrecondType.MULTIGRID, dtype=dtype))
    return levels[1].A


def phase_stream_vs_plain(torch, bt, library_ms):
    """Kernel #2 against its plain version (#1's) and against #1 on every
    operator of STREAM_SPECS: y of #2 on the route it takes (`route_for`),
    of #2's and #1's leg-loop routes and of #1's box route all bit-equal,
    within TOL of plain, #2's dots within STREAM_DOT_RTOL of #1's; #2's
    routes timed in turns (route, legs, legs, route) and #1's box route,
    by device time on bound launches, and through the wrappers, with the
    byte bound (x and y, plus the diagonal and aux).  Returns the record
    of 128^3 f32 with y.x (the CG SpMV), its library time the CSR SpMV's
    of phase 3 (the same matrix and x)."""
    so = bt.stencil_op
    record = None
    for spec, dt_name, dot_sets in STREAM_SPECS:
        dt = getattr(torch, dt_name)
        A = (_galerkin_64(torch, bt, dt) if spec == "galerkin:64"
             else so.from_source_operator(spec, dt, device="cuda"))
        if not so.stream_reach(A):
            raise RuntimeError(f"{spec} lies outside kernel #2's reach")
        g = torch.Generator(device="cuda").manual_seed(0)
        x = torch.randn(A.n_rows, dtype=dt, device="cuda", generator=g)
        aux = torch.randn(A.n_rows, dtype=dt, device="cuda", generator=g)
        for dots in dot_sets:
            before = so.stencil_spmv_stream.launches
            route = so.route_for(A, x, aux if "aux" in dots else None,
                                 stream=True)
            k2 = so.stencil_spmv_stream(A, x, dots, aux)
            k1 = so._stencil_spmv_cuda(A, x, dots, aux)
            p = so.stencil_spmv_plain(A, x, dots, aux)
            legs2 = so._stencil_spmv_stream_cuda(A, x, dots, aux,
                                                 route="legs")
            legs1 = so._stencil_spmv_cuda(A, x, dots, aux, route="legs")
            torch.cuda.synchronize()
            if so.stencil_spmv_stream.launches != before + 2:
                raise RuntimeError("kernel #2's launch count did not grow")
            k2, k1, p, legs2, legs1 = (
                (k2, k1, p, legs2, legs1) if dots else
                ((k2,), (k1,), (p,), (legs2,), (legs1,)))
            bit_equal = all(torch.equal(k2[0], o[0])
                            for o in (k1, legs2, legs1))
            abs_err = float((k2[0] - p[0]).abs().max())
            rel = abs_err / float(p[0].abs().max())
            partner = {"x": x, "self": k1[0], "aux": aux}
            dot_rel = [abs(float(d2 - d1))
                       / float((k1[0] * partner[kind]).abs().sum())
                       for kind, d2, d1 in zip(dots, k2[1:], k1[1:])]
            # device times of bound launches, #2's routes in turns; call
            # times through the wrappers (operand checks, allocation, the
            # partials' sum: host work that can exceed the kernel's)
            if route == "box":
                t_box, t_legs = _route_ab(torch, so, A, x, dots, aux, True)
            else:
                t_box = ()
                t_legs = (_device_ms(so._bind_spmv(A, x, dots, aux, True,
                                                   "legs")[0], torch),)
            t_res = _device_ms(so._bind_spmv(A, x, dots, aux, False,
                                             "box")[0], torch)
            ms2 = min(t_box or t_legs)
            call2 = _median_ms(
                lambda: so.stencil_spmv_stream(A, x, dots, aux), torch)
            call1 = _median_ms(
                lambda: so._stencil_spmv_cuda(A, x, dots, aux), torch)
            n_vec = 2 + (A.diag is not None) + ("aux" in dots)
            bound = _bound(n_vec * A.n_rows * x.element_size(),
                           2 * len(A.legs) * A.n_rows)
            b = bound["bound_ms"]
            print(f"[stream] {spec} {dt_name} dims={A.dims} legs="
                  f"{len(A.legs)} dots={','.join(dots) or '-'} route={route} "
                  f"bit_equal_to_#1_and_legs={bit_equal} max_rel_err_vs_plain="
                  f"{rel:.3e} dot_rel_vs_#1={[f'{e:.3e}' for e in dot_rel]} "
                  f"device_ms #2 box={[f'{t:.5f}' for t in t_box]} "
                  f"legs={[f'{t:.5f}' for t in t_legs]} #1 box={t_res:.5f} "
                  f"call_ms #2={call2:.4f} #1={call1:.4f} "
                  f"bound_ms={b:.5f} ({bound['bound_by']}) share_of_bound "
                  f"#2={b / ms2:.3f} #2_legs={b / min(t_legs):.3f} "
                  f"#1={b / t_res:.3f}")
            if not (bit_equal and rel <= TOL[dt_name]
                    and all(e <= STREAM_DOT_RTOL[dt_name] for e in dot_rel)):
                raise RuntimeError(f"kernel #2 disagrees: {spec} {dt_name} "
                                   f"{dots}")
            if (spec, dt_name, dots) == (MAIN_SPEC, "float32", ("x",)):
                plain_ms = _median_ms(
                    lambda: so.stencil_spmv_plain(A, x, dots, aux), torch)
                record = {"max_abs_err": abs_err, "ms": ms2,
                          "legs_ms": min(t_legs), "plain_ms": plain_ms,
                          "library_ms": library_ms, "resident_ms": t_res,
                          "call_ms": call2, **bound}
            if (spec, dt_name) == ("hpcg:384x384x384", "float32"):
                record.update({"ms_384": ms2, "legs_ms_384": min(t_legs),
                               "resident_ms_384": t_res,
                               "bound_ms_384": b})
        del A, x, aux
        torch.cuda.empty_cache()
    return record


#: every operator of STREAM_SPECS and KERNEL_SPECS, once each
ROUTE_SPECS = tuple(dict.fromkeys(
    [spec for spec, _dt, _dots in STREAM_SPECS] + list(KERNEL_SPECS)))


def phase_routes_bit_equal(torch, bt):
    """[routes]: on every operator of ROUTE_SPECS in float32 and float64,
    with y.x, #1 on its box and its leg-loop route and #2 on the route
    route_for names and on its leg-loop route: all four y bit-equal,
    within TOL of the plain version, #2's dot within STREAM_DOT_RTOL of
    #1's leg loop's (relative to sum|y x|)."""
    so = bt.stencil_op
    for spec in ROUTE_SPECS:
        for dt_name in ("float32", "float64"):
            dt = getattr(torch, dt_name)
            A = (_galerkin_64(torch, bt, dt) if spec == "galerkin:64"
                 else so.from_source_operator(spec, dt, device="cuda"))
            g = torch.Generator(device="cuda").manual_seed(1)
            x = torch.randn(A.n_rows, dtype=dt, device="cuda", generator=g)
            route2 = so.route_for(A, x, stream=True)
            outs = {"#1 box": so._stencil_spmv_cuda(A, x, ("x",), None,
                                                     route="box"),
                    "#1 legs": so._stencil_spmv_cuda(A, x, ("x",), None,
                                                      route="legs"),
                    f"#2 {route2}": so._stencil_spmv_stream_cuda(
                        A, x, ("x",), None),
                    "#2 legs": so._stencil_spmv_stream_cuda(
                        A, x, ("x",), None, route="legs")}
            y_p = so.stencil_spmv_plain(A, x)
            torch.cuda.synchronize()
            y_l, d_l = outs["#1 legs"]
            equal = all(torch.equal(y, y_l) for y, _d in outs.values())
            rel = float((y_l - y_p).abs().max() / y_p.abs().max())
            scale = float((y_l * x).abs().sum())
            dot_rel = max(abs(float(d - d_l)) / scale
                          for _y, d in outs.values())
            print(f"[routes] {spec} {dt_name} y.x: {', '.join(outs)} "
                  f"bit_equal={equal} max_rel_err_vs_plain={rel:.3e} "
                  f"max_dot_rel_vs_#1_legs={dot_rel:.3e}")
            if not (equal and rel <= TOL[dt_name]
                    and dot_rel <= STREAM_DOT_RTOL[dt_name]):
                raise RuntimeError(f"[routes] {spec} {dt_name}: the routes "
                                   "disagree")
            del A, x, outs, y_p, y_l
            torch.cuda.empty_cache()


#: slice 6's rows: (name, spec, preconditioner, iterations), f32 fused,
#: tolerance 0, b = 2, x0 = 1 (bench.py:164-180, 568; pcg_mg's 1200 cut
#: to 400 to keep the script inside its time limit)
SLICE6_ROWS = (("pcg_mg", MAIN_SPEC, "MULTIGRID", 400),
               ("cg", MAIN_SPEC, "NONE", 2500),
               ("cg@384", "hpcg:384x384x384", "NONE", 150),
               ("pcg_mg@384", "hpcg:384x384x384", "MULTIGRID", 100))


#: the rows whose STREAM A/B also runs each kernel on its leg-loop route
ROUTE_AB_ROWS = ("cg@384", "pcg_mg@384")


@contextlib.contextmanager
def _spmv_routes(so, route):
    """Run #1 and #2 on `route` ("legs"), or on the route each operator's
    shape takes (None): stencil_op.route_for replaced for the block."""
    shape_route = so.route_for
    if route is not None:
        so.route_for = lambda *args, **kw: route
    try:
        yield
    finally:
        so.route_for = shape_route


def phase_slice6_rows(torch, bt):
    """SLICE6_ROWS with STREAM (kernel #2) off and on in turns (off, on,
    on, off), after a warm-up solve with each, on the route each operator's
    shape takes (the box route); the ROUTE_AB_ROWS also on the leg-loop
    route, the four configurations in turns (route, STREAM: box off, box
    on, legs off, legs on, then back); every counter set to 0 just before
    each timed solve and read just after.  Prints ms/iter, launches of #1
    and #2 an iteration by route, the explicit float64 residual, set-up
    seconds and peak memory; fails unless the STREAM runs launch #2 and no
    #1, the others #1 and no #2, each on the route of its configuration
    only.  Returns #2's launches over the pcg_mg STREAM runs and each
    row's launches an iteration."""
    import math
    from basic_iterative_solvers_tpu_torch.ops import block_trisolve as bk
    from basic_iterative_solvers_tpu_torch.ops import gmres_basis as gb
    from basic_iterative_solvers_tpu_torch.solvers import make_method
    so = bt.stencil_op
    stream_launches, by_row = 0, {}
    for name, spec, precond, iters in SLICE6_ROWS:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        setup = _setup(torch, bt, spec, torch.float32, "cuda",
                       bt.SolverType.CONJUGATE_GRADIENT,
                       preconditioner=bt.PrecondType[precond],
                       max_iters=iters, tolerance=0.0, breakdown_stall=True)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        solver = make_method(setup)
        configs = [("box", False), ("box", True)]
        if name in ROUTE_AB_ROWS:
            configs += [("legs", False), ("legs", True)]
        order = configs + configs[::-1]
        ms, per = {c: [] for c in configs}, {}
        try:
            for route, stream in configs:                # warm-up solves
                so.STREAM = stream
                with _spmv_routes(so, None if route == "box" else route):
                    bt.solve(setup, method=solver)
            for route, stream in order:
                so.STREAM = stream
                _counters(so, gb, bk, reset=True)
                for fn in (so.stencil_spmv, so.stencil_spmv_stream):
                    fn.box_launches = fn.legs_launches = 0
                with _spmv_routes(so, None if route == "box" else route):
                    res = bt.solve(setup, method=solver)
                c = _counters(so, gb, bk)
                fn = so.stencil_spmv_stream if stream else so.stencil_spmv
                on_route = getattr(fn, f"{route}_launches")
                off_route = getattr(fn, ("legs" if route == "box" else "box")
                                    + "_launches")
                ms[route, stream].append(1e3 * res.solve_seconds
                                         / res.iter_count)
                per[route, stream] = {k: round(c[k] / res.iter_count, 3)
                                      for k in ("stencil_spmv",
                                                "stencil_spmv_stream")}
                if stream and name == "pcg_mg" and route == "box":
                    stream_launches += c["stencil_spmv_stream"]
                ok = (res.iter_count == iters
                      and math.isfinite(res.final_residual_norm)
                      and bool(torch.isfinite(res.x_star).all()))
                routed = ((c["stencil_spmv_stream"] > 0
                           and c["stencil_spmv"] == 0) if stream else
                          (c["stencil_spmv"] > 0
                           and c["stencil_spmv_stream"] == 0))
                routed = routed and off_route == 0 and on_route == (
                    c["stencil_spmv_stream" if stream else "stencil_spmv"])
                if not (ok and routed):
                    raise RuntimeError(f"{name} route={route} STREAM="
                                       f"{stream} run failed its checks: {c}")
        finally:
            so.STREAM = False
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        by_row[name] = {stream: per["box", stream] for stream in (False,
                                                                  True)}
        times = " ".join(
            f"{route}/{'on' if stream else 'off'}="
            f"{[f'{v:.5f}' for v in ms[route, stream]]}"
            for route, stream in configs)
        turns = [f"{r}/{int(st)}" for r, st in order]
        print(f"[slice6] {spec} f32 {name} fused, {iters} iterations, "
              f"(route/STREAM) in turns {turns}: ms/iter {times} "
              f"launches/iter off="
              f"{per['box', False]} on={per['box', True]} "
              f"final_explicit_f64={res.final_residual_norm:.6e} "
              f"setup_s={setup_s:.3f} peak_GB={peak_gb:.3f}")
        del setup, solver
        torch.cuda.empty_cache()
    return stream_launches, by_row


def phase_pipelined_row(torch, bt):
    """Pipelined against classic CG on HPCG 128^3, f32 fused, tolerance 0,
    300 iterations, in turns (classic, pipelined, pipelined, classic),
    each after a warm-up solve: the cost of reading the residual-
    replacement trigger on the host every iteration (the pipelined solve
    may stop early where its float32 recurrence turns non-finite)."""
    import math
    from basic_iterative_solvers_tpu_torch.solvers import make_method
    ms, reps = {"classic": [], "pipelined": []}, []
    setups = {f: _setup(torch, bt, MAIN_SPEC, torch.float32, "cuda",
                        bt.SolverType.CONJUGATE_GRADIENT, cg_flavor=f,
                        max_iters=300, tolerance=0.0, breakdown_stall=True)
              for f in ms}
    for flavor in ("classic", "pipelined", "pipelined", "classic"):
        solver = make_method(setups[flavor])
        bt.solve(setups[flavor], method=solver)        # warm-up solve
        solver = make_method(setups[flavor])
        res = bt.solve(setups[flavor], method=solver)
        ms[flavor].append(1e3 * res.solve_seconds / res.iter_count)
        if flavor == "pipelined":
            reps.append((res.iter_count, solver.replacements))
        if not (res.iter_count > 0 and math.isfinite(res.residual_norms[0])):
            raise RuntimeError(f"{flavor} CG row failed")
    print(f"[pipelined] {MAIN_SPEC} f32 CG fused, 300 iterations, in turns: "
          f"ms/iter classic={[f'{v:.5f}' for v in ms['classic']]} "
          f"pipelined={[f'{v:.5f}' for v in ms['pipelined']]} "
          f"(iterations, replacements)={reps}")


def phase_cg_mg_refine(torch, bt):
    """cg_mg_refine at 128^3 (bench.py:334-384, 570): CG + MG with float32
    inners to 1e-6 and float64 outers to 1e-11·||r0||, the single-dispatch
    form, after a warm-up solve.  The explicit float64 residual of the
    answer, computed here, must meet the stopping criterion."""
    from basic_iterative_solvers_tpu_torch.ops.spmv import spmv
    from basic_iterative_solvers_tpu_torch.solvers.base import (
        _refine_fused_eligible)
    setup = _setup(torch, bt, MAIN_SPEC, torch.float32, "cuda",
                   bt.SolverType.CONJUGATE_GRADIENT,
                   preconditioner=bt.PrecondType.MULTIGRID, refine_outer=8,
                   tolerance=1e-11, max_iters=300)
    if not _refine_fused_eligible(setup):
        raise RuntimeError("cg_mg_refine is not on the single-dispatch form")
    bt.solve(setup)                                    # warm-up solve
    res = bt.solve(setup)
    A64 = bt.stencil_op.stencil_astype(setup.A, torch.float64)
    r = setup.b.to(torch.float64) - spmv(A64, res.x_star)
    explicit = float(torch.linalg.norm(r))
    print(f"[refine] {MAIN_SPEC} cg_mg_refine (f32 CG + MG inner, f64 "
          f"outer, tol 1e-11): seconds={res.solve_seconds:.4f} "
          f"converged={res.converged} outers={res.refine_outer_count} "
          f"inner_iterations={res.iter_count} outer_norms="
          f"{[f'{v:.6e}' for v in res.residual_norms]} explicit_f64="
          f"{explicit:.6e} stop={res.stopping_criteria:.6e}")
    if not (res.converged and explicit <= res.stopping_criteria):
        raise RuntimeError("cg_mg_refine did not reach 1e-11·||r0||")


def phase_cpu_vs_card_slice6(torch, bt):
    """CG + MG, CG + Chebyshev, pipelined CG and CG + MG with refinement
    (float64 inners to 1e-3, outers to 1e-9) on HPCG 32^3 in float64, on
    the CPU and on the card: equal counts (iterations, outers), histories
    (outer norms for the refined solve) as _check_history says."""
    S, P = bt.SolverType, bt.PrecondType
    cases = [("CG + MG", dict(preconditioner=P.MULTIGRID, tolerance=1e-10)),
             ("CG + Chebyshev", dict(preconditioner=P.CHEBYSHEV,
                                     tolerance=1e-10)),
             ("pipelined CG", dict(cg_flavor="pipelined", tolerance=1e-10)),
             ("CG + MG + refinement", dict(
                 preconditioner=P.MULTIGRID, refine_outer=6, tolerance=1e-9,
                 refine_inner_tol=1e-3))]
    for label, kw in cases:
        c, g = (bt.solve(_setup(torch, bt, "hpcg:32x32x32", torch.float64,
                                dev, S.CONJUGATE_GRADIENT, max_iters=500,
                                **kw)) for dev in ("cpu", "cuda"))
        print(f"[cpu-vs-card-slice6] hpcg:32x32x32 f64 {label}: iters cpu="
              f"{c.iter_count} card={g.iter_count} outers cpu="
              f"{c.refine_outer_count} card={g.refine_outer_count} "
              f"final cpu={c.final_residual_norm:.6e} "
              f"card={g.final_residual_norm:.6e}")
        if not (c.converged and g.converged):
            raise RuntimeError(f"{label}: a solve did not converge")
        if (c.iter_count, c.refine_outer_count) != (g.iter_count,
                                                    g.refine_outer_count):
            raise RuntimeError(f"{label}: CPU and card counts differ")
        # the refined solve's history is its outer norms, the last at the
        # float64 evaluation floor (left out, as an explicit final is)
        _check_history(g, c)


def _row_counts(bt, reset=False):
    """Every kernel counter a slice-5b row may touch."""
    from basic_iterative_solvers_tpu_torch.ops import block_trisolve as bk
    from basic_iterative_solvers_tpu_torch.ops import gmres_basis as gb
    counts = _counters(bt.stencil_op, gb, bk, reset=reset)
    counts.update(_sparse_counters(bt, reset=reset))
    return counts


def phase_slice5b_rows(torch, bt, setup, setup_s):
    """The slice's rows, f32, fused harness, tolerance 0, b = 2, x0 = 1,
    each after a warm-up solve with every counter set to 0 just before the
    timed solve and read just after: pcg_ilu0@fdm2048 (1200 iterations; L
    in plane mode, U const with U's pivots per row; DIA operator, the JAX
    CLI's host route) and pbicgstab@anderson128 (800; BiCGSTAB + SGS, the
    stencil injected as the JAX bench does; const mode with a per-row D),
    with set-up seconds and peak memory; then f64 CG + ILU(0) on fdm:256 to
    1e-8 on the same route on the CPU and on the card, equal counts.
    Returns the plane level's launches in the fdm:2048 row."""
    import math
    from basic_iterative_solvers_tpu_torch.ops import block_trisolve as bk
    from basic_iterative_solvers_tpu_torch.solvers import make_method
    out = {}
    rows = [("pcg_ilu0@fdm2048", FDM_5B, 1200, lambda: (setup, setup_s))]

    def anderson():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        st, gen_s, s_s = _colored_host_setup(
            torch, bt, ANDERSON_128, torch.float32, "BICGSTAB",
            "SYMMETRIC_GAUSS_SEIDEL", stencil=True, max_iters=800,
            tolerance=0.0, breakdown_stall=True)
        print(f"[slice5b] {ANDERSON_128} f32 BiCGSTAB + SGS pair from host "
              f"CSR: L {_mode(st.M.L_block)}, U {_mode(st.M.U_block)}; host "
              f"CSR {gen_s:.3f} s, preprocessing {s_s:.3f} s, "
              f"host={_host_branch(bt)}")
        return st, s_s

    rows.append(("pbicgstab@anderson128", ANDERSON_128, 800, anderson))
    for name, spec, iters, make in rows:
        st, s_s = make()
        L, U = st.M.L_block, st.M.U_block
        S = L.S
        if name.startswith("pcg"):
            want = {"super_level_plane": S * (iters + 1),
                    "super_level": S * (iters + 1)}
            if not (L.is_plane and U.is_const and U.dinv_rows is not None):
                raise RuntimeError(f"{name}: not the plane pair")
        else:
            want = {"super_level": 2 * S * (2 * iters + 1)}
            if not (L.is_const and U.is_const and L.dinv_rows is not None
                    and len(set(L.dinv_rows[:4096].tolist())) > 1):
                raise RuntimeError(f"{name}: not const mode with a per-row "
                                   "D")
        solver = make_method(st)
        picked = _picked_routes(bk, 4, L, U)
        bt.solve(st, method=solver)                       # warm-up solve
        _row_counts(bt, reset=True)
        res = bt.solve(st, method=solver)
        counts = _row_counts(bt)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        ms = 1e3 * res.solve_seconds / max(1, res.iter_count)
        per_iter = {k: round(v / res.iter_count, 3)
                    for k, v in counts.items() if v}
        print(f"[slice5b] {spec} f32 {name} fused: iters={res.iter_count} "
              f"ms/iter={ms:.5f} setup_s={s_s:.3f} host={_host_branch(bt)} "
              f"peak_GB={peak_gb:.3f} "
              f"r0={res.residual_norms[0]:.6e} "
              f"final_explicit_f64={res.final_residual_norm:.6e} "
              f"levels by the picker's route {picked} "
              f"launches={ {k: v for k, v in counts.items() if v} } "
              f"launches/iter={per_iter}")
        if not (res.iter_count == iters
                and math.isfinite(res.final_residual_norm)
                and bool(torch.isfinite(res.x_star).all())
                and all(counts[k] == v for k, v in want.items())
                and len(picked) == 1 and _all_on_route(counts, *picked)
                and counts["super_solve_mega"] == 0):
            raise RuntimeError(f"slice-5b {name} failed its checks: "
                               f"{counts} against {want}")
        out[name] = counts
        if name.startswith("pcg"):
            # both routes in turns, every count set to 0 just before each
            # solve and read just after
            turns = {}
            for route in ("direct", "line", "line", "direct"):
                _row_counts(bt, reset=True)
                with _on_route(route, L, U):
                    r = bt.solve(st, method=solver)
                c = _row_counts(bt)
                if not (r.iter_count == iters and _all_on_route(c, route)
                        and all(c[k] == v for k, v in want.items())):
                    raise RuntimeError(f"{name} on the {route} route failed "
                                       f"its checks: {c}")
                turns.setdefault(route, []).append(
                    1e3 * r.solve_seconds / r.iter_count)
            print(f"[slice5b] {spec} f32 {name}: ms/iter in turns (direct, "
                  f"line, line, direct): line={turns['line']} "
                  f"direct={turns['direct']}")
        del st, solver, res, L, U
        torch.cuda.empty_cache()

    res = {}
    for dev in ("cpu", "cuda"):
        st, _g, s_s = _colored_host_setup(
            torch, bt, "fdm:256", torch.float64, "CONJUGATE_GRADIENT", "ILU0",
            device=dev, tolerance=1e-8, max_iters=2000)
        res[dev] = (bt.solve(st), s_s, _mode(st.M.L_block))
    (c, cs, mode), (g, gs, _m) = res["cpu"], res["cuda"]
    r0 = g.residual_norms[0]
    print(f"[slice5b] fdm:256 f64 CG + ILU(0) coloured host route (L {mode}) "
          f"to tol 1e-8: iters cpu={c.iter_count} card={g.iter_count} "
          f"final_explicit/r0 card={g.final_residual_norm / r0:.3e} "
          f"ms/iter cpu={1e3 * c.solve_seconds / c.iter_count:.3f} "
          f"card={1e3 * g.solve_seconds / g.iter_count:.3f} setup_s "
          f"cpu={cs:.2f} card={gs:.2f} host={_host_branch(bt)}")
    if (c.iter_count != g.iter_count or not (c.converged and g.converged)
            or g.final_residual_norm > 10 * 1e-8 * r0):
        raise RuntimeError("fdm:256 coloured CG + ILU(0): CPU and card "
                           "differ or did not converge")
    _check_history(g, c)
    fdm = out["pcg_ilu0@fdm2048"]
    return fdm["super_level_plane"], {
        rt: fdm[f"super_level_plane_{rt}"] for rt in ("line", "direct")}


ANDERSON_128 = KERNEL_SPECS[2]


def _bf16_counters(bt, reset=False):
    """The launch counts of the bf16 forms (`reset`: set to 0 first)."""
    from basic_iterative_solvers_tpu_torch.ops import dia_spmv, lane_ell
    so = bt.stencil_op
    fns = {"dia_spmv_bf16": dia_spmv.dia_spmv,
           "lane_ell_spmv_bf16": lane_ell.lane_ell_spmv,
           "stencil_spmv_bf16diag": so.stencil_spmv,
           "stencil_spmv_stream_bf16diag": so.stencil_spmv_stream,
           "stencil_gs_step_bf16diag": so.stencil_gs_color_step}
    if reset:
        for fn in fns.values():
            fn.bf16_launches = 0
        so.stencil_gs_color_step.box_launches = 0
        so.stencil_gs_color_step.legs_launches = 0
    out = {name: fn.bf16_launches for name, fn in fns.items()}
    out.update({f"stencil_gs_step_{rt}": getattr(so.stencil_gs_color_step,
                                                 f"{rt}_launches")
                for rt in ("box", "legs")})
    return out


def _library_bf16(torch, A_host_csr, x):
    """(ms, what): one torch.sparse CSR SpMV on bf16 values and a bf16
    x where the card's library takes them, else the float32 CSR's, named
    either way."""
    C = _csr_on_card(torch, A_host_csr, torch.bfloat16)
    try:
        xb = x.to(torch.bfloat16)
        C @ xb
        torch.cuda.synchronize()
        return _median_ms(lambda: C @ xb, torch), "torch.sparse CSR, bf16"
    except (RuntimeError, NotImplementedError) as e:
        print(f"[library] torch.sparse CSR refuses bf16 on the card "
              f"({str(e).splitlines()[0][:120]}); timing float32 CSR")
    C = _csr_on_card(torch, A_host_csr, torch.float32)
    x32 = x.to(torch.float32)
    return (_median_ms(lambda: C @ x32, torch),
            "torch.sparse CSR, float32 (bf16 refused)")


def _bf16_form(torch, tag, label, fn, kernel, plain, twin, x, launches=1,
               exact_plain=True, plain_reps=20):
    """A bf16 form against its plain version (bit for bit where
    `exact_plain`, else within TOL of max|plain|) and against `twin`, the
    same kernel on the matrix data widened to x's dtype (bit for bit: the
    widening is exact); its launches counted in fn.bf16_launches.
    Returns (max_abs_err against plain, ms, plain_ms)."""
    before = fn.bf16_launches
    yk = kernel(x)
    yp, yt = plain(x), twin(x)
    torch.cuda.synchronize()
    if fn.bf16_launches != before + launches:
        raise RuntimeError(f"{tag} {label}: the bf16 launch count did not "
                           "grow")
    err = float((yk - yp).abs().max())
    rel = err / float(yp.abs().max())
    equal, twin_equal = torch.equal(yk, yp), torch.equal(yk, yt)
    ms = _median_ms(lambda: kernel(x), torch)
    plain_ms = _median_ms(lambda: plain(x), torch, reps=plain_reps,
                          batch=max(1, plain_reps // 2))
    print(f"[bf16] {label}: bit_equal_plain={equal} max_rel_err={rel:.3e} "
          f"bit_equal_widened_twin={twin_equal} kernel_ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f}")
    if not twin_equal or not (equal if exact_plain
                              else rel <= TOL["float32"]):
        raise RuntimeError(f"{tag} {label}: the bf16 form disagrees")
    return err, ms, plain_ms


def phase_bf16_vs_plain(torch, bt, sband):
    """Slice 6b's kernel forms on the card, float32 vectors: #4 with bf16
    data on the DIA HPCG 128^3 and 384^3 (y bit-equal to plain and to the
    float32-data kernel: 26 and -1 are exact in bf16), #5 with bf16 values
    on sband:500000,8,400 (bit-equal to plain and to the float32-value
    kernel on the widened values), #1, #2 and #3 with Anderson 128^3's
    diagonal in bf16 (bit-equal to the float32-diagonal kernel on the
    widened diagonal, within TOL of plain, whose sum order differs as
    PERF.md says); each timed (median of 20 batches of 10) beside its
    plain version and the library's CSR SpMV.  Returns the records."""
    from basic_iterative_solvers_tpu_torch.coloring import spec_for_device
    from basic_iterative_solvers_tpu_torch.ops import dia_spmv as ds
    from basic_iterative_solvers_tpu_torch.ops import lane_ell as le
    so = bt.stencil_op
    g = torch.Generator(device="cuda").manual_seed(8)
    records = {}
    for spec in (MAIN_SPEC, DIA_384):
        A = bt.dia.from_source_device(spec, torch.bfloat16, device="cuda")
        A32 = bt.dia.from_source_device(spec, torch.float32, device="cuda")
        x = torch.randn(A.n_rows, device="cuda", generator=g)
        k, n = len(A.offsets), A.n_rows
        err, ms, plain_ms = _bf16_form(
            torch, "dia", f"#4 {spec} bf16 data, f32 x", ds.dia_spmv,
            lambda v: ds.dia_spmv(A, v), lambda v: ds.dia_spmv_plain(A, v),
            lambda v: ds.dia_spmv(A32, v), x,
            plain_reps=20 if spec == MAIN_SPEC else 4)
        ms32 = _median_ms(lambda: ds.dia_spmv(A32, x), torch)
        bound = _bound(2 * k * n + 2 * 4 * n, 2 * k * n)
        print(f"[bf16] #4 {spec} bound_ms={bound['bound_ms']:.4f} "
              f"({bound['bound_by']}: {k} bf16 diagonals + x + y) "
              f"kernel_GB/s={(2 * k + 8) * n / (ms * 1e6):.0f}; the "
              f"float32-data kernel in the same call: {ms32:.4f} ms")
        if spec == MAIN_SPEC:
            lib_ms, lib = _library_bf16(
                torch, bt.generators.from_source(spec), x)
            print(f"[library] {spec} {lib}: ms={lib_ms:.4f}")
            records["dia_spmv_bf16"] = {
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "library_ms": lib_ms, **bound}
        else:
            records["dia_spmv_bf16"].update(ms_384=ms, f32_ms_384=ms32,
                                            bound_ms_384=bound["bound_ms"])
        del A, A32, x
        torch.cuda.empty_cache()
    M = bt.from_csr(sband, torch.bfloat16, "lane_ell", device="cuda")
    M32 = dataclasses.replace(M, vals=M.vals.float())   # the widened twin
    x = torch.randn(M.n_rows, device="cuda", generator=g)
    err, ms, plain_ms = _bf16_form(
        torch, "lane-ell", f"#5 {SBAND} bf16 values, f32 x",
        le.lane_ell_spmv, lambda v: le.lane_ell_spmv(M, v),
        lambda v: le.lane_ell_spmv_plain(M, v),
        lambda v: le.lane_ell_spmv(M32, v), x)
    _lane_ell_route_checks(torch, "bf16", f"#5 {SBAND} bf16 values", le, M,
                           x, twin=lambda v: le.lane_ell_spmv(M32, v))
    fns = {"idx16": lambda: le._lane_ell_spmv_cuda(M, x, "idx16"),
           "padded": _padded_whole(torch, le, M, x)}
    if not torch.equal(fns["padded"](), le.lane_ell_spmv_plain(M, x)):
        raise RuntimeError("[bf16] #5: the padded loop disagrees with plain")
    turns = _in_turns(torch, fns, ("padded", "idx16", "idx16", "padded"))
    n = M.n_rows
    padded, counted, slots, _w = _lane_ell_bytes(torch, M, 4, 2)
    # the values are 2 bytes, not x's 4
    padded -= 2 * M.K * n
    counted -= 2 * slots
    bound = _bound(counted, 2 * slots)
    pad_bound = _bound(padded, 2 * M.K * n)
    lib_ms, lib = _library_bf16(torch, sband, x)
    dev = min(turns["idx16"])
    print(f"[bf16] #5 {SBAND} device ms in turns (padded, idx16, idx16, "
          f"padded): {turns}; bound_ms={bound['bound_ms']:.4f} "
          f"({bound['bound_by']}: {slots} slots x (2 + 2) B + counts + x + "
          f"y = {counted / 1e6:.1f} MB; padded {pad_bound['bound_ms']:.4f}: "
          f"{M.K} slots x {n} rows x 6 B + x + y = {padded / 1e6:.1f} MB) "
          f"idx16 {bound['bound_ms'] / dev:.3f} of its bound "
          f"({counted / (dev * 1e6):.0f} GB/s); [library] {lib}: "
          f"ms={lib_ms:.4f}")
    records["lane_ell_spmv_bf16"] = {"max_abs_err": err, "ms": dev,
                                     "wrapper_ms": ms, "plain_ms": plain_ms,
                                     "library_ms": lib_ms,
                                     "padded_ms": min(turns["padded"]),
                                     "padded_bound_ms": pad_bound["bound_ms"],
                                     **bound}
    del M, M32, x
    A = so.from_source_operator(ANDERSON_128, torch.bfloat16, device="cuda")
    Aw = so.make_stencil(zip(A.legs, A.coeff_values), *A.dims,
                         dtype=torch.float32, diag=A.diag.float(),
                         device="cuda")
    x = torch.randn(A.n_rows, device="cuda", generator=g)
    n, legs = A.n_rows, len(A.legs)
    lib_ms, lib = _library_bf16(torch, bt.generators.from_source(
        ANDERSON_128), x)
    print(f"[library] {ANDERSON_128} {lib}: ms={lib_ms:.4f}")
    bound = _bound((4 + 4 + 2) * n, 2 * legs * n)
    for name, fn in (("stencil_spmv_bf16diag", so.stencil_spmv),
                     ("stencil_spmv_stream_bf16diag",
                      so.stencil_spmv_stream)):
        err, ms, plain_ms = _bf16_form(
            torch, "stencil", f"{'#2' if 'stream' in name else '#1'} "
            f"{ANDERSON_128} bf16 diagonal, f32 x", fn,
            lambda v: fn(A, v), lambda v: so.stencil_spmv_plain(A, v),
            lambda v: fn(Aw, v), x, exact_plain=False)
        records[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "library_ms": lib_ms, **bound}
    if not torch.equal(so.stencil_spmv(A, x), so.stencil_spmv_stream(A, x)):
        raise RuntimeError("#2's bf16-diagonal form differs from #1's")
    cs = spec_for_device(A)
    rhs = torch.randn(n, device="cuda", generator=g)
    dinv = 1.0 / so.stencil_diag(A).float()
    worst = None
    gs = so.stencil_gs_color_step
    if so.gs_route_for(A, x, rhs, dinv, cs) != "box":
        raise RuntimeError("#3's bf16-diagonal form did not pick its box "
                           "route")
    for c in range(cs.n_colors):
        box_before = gs.box_launches
        err, ms_c, plain_c = _bf16_form(
            torch, "gs-step", f"#3 {ANDERSON_128} bf16 diagonal, colour {c}",
            gs, lambda v: gs(A, v, rhs, dinv, cs, c),
            lambda v: so.stencil_gs_color_step_plain(A, v, rhs, dinv, cs, c),
            lambda v: gs(Aw, v, rhs, dinv, cs, c), x,
            exact_plain=False, plain_reps=5)
        legs_out = so._stencil_gs_color_step_cuda(A, x, rhs, dinv, cs, c,
                                                  route="legs")
        if gs.box_launches <= box_before or not torch.equal(
                gs(A, x, rhs, dinv, cs, c), legs_out):
            raise RuntimeError(f"#3 bf16 diagonal colour {c}: the box route "
                               "was not taken or differs from the leg loop")
        if c == 0:
            worst = (err, ms_c, plain_c)
        else:
            worst = (max(worst[0], err),) + worst[1:]
    turns = _in_turns(torch, {
        rt: (lambda rt=rt: so._stencil_gs_color_step_cuda(
            A, x, rhs, dinv, cs, 0, route=rt)) for rt in ("box", "legs")},
        ("box", "legs", "legs", "box"))
    n_c = n // cs.n_colors
    gs_bound = _bound(4 * (2 * n + 2 * n_c) + 2 * n_c, n_c * (2 * legs + 2))
    sector = _bound(4 * 4 * n + 2 * n, n_c * (2 * legs + 2))
    records["stencil_gs_step_bf16diag"] = {
        "max_abs_err": worst[0], "ms": min(turns["box"]),
        "legs_ms": min(turns["legs"]), "wrapper_ms": worst[1],
        "plain_ms": worst[2], "library_ms": None,
        "sector_bound_ms": sector["bound_ms"], **gs_bound}
    print(f"[bf16] #3 {ANDERSON_128} bf16 diagonal colour 0: box bit-equal "
          f"to the leg loop on every colour; device ms in turns "
          f"box={turns['box']} legs={turns['legs']} bound_ms="
          f"{gs_bound['bound_ms']:.4f} (coloured rows) sector_bound_ms="
          f"{sector['bound_ms']:.4f}; #1/#2 "
          f"bound_ms={bound['bound_ms']:.4f} ({bound['bound_by']}: x + y "
          f"f32 + diag bf16)")
    del A, Aw, x, rhs, dinv
    torch.cuda.empty_cache()
    return records


def _cli(torch, bt, argv):
    """cli.run(argv) in this process with its standard output and error
    captured; returns (rc, out, err, seconds).  The solve's own lines are
    parsed by _cli_report."""
    import contextlib
    import io
    from basic_iterative_solvers_tpu_torch import cli
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.run(argv)
    torch.cuda.synchronize()
    return rc, out.getvalue(), err.getvalue(), time.perf_counter() - t0


def _cli_report(out, err):
    """(iterations, converged, final residual, history, ms/iter) parsed
    from a run's output: the summary line, the final-residual line, the
    residual table and the [roofline] line's ms/iter."""
    m = re.search(r"(converged in:|did not converge after) (\d+) "
                  r"iterations", out)
    f = re.search(r"\|\|A\*x_star - b\|\|_2 = ([^\s]+?)\.?$", out, re.M)
    r = re.search(r"\[roofline\] \d+ iters, ([0-9.]+) ms/iter", err)
    if not (m and f and r):
        raise RuntimeError("the CLI's report is incomplete:\n"
                           + out[-1500:] + err[-1500:])
    hist = [float(v) for v in re.findall(
        r"^\|\|A\*x_\d+ - b\|\|_2 = ([^\s]+)", out, re.M)]
    return (int(m.group(2)), m.group(1) == "converged in:",
            float(f.group(1).rstrip(".")), hist, float(r.group(1)))


SLICE7_CPU_ROWS = (
    ["hpcg:32x32x32", "-cg", "--tol", "1e-10"],
    ["sband:20000,8,400", "-cg", "--tol", "1e-10"],
    ["anderson:Lx=32,Ly=32,Lz=32,t=1.0,ranpot=4.0,seed=1", "-gm", "-rl",
     "20", "-p", "j", "--format", "stencil", "--tol", "1e-8",
     "--max-iters", "200"])


def phase_cpu_vs_card_slice7(torch, bt):
    """The command line on the CPU and on the card, float64 vectors over
    bf16 matrix data (the kernels' f64_bf16 forms on the card): DIA CG on
    HPCG 32^3, lane-ELL CG on sband:20000,8,400, GMRES(20) + Jacobi on the
    Anderson 32^3 stencil with its bf16 diagonal; equal iteration counts,
    histories as _check_history says."""
    import types

    import numpy as np
    for argv in SLICE7_CPU_ROWS:
        got = {}
        for dev in ("cpu", "cuda"):
            rc, out, err, _s = _cli(torch, bt, argv + [
                "--dtype", "float64", "--matrix-dtype", "bfloat16",
                "--platform", dev])
            it, conv, final, hist, _ms = _cli_report(out, err)
            if rc != 0:
                raise RuntimeError(f"{argv} on {dev}: rc={rc}")
            got[dev] = types.SimpleNamespace(
                iter_count=it, converged=conv, final=final,
                residual_norms=np.asarray(hist))
        c, g = got["cpu"], got["cuda"]
        print(f"[cpu-vs-card-slice7] {' '.join(argv)} f64 x, bf16 data: "
              f"iters cpu={c.iter_count} card={g.iter_count} final "
              f"cpu={c.final:.6e} card={g.final:.6e}")
        if c.iter_count != g.iter_count or c.converged != g.converged:
            raise RuntimeError(f"{argv}: CPU and card runs differ")
        _check_history(g, c)


SLICE7_ROWS = (
    # (name, argv, expected iterations or None, bf16 counter that must run)
    ("cg 128^3 DIA f32", [MAIN_SPEC, "-cg", "--tol", "0", "--max-iters",
                          "2500"], 2500, None),
    ("cg@384 DIA f32", [DIA_384, "-cg", "--tol", "0", "--max-iters", "150"],
     150, None),
    ("cg@384 DIA bf16", [DIA_384, "-cg", "--tol", "0", "--max-iters", "150",
                         "--matrix-dtype", "bfloat16"], 150,
     "dia_spmv_bf16"),
    ("cg@sband lane-ELL bf16", [SBAND, "-cg", "--matrix-dtype", "bfloat16",
                                "--tol", "0", "--max-iters", "400"], 400,
     "lane_ell_spmv_bf16"),
    ("pbicgstab@anderson128 stencil bf16 diagonal",
     [ANDERSON_128, "-bi", "-p", "j", "--format", "stencil",
      "--matrix-dtype", "bfloat16", "--max-iters", "800"], None,
     "stencil_spmv_bf16diag"),
    ("gs@anderson128 masked sweeps bf16 diagonal",
     [ANDERSON_128, "-gs", "--format", "stencil", "--matrix-dtype",
      "bfloat16", "--tol", "0", "--max-iters", "20"], None,
     "stencil_gs_step_bf16diag"),
)


def _iter_times_check(torch, bt):
    """`hpcg:64x64x64 -cg --iter-times --profile DIR` through cli.run:
    prints the row with the CLI's [iter-times] line (on a miss, its count
    of device events and the kernel names nearest n_iters); returns
    whether it ran, wrote its trace and attached per-iteration device
    walls."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        rc, out, err, secs = _cli(torch, bt, [
            "hpcg:64x64x64", "-cg", "--iter-times", "--profile", tmp])
        it = _cli_report(out, err)[0]
        walls = [float(v) for v in re.findall(
            r"^\|\|A\*x_\d+ - b\|\|_2 = [^\s]+ +([0-9.]+)\[s\]", out, re.M)]
        traced = os.path.exists(os.path.join(tmp, "trace.json"))
    said = re.findall(r"^\[iter-times\].*$", err, re.M)
    ok = rc == 0 and traced and "measured device walls attached" in err
    print(f"[slice7] hpcg:64x64x64 -cg --iter-times --profile: rc={rc} "
          f"iters={it} {said} median wall_ms="
          f"{1e3 * statistics.median(walls) if walls else None} "
          f"trace_written={traced} command_s={secs:.2f}")
    return ok


def phase_slice7_cli(torch, bt):
    """The command line on the card through cli.run, in process, each row
    with every counter set to 0 just before it and read just after; the
    printed iteration count, final residual and [roofline] ms/iter parsed
    and checked.  The 384^3 rows run f32, bf16, bf16, f32 in turns, and
    the bf16 history must equal the f32 one entry for entry (HPCG's values
    are exact in bf16).  The Anderson BiCGSTAB row runs again with
    STREAM set (kernel #2, its bf16-diagonal form).  Then --kernel-timers
    (the device phase table, spmv > 0) and with --harness host (the
    stopwatch table), --iter-times and --profile at 64^3.  Returns the
    bf16 forms' launches on their rows and the timed rows."""
    import math
    so = bt.stencil_op
    launches, rows, hist384 = {}, {}, {}
    runs = [(row, False) for row in (SLICE7_ROWS[0], SLICE7_ROWS[1],
                                     SLICE7_ROWS[2], SLICE7_ROWS[2],
                                     SLICE7_ROWS[1]) + SLICE7_ROWS[3:]]
    runs.append((SLICE7_ROWS[4], True))
    for (name, argv, iters, form), stream in runs:
        so.STREAM = stream
        try:
            _bf16_counters(bt, reset=True)
            _sparse_counters(bt, reset=True)
            rc, out, err, secs = _cli(torch, bt, argv)
            c = {**_bf16_counters(bt), **_sparse_counters(bt)}
        finally:
            so.STREAM = False
        it, conv, final, hist, ms = _cli_report(out, err)
        label = name + (" STREAM" if stream else "")
        rows.setdefault(label, []).append(ms)
        if "384" in name:
            hist384.setdefault(name, []).append(hist)
        want = "stencil_spmv_stream_bf16diag" if stream else form
        counts = {k: v for k, v in c.items() if v}
        print(f"[slice7] {' '.join(argv)}{' (STREAM)' if stream else ''}: "
              f"rc={rc} iters={it} converged={conv} ms/iter={ms:.5f} "
              f"final_explicit_f64={final:.6e} command_s={secs:.2f} "
              f"launches={counts}")
        ok = (rc == 0 and (iters is None or it == iters) and it > 0
              and len(hist) >= 2 and math.isfinite(hist[0])
              and (want is None or c[want] > 0))
        if iters is not None:
            ok = ok and math.isfinite(final)
        if not ok:
            raise RuntimeError(f"[slice7] {label} failed its checks")
        if want == "stencil_gs_step_bf16diag":
            ok = ok and c["stencil_gs_step_box"] == c[want] and c[
                "stencil_gs_step_legs"] == 0
            launches["stencil_gs_step_bf16diag_by_route"] = {
                rt: c[f"stencil_gs_step_{rt}"] for rt in ("box", "legs")}
        if want == "lane_ell_spmv_bf16":
            ok = ok and c["lane_ell_spmv_idx16"] == (
                c[want] + c["lane_ell_spmv"])
            launches["lane_ell_spmv_bf16_by_route"] = {
                rt: c[f"lane_ell_spmv_{rt}"] for rt in ("idx16", "idx32")}
        if not ok:
            raise RuntimeError(f"[slice7] {label} left the idx16 route")
        if want is not None:
            launches[want] = c[want]
    f32, bf16 = hist384["cg@384 DIA f32"], hist384["cg@384 DIA bf16"]
    if not all(h[:-1] == f32[0][:-1] for h in f32 + bf16):
        raise RuntimeError("cg@384: the bf16 history differs from the f32 "
                           "one")
    print(f"[slice7] cg@384 DIA: the bf16 and f32 histories are equal, "
          f"{len(f32[0]) - 1} entries (the explicit final residual "
          f"f32={f32[0][-1]:.6e} bf16={bf16[0][-1]:.6e}); ms/iter in turns "
          f"f32={rows['cg@384 DIA f32']} bf16={rows['cg@384 DIA bf16']}")
    # --kernel-timers, fused: the device phase table from the profiler
    rc, out, err, secs = _cli(torch, bt, [MAIN_SPEC, "-cg",
                                          "--kernel-timers"])
    table = dict(re.findall(r"^\| \| (\w+) +([0-9.]+) s", err, re.M))
    wall = re.search(r"solve \(device wall\) +([0-9.]+) s", err)
    it = _cli_report(out, err)[0]
    print(f"[slice7] {MAIN_SPEC} -cg --kernel-timers (fused), {it} "
          f"iterations: device wall {wall and wall.group(1)} s, phase "
          f"table (s) {table}, ms/iter "
          f"{ {k: round(1e3 * float(v) / it, 5) for k, v in table.items()} } "
          f"command_s={secs:.2f}")
    if not (rc == 0 and float(table.get("spmv", 0)) > 0):
        raise RuntimeError("--kernel-timers: no spmv time in the device "
                           "phase table:\n" + err[-2000:])
    rc, out, err, secs = _cli(torch, bt, [MAIN_SPEC, "-cg",
                                          "--kernel-timers", "--harness",
                                          "host"])
    table = dict(re.findall(r"^\|[| ]*?(\w+) +([0-9.]+) s \|", err, re.M))
    print(f"[slice7] {MAIN_SPEC} -cg --kernel-timers --harness host, "
          f"{_cli_report(out, err)[0]} iterations: stopwatch table (s) "
          f"{table} command_s={secs:.2f}")
    # unpreconditioned CG: its p·Ap dot is fused into the SpMV's call
    if not (rc == 0 and {"spmv", "norm", "sum"} <= set(table)):
        raise RuntimeError("--kernel-timers --harness host: rows missing")
    if not _iter_times_check(torch, bt):
        raise RuntimeError("--iter-times/--profile failed (the [slice7] "
                           "line above says why)")
    return launches, rows


def phase_entry_point(torch):
    """One `python -m basic_iterative_solvers_tpu_torch hpcg:32x32x32 -cg`
    on the card in a subprocess: exit 0, "converged in:", and no jax in
    its sys.modules."""
    import sys
    code = ("import runpy, sys; sys.argv = ['x', 'hpcg:32x32x32', '-cg']\n"
            "try:\n"
            "    runpy.run_module('basic_iterative_solvers_tpu_torch', "
            "run_name='__main__')\n"
            "finally:\n"
            "    print('jax imported:', 'jax' in sys.modules)\n")
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    m = re.search(r"converged in: (\d+) iterations", out.stdout)
    print(f"[entry-point] python -m basic_iterative_solvers_tpu_torch "
          f"hpcg:32x32x32 -cg: rc={out.returncode} iters="
          f"{m.group(1) if m else None} "
          f"{'jax imported: False' in out.stdout and 'no jax' or 'JAX'} "
          f"seconds={time.perf_counter() - t0:.2f}")
    if not (out.returncode == 0 and m
            and "jax imported: False" in out.stdout):
        raise RuntimeError("the module entry point failed:\n"
                           + out.stdout[-1500:] + out.stderr[-1500:])


# ---------------------------------------------------------------------------
# Slice 8: the row-sharded mesh, an 8-shard mesh on the one card
# ---------------------------------------------------------------------------

MESH_SHARDS = 8


def _mesh_counters(bt, reset=False):
    """The launch counts of the four shard-local kernels, f32/f64 forms,
    and of each lane-ELL route (`reset`: every count, bf16 forms too, set
    to 0 first)."""
    from basic_iterative_solvers_tpu_torch.ops import dia_spmv, lane_ell
    so = bt.stencil_op
    fns = {"stencil_spmv_halo": so.stencil_spmv_halo,
           "stencil_gs_step_halo": so.stencil_gs_color_step_halo,
           "dia_spmv_halo": dia_spmv.dia_spmv_halo,
           "lane_ell_spmv_halo": lane_ell.lane_ell_spmv_halo}
    halo = lane_ell.lane_ell_spmv_halo
    if reset:
        for fn in fns.values():
            fn.launches = fn.bf16_launches = 0
        for route in lane_ell.HALO_ROUTES:
            setattr(halo, f"{route}_launches", 0)
    gs, sp = so.stencil_gs_color_step_halo, so.stencil_spmv_halo
    if reset:
        gs.box_launches = gs.legs_launches = 0
        sp.box_launches = sp.legs_launches = 0
    out = {name: fn.launches for name, fn in fns.items()}
    out.update({f"lane_ell_spmv_halo_{route}": getattr(halo,
                                                       f"{route}_launches")
                for route in lane_ell.HALO_ROUTES})
    for name, fn in (("stencil_gs_step_halo", gs), ("stencil_spmv_halo", sp)):
        out.update({f"{name}_{rt}": getattr(fn, f"{rt}_launches")
                    for rt in ("box", "legs")})
    return out


@contextlib.contextmanager
def _route_recorded(module, picker, picked):
    """Inside the block every call of `module.picker` adds the route it
    returns to the Counter `picked` (the picker itself decides)."""
    saved = getattr(module, picker)

    def recorded(*args, **kwargs):
        route = saved(*args, **kwargs)
        picked[route] += 1
        return route
    setattr(module, picker, recorded)
    try:
        yield
    finally:
        setattr(module, picker, saved)


def _shards_vs_plain(torch, tag, label, launch, plain, counter, attr, tol,
                     exact, timed):
    """Every shard's kernel call launch(k) against its plain twin
    plain(k): one launch a shard counted, the outputs (y, then its
    dots) bit-equal where `exact`, else within tol of max|y| (a dot: of
    Σ|terms|, given by plain's third item).  With `timed`, the 8 launches
    of one mesh call timed together, beside the 8 plain twins.  Returns
    (kernel outputs, max_abs_err, ms, plain_ms)."""
    before = getattr(counter, attr)
    outs = [launch(k) for k in range(MESH_SHARDS)]
    torch.cuda.synchronize()
    if getattr(counter, attr) != before + MESH_SHARDS:
        raise RuntimeError(f"{tag} {label}: the launch count did not grow "
                           "by one a shard")
    err, worst = 0.0, 0.0
    for k, out in enumerate(outs):
        ref = plain(k)
        out = out if isinstance(out, tuple) else (out,)
        y_p, dot_p, scale = ref if isinstance(ref, tuple) else (ref, (), ())
        e = float((out[0] - y_p).abs().max())
        err = max(err, e)
        if exact and not torch.equal(out[0], y_p):
            raise RuntimeError(f"{tag} {label}: shard {k} differs from its "
                               "plain twin")
        worst = max(worst, e / (float(y_p.abs().max()) or 1.0))
        for d_k, d_p, sc in zip(out[1:], dot_p, scale):
            worst = max(worst, abs(float(d_k - d_p)) / (sc or 1.0))
    if worst > tol:
        raise RuntimeError(f"{tag} {label}: a shard disagrees with its "
                           f"plain twin beyond {tol} ({worst:.3e})")
    ms = plain_ms = None
    if timed:
        ms = _device_ms(lambda: [launch(k) for k in range(MESH_SHARDS)],
                        torch)
        plain_ms = _median_ms(lambda: [plain(k) for k in range(MESH_SHARDS)],
                              torch, reps=5, batch=2)
    return outs, err, ms, plain_ms


#: the order #1's shard form is timed in: its kernels alone (bound
#: launches) on the legs and box routes, then through the wrapper
HALO_TURNS = ("legs", "box", "box", "legs", "legs_wrapper", "box_wrapper",
              "box_wrapper", "legs_wrapper")


def _route_fns(bound, wrapped):
    """{route: fn} for HALO_TURNS: bound(rt) the launch() callables of a
    route's launches, made once; wrapped(rt) a call through the
    wrapper."""
    fns = {}
    for rt in ("box", "legs"):
        launches = bound(rt)
        fns[rt] = lambda launches=launches: [f() for f in launches]
        fns[f"{rt}_wrapper"] = lambda rt=rt: wrapped(rt)
    return fns


def phase_mesh_kernel_vs_plain(torch, bt, sband):
    """[mesh-kernel]: the four shard-local kernels on an 8-shard mesh on
    the card, each shard against its plain twin on its own window (#4 and
    #5 bit for bit, #1 and #3 within TOL: their plain versions sum leg by
    leg), and the shards' y concatenated against the single-device kernel
    on the whole vector, bit for bit, in every type each takes: #1 at
    128^3 with every dot kind (f32, f64; Anderson 128^3's bf16
    diagonal and f64), #3 on every colour of fdm:2048 (f32, f64; Anderson
    bf16) and of HPCG 128^3 (f32, on the 27-point windows' box route),
    #4 at 128^3 (f32, f64, bf16 data), #5 on sband:500000,8,400 (f32,
    f64, bf16 values).  #1 runs on the mesh's line-aligned windows, on the
    route `halo_route_for` names (every launch counted there) and on both
    routes forced, y bit-equal across them, each type's 8 launches timed
    on both in turns (HALO_TURNS), and (f32, f64) one launch over the
    whole grid's window (the GSPMD mode at world size 1) on both in
    turns; the bound counts the rounded windows.  #3 at HPCG 128^3 f32 on
    both routes in turns.  Timed (f32): the 8 launches of one mesh
    call and the single-device kernel by their device time (_device_ms:
    the host's launch cost hidden behind a sleeping kernel), the plain
    twins, the whole mesh call (exchange and host work included) and the
    library's CSR SpMV by CUDA events; the bound counts the windows' halo
    rows.  #5
    on every route of its shard form (the launch shape's, by
    lane_ell.halo_route_for; counted; padded with 16-bit and int32
    indices), timed in turns beside 8 CSR SpMVs over the shards' rows.
    Returns the four records."""
    import dataclasses
    from basic_iterative_solvers_tpu_torch.coloring import spec_for_device
    from basic_iterative_solvers_tpu_torch.ops import dia_spmv as ds
    from basic_iterative_solvers_tpu_torch.ops import lane_ell as le
    from basic_iterative_solvers_tpu_torch.stencil_op import sm_count
    from basic_iterative_solvers_tpu_torch.parallel import make_mesh
    from basic_iterative_solvers_tpu_torch.parallel import mesh_ops as mo
    from basic_iterative_solvers_tpu_torch.parallel.sharded import (
        _halo, _halo_exchange, _split)
    so = bt.stencil_op
    mesh = make_mesh(MESH_SHARDS, device="cuda")
    records = {}

    def pad(v, npad):
        return torch.nn.functional.pad(v, (0, npad - v.numel()))

    def windows(x, npad, hneg, hpos):
        return _halo_exchange(mesh, _split(pad(x, npad), MESH_SHARDS), hneg,
                              hpos)

    def rnd(n, dt, seed):
        return torch.randn(n, dtype=dt, device="cuda",
                           generator=torch.Generator(
                               device="cuda").manual_seed(seed))

    def window_bytes(wins, item):
        return sum(w.numel() for w in wins) * item

    # #1: the stencil SpMV's shard form, on the mesh's line-aligned
    # windows: the picker's route and both routes forced
    M_csr, lib_x = None, None
    by_type = {}
    for spec, dt, md in ((MAIN_SPEC, torch.float32, torch.float32),
                         (MAIN_SPEC, torch.float64, torch.float64),
                         (ANDERSON_128, torch.float32, torch.bfloat16),
                         (ANDERSON_128, torch.float64, torch.float64)):
        A = so.from_source_operator(spec, md, device="cuda")
        W = mo.wrap_stencil(dataclasses.replace(A, shards=MESH_SHARDS), mesh,
                            "rows")
        R, n, item = W.rows, A.n_rows, torch.empty((), dtype=dt
                                                    ).element_size()
        hw = A.window_halo
        x, aux = rnd(n, dt, 21), rnd(n, dt, 22)
        wins = windows(x, MESH_SHARDS * R, *hw)
        auxs = _split(pad(aux, MESH_SHARDS * R), MESH_SHARDS)
        diags = W.diag_shards or (None,) * MESH_SHARDS
        attr = "bf16_launches" if md == torch.bfloat16 else "launches"
        tol = TOL[str(dt).split(".")[1]]
        label = (f"#1 {spec} {str(dt)[6:]}"
                 f"{' bf16-diag' if md == torch.bfloat16 else ''}")
        dot_sets = (((), ("x",), ("self",), ("aux",)) if spec == MAIN_SPEC
                    else ((), ("x",)))
        for dots in dot_sets:
            main = (spec, md, dots) == (MAIN_SPEC, torch.float32, ("x",))
            ys = _split(torch.empty(MESH_SHARDS * R, dtype=dt,
                                    device="cuda"), MESH_SHARDS)

            def launch(k, dots=dots, ys=ys):
                return so.stencil_spmv_halo(A, wins[k], k * R, dots, auxs[k],
                                            diags[k], out=ys[k])

            def on_route(route, dots=dots):
                return [so._stencil_spmv_halo_cuda(
                    A, wins[k], k * R, R, dots, auxs[k], diags[k], None,
                    route=route) for k in range(MESH_SHARDS)]

            def plain(k, dots=dots):
                out = so.stencil_spmv_halo_plain(A, wins[k], k * R, dots,
                                                 auxs[k], diags[k])
                if not dots:
                    return out
                partner = {"x": wins[k][hw[0]:hw[0] + R],
                           "self": out[0], "aux": auxs[k]}
                return (out[0], out[1:],
                        [float((out[0] * partner[d]).abs().sum())
                         for d in dots])

            picked = so.halo_route_for(
                A, wins[0], auxs[0] if "aux" in dots else None, diags[0],
                ys[0])
            before = so.stencil_spmv_halo.box_launches
            outs, err, _ms, _pms = _shards_vs_plain(
                torch, "mesh-kernel", f"{label} dots={','.join(dots) or '-'}",
                launch, plain, so.stencil_spmv_halo, attr, tol, False, False)
            on_box = so.stencil_spmv_halo.box_launches - before
            if on_box != (MESH_SHARDS if picked == "box" else 0):
                raise RuntimeError(f"{label}: a shard launch left the "
                                   f"picker's {picked} route")
            ys_of = lambda o: [t[0] if dots else t for t in o]  # noqa: E731
            routes = {rt: on_route(rt) for rt in ("box", "legs")}
            single = so._stencil_spmv_cuda(A, x, dots, aux)
            single = single if dots else (single,)
            for rt, r_outs in routes.items():
                if not all(torch.equal(a, b) for a, b in
                           zip(ys_of(r_outs), ys_of(outs))):
                    raise RuntimeError(f"{label} {dots}: the {rt} route's y "
                                       "differs from the picker's route's")
                for k, o in enumerate(r_outs if dots else ()):
                    _y, dot_p, scale = plain(k)
                    for d_k, d_p, sc in zip(o[1:], dot_p, scale):
                        if abs(float(d_k - d_p)) > tol * (sc or 1.0):
                            raise RuntimeError(f"{label} {dots}: a dot of "
                                               f"the {rt} route disagrees "
                                               "with its plain twin")
            y8 = torch.cat(ys_of(outs))[:n]
            if not torch.equal(y8, single[0]):
                raise RuntimeError(f"#1 halo {spec} {dt} {dots}: the shards' "
                                   "y differs from the single-device "
                                   "kernel's")
            for j, kind in enumerate(dots):
                tot = sum(float(o[1 + j]) for o in outs)
                partner = {"x": x, "self": single[0], "aux": aux}[kind]
                sc = float((single[0] * partner).abs().sum())
                if abs(tot - float(single[1 + j])) > tol * sc:
                    raise RuntimeError(f"#1 halo dot {kind} disagrees with "
                                       "the single-device kernel's")
            print(f"[mesh-kernel] {label} dots={','.join(dots) or '-'} "
                  f"rows/shard={R} halo={A.halo} window halo={hw}: the "
                  f"picker's route {picked}; y on the box and legs routes "
                  f"bit-equal to each other and to the single-device "
                  f"kernel, max_abs_err_vs_plain={err:.3e}")
            if dots != ("x",):
                continue
            # each type's 8 shard launches on both routes, in turns: the
            # kernels alone (bound launches), then through the wrapper
            # (each shard's partials summed by one more launch)
            turns = _in_turns(torch, _route_fns(
                lambda rt, dots=dots: [so._bind_spmv_halo(
                    A, wins[k], k * R, R, dots, auxs[k], diags[k], None,
                    rt)[0] for k in range(MESH_SHARDS)], on_route),
                HALO_TURNS, sleep_cycles=100_000_000)
            by_type[label[3:]] = {"picked": picked, **{
                f"{name}_ms": t for name, t in turns.items()}}
            print(f"[mesh-kernel] {label} y·x: 8 shard launches device ms "
                  f"in turns ({', '.join(HALO_TURNS)}; the kernels alone, "
                  f"then through the wrapper with each shard's partials "
                  f"summed) {turns}; the picker's route {picked}")
            if spec == MAIN_SPEC:
                # the GSPMD mode at world size 1: one launch over the whole
                # grid from its window
                xw1 = torch.nn.functional.pad(x, hw)

                def whole(rt, dots=dots, xw1=xw1):
                    return so._stencil_spmv_halo_cuda(
                        A, xw1, 0, n, dots, None, None, None, route=rt)
                if not all(torch.equal(whole(rt)[0], single[0])
                           for rt in ("box", "legs")):
                    raise RuntimeError("#1 halo: the one-window launch "
                                       "differs from the single-device "
                                       "kernel")
                one = _in_turns(torch, _route_fns(
                    lambda rt, dots=dots, xw1=xw1: [so._bind_spmv_halo(
                        A, xw1, 0, n, dots, None, None, None, rt)[0]],
                    whole), HALO_TURNS)
                by_type[label[3:]]["gspmd1"] = one
                print(f"[mesh-kernel] {label} y·x: one launch over the whole "
                      f"grid's window (GSPMD, world size 1) device ms in "
                      f"turns {one}; the picker's route "
                      f"{so.halo_route_for(A, xw1)}")
            if main:
                plain_ms = _median_ms(lambda: [plain(k) for k in range(
                    MESH_SHARDS)], torch, reps=5, batch=2)
                single_ms = _device_ms(
                    lambda: so._stencil_spmv_cuda(A, x, dots, aux), torch)
                x8 = mesh.scatter(x, R)
                call_ms = _median_ms(lambda: mo.mesh_stencil_spmv(W, x8, dots),
                                     torch)
                M_csr = _stencil_csr(torch, A)
                lib_ms = _median_ms(lambda: M_csr @ x, torch)
                lib_x = x
                nnz = int(M_csr.values().numel())
                bound = _bound(window_bytes(wins, item) + n * item,
                               2 * nnz - n + 2 * n)
                bound1 = _bound((xw1.numel() + n) * item,
                                2 * nnz - n + 2 * n)
                ms = min(turns[picked])
                print(f"[mesh-kernel] #1 {spec} f32 y·x: 8 shard launches "
                      f"ms={ms:.5f} on the {picked} route, the kernels "
                      f"alone (through the wrapper "
                      f"{min(turns[picked + '_wrapper']):.5f}; legs "
                      f"{min(turns['legs']):.5f}, through the wrapper "
                      f"{min(turns['legs_wrapper']):.5f}; plain twins "
                      f"{plain_ms:.4f}; the single-device kernel "
                      f"{single_ms:.5f}; the whole mesh SpMV with its "
                      f"exchange {call_ms:.4f}; CSR SpMV {lib_ms:.4f}) "
                      f"bound_ms={bound['bound_ms']:.5f} "
                      f"({bound['bound_by']}, line-aligned windows "
                      f"{window_bytes(wins, item) / 1e6:.2f} MB); one "
                      f"launch over the whole grid's window (GSPMD, world "
                      f"size 1) bound_ms={bound1['bound_ms']:.5f}")
                records["stencil_spmv_halo"] = {
                    "max_abs_err": err, "ms": ms,
                    "legs_ms": min(turns["legs"]),
                    "wrapper_ms": min(turns[picked + "_wrapper"]),
                    "wrapper_legs_ms": min(turns["legs_wrapper"]),
                    "plain_ms": plain_ms,
                    "library_ms": lib_ms, "single_ms": single_ms,
                    "call_ms": call_ms,
                    "gspmd1_ms": min(one[so.halo_route_for(A, xw1)]),
                    "gspmd1_legs_ms": min(one["legs"]),
                    "gspmd1_bound_ms": bound1["bound_ms"], **bound}
        del A, W, wins, auxs, x, aux
    records["stencil_spmv_halo"]["by_type"] = by_type
    # #3: the GS colour step's shard form
    for spec, dt, md in (("fdm:2048", torch.float32, torch.float32),
                         ("fdm:2048", torch.float64, torch.float64),
                         (ANDERSON_128, torch.float32, torch.bfloat16),
                         (MAIN_SPEC, torch.float32, torch.float32)):
        A = so.from_source_operator(spec, md, device="cuda")
        W = mo.wrap_stencil(dataclasses.replace(A, shards=MESH_SHARDS), mesh,
                            "rows")
        R, n, item = W.rows, A.n_rows, torch.empty((), dtype=dt
                                                    ).element_size()
        cs = spec_for_device(A)
        x, rhs = rnd(n, dt, 23), rnd(n, dt, 24)
        dinv = (1.0 / so.stencil_diag(A)).to(dt)
        wins = windows(x, MESH_SHARDS * R, *A.window_halo)
        rhss = _split(pad(rhs, MESH_SHARDS * R), MESH_SHARDS)
        dinvs = _split(pad(dinv, MESH_SHARDS * R), MESH_SHARDS)
        diags = W.diag_shards or (None,) * MESH_SHARDS
        attr = "bf16_launches" if md == torch.bfloat16 else "launches"
        colors = (range(cs.n_colors) if md != torch.bfloat16 else (0,))
        for c in colors:
            main = (dt, c) == (torch.float32, 0) and spec == "fdm:2048"

            def launch(k, c=c):
                return so.stencil_gs_color_step_halo(
                    A, wins[k], k * R, rhss[k], dinvs[k], cs, c, diags[k])

            def plain(k, c=c):
                return so.stencil_gs_color_step_halo_plain(
                    A, wins[k], k * R, rhss[k], dinvs[k], cs, c, diags[k])

            halo = so.stencil_gs_color_step_halo
            box_before = halo.box_launches
            outs, err, ms, plain_ms = _shards_vs_plain(
                torch, "mesh-kernel", f"#3 {spec} {str(dt)[6:]} colour {c}",
                launch, plain, halo, attr, TOL[str(dt).split(".")[1]], False,
                False)
            if halo.box_launches != box_before + MESH_SHARDS:
                raise RuntimeError(f"#3 halo {spec} {dt}: a shard launch "
                                   "left the box route")

            def legs(k, c=c):
                return so._stencil_gs_color_step_halo_cuda(
                    A, wins[k], k * R, R, rhss[k], dinvs[k], cs, c, diags[k],
                    None, route="legs")
            single = so.stencil_gs_color_step(A, x, rhs, dinv, cs, c)
            if not (torch.equal(torch.cat(outs)[:n], single) and all(
                    torch.equal(outs[k], legs(k))
                    for k in range(MESH_SHARDS))):
                raise RuntimeError(f"#3 halo {spec} {dt} colour {c}: the "
                                   "shards differ from the single-device "
                                   "kernel or from the leg loop")
            print(f"[mesh-kernel] #3 {spec} {str(dt)[6:]} "
                  f"{'bf16-diag ' if md == torch.bfloat16 else ''}{cs.kind} "
                  f"colour {c}/{cs.n_colors} rows/shard={R}: x' on the box "
                  f"route bit-equal to the leg loop and to the "
                  f"single-device kernel, max_abs_err_vs_plain={err:.3e}")
            if main:
                # a batch enqueues 80 shard launches through the wrapper
                # (~10 ms of host): behind _device_ms's default ~50 ms sleep
                turns = _in_turns(torch, {
                    "box": lambda: [launch(k) for k in range(MESH_SHARDS)],
                    "legs": lambda: [legs(k) for k in range(MESH_SHARDS)]},
                    ("box", "legs", "legs", "box"), sleep_cycles=100_000_000)
                ms = min(turns["box"])
                plain_ms = _median_ms(lambda: [plain(k) for k in range(
                    MESH_SHARDS)], torch, reps=5, batch=2)
                single_ms = _device_ms(lambda: so.stencil_gs_color_step(
                    A, x, rhs, dinv, cs, 0), torch)
                x8, rhs8, dinv8 = (mesh.scatter(v, R) for v in (x, rhs, dinv))
                call_ms = _median_ms(lambda: mo.mesh_gs_color_step(
                    W, x8, rhs8, dinv8, cs, 0), torch)
                n_c = n // cs.n_colors
                bound = _bound(window_bytes(wins, item)
                               + item * (n + 2 * n_c),
                               n_c * (2 * len(A.legs) + 2))
                sector = _bound(window_bytes(wins, item) + item * 3 * n,
                                n_c * (2 * len(A.legs) + 2))
                print(f"[mesh-kernel] #3 {spec} f32 colour 0: 8 shard "
                      f"launches device ms in turns box={turns['box']} "
                      f"legs={turns['legs']} (plain twins {plain_ms:.4f}; "
                      f"single-device {single_ms:.4f}; the whole mesh step "
                      f"{call_ms:.4f}) bound_ms={bound['bound_ms']:.5f} "
                      f"({bound['bound_by']}; coloured rows) "
                      f"sector_bound_ms={sector['bound_ms']:.5f}")
                records["stencil_gs_step_halo"] = {
                    "max_abs_err": err, "ms": ms,
                    "legs_ms": min(turns["legs"]), "plain_ms": plain_ms,
                    "library_ms": None, "single_ms": single_ms,
                    "call_ms": call_ms,
                    "sector_bound_ms": sector["bound_ms"], **bound}
            elif spec == MAIN_SPEC and c == 0:
                # the 27-point windows, line-aligned: #3's box route
                turns = _in_turns(torch, {
                    "box": lambda: [launch(k) for k in range(MESH_SHARDS)],
                    "legs": lambda: [legs(k) for k in range(MESH_SHARDS)]},
                    ("box", "legs", "legs", "box"), sleep_cycles=100_000_000)
                records["stencil_gs_step_halo"]["hpcg"] = {
                    f"{rt}_ms": min(t) for rt, t in turns.items()}
                print(f"[mesh-kernel] #3 {spec} f32 colour 0 (window halo "
                      f"{A.window_halo}): 8 shard launches device ms in "
                      f"turns box={turns['box']} legs={turns['legs']}")
        del A, W, wins, rhss, dinvs, x, rhs, dinv
    torch.cuda.empty_cache()
    # #4: the DIA SpMV's shard form
    for dt, md in ((torch.float32, torch.float32),
                   (torch.float64, torch.float64),
                   (torch.float32, torch.bfloat16)):
        A = bt.dia.from_source_device(MAIN_SPEC, md, device="cuda")
        W = mo.wrap_dia(A, mesh, "rows")
        R, n = W.rows, A.n_rows
        item = torch.empty((), dtype=dt).element_size()
        hneg, hpos = _halo(A.offsets)
        x = rnd(n, dt, 25) if dt != torch.float32 or lib_x is None else lib_x
        wins = windows(x, MESH_SHARDS * R, hneg, hpos)
        attr = "bf16_launches" if md == torch.bfloat16 else "launches"
        main = md == torch.float32
        outs, err, ms, plain_ms = _shards_vs_plain(
            torch, "mesh-kernel", f"#4 {MAIN_SPEC} {str(md)[6:]}",
            lambda k: ds.dia_spmv_halo(W.data_shards[k], A.offsets, wins[k],
                                       hneg),
            lambda k: ds.dia_spmv_halo_plain(W.data_shards[k], A.offsets,
                                             wins[k], hneg),
            ds.dia_spmv_halo, attr, 0.0, True, main)
        if not torch.equal(torch.cat(outs)[:n], ds.dia_spmv(A, x)):
            raise RuntimeError(f"#4 halo {md}: the shards differ from the "
                               "single-device kernel")
        print(f"[mesh-kernel] #4 {MAIN_SPEC} {str(md)[6:]} data, "
              f"{str(dt)[6:]} x, rows/shard={R}: bit-equal to plain and to "
              f"the single-device kernel")
        if main:
            single_ms = _device_ms(lambda: ds.dia_spmv(A, x), torch)
            x8 = mesh.scatter(x, R)
            call_ms = _median_ms(lambda: mo.mesh_dia_spmv(W, x8), torch)
            lib_ms = _median_ms(lambda: M_csr @ x, torch)
            k = len(A.offsets)
            bound = _bound(k * MESH_SHARDS * R * item
                           + window_bytes(wins, item) + n * item, 2 * k * n)
            print(f"[mesh-kernel] #4 {MAIN_SPEC} f32: 8 shard launches "
                  f"ms={ms:.4f} (plain twins {plain_ms:.4f}; single-device "
                  f"{single_ms:.4f}; the whole mesh SpMV {call_ms:.4f}; CSR "
                  f"SpMV {lib_ms:.4f}) bound_ms={bound['bound_ms']:.4f} "
                  f"({bound['bound_by']})")
            records["dia_spmv_halo"] = {
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "library_ms": lib_ms, "single_ms": single_ms,
                "call_ms": call_ms, **bound}
        del A, W, wins, outs
        torch.cuda.empty_cache()
    del M_csr
    # #5: the lane-ELL SpMV's shard form
    C = _csr_on_card(torch, sband, torch.float32)
    for dt, md in ((torch.float32, torch.float32),
                   (torch.float64, torch.float64),
                   (torch.float32, torch.bfloat16)):
        M = bt.from_csr(sband, md, "lane_ell", device="cuda")
        W = mo.wrap_lane_ell(M, mesh, "rows")
        E, R, n = W.inner, W.rows, M.n_rows
        item = torch.empty((), dtype=dt).element_size()
        h = E.S * le.LANES
        x = rnd(n, dt, 26)
        wins = windows(x, E.R * le.LANES, h, h)
        attr = "bf16_launches" if md == torch.bfloat16 else "launches"
        main = md == torch.float32

        # the shards' int32 planes, the first port's index width
        idx32 = [E.idx[:, k * R:(k + 1) * R].contiguous()
                 for k in range(MESH_SHARDS)]
        variants = {"counted": ("counted", W.idx_shards),
                    "padded": ("padded", W.idx_shards),
                    "padded32": ("padded", idx32)}

        def shard(k, variant, E=E, W=W, wins=wins, R=R, variants=variants):
            route, planes = variants[variant]
            return le._lane_ell_spmv_halo_cuda(
                E, W.vals_shards[k], planes[k], wins[k], k * R, E.S, None,
                route)

        route = le.halo_route_for(R * le.LANES, sm_count(0))
        before = getattr(le.lane_ell_spmv_halo, f"{route}_launches")
        outs, err, ms, plain_ms = _shards_vs_plain(
            torch, "mesh-kernel", f"#5 {SBAND} {str(md)[6:]}",
            lambda k, E=E, W=W, wins=wins, R=R: le.lane_ell_spmv_halo(
                E, W.vals_shards[k], W.idx_shards[k], wins[k], k * R, E.S),
            lambda k, E=E, W=W, wins=wins, R=R: le.lane_ell_spmv_halo_plain(
                E, W.vals_shards[k], W.idx_shards[k], wins[k], k * R, E.S),
            le.lane_ell_spmv_halo, attr, 0.0, True, False)
        if getattr(le.lane_ell_spmv_halo,
                   f"{route}_launches") != before + MESH_SHARDS:
            raise RuntimeError(f"#5 halo: the shards did not take the shape's "
                               f"{route} route")
        single = le.lane_ell_spmv(M, x)
        if not torch.equal(torch.cat(outs)[:n], single):
            raise RuntimeError(f"#5 halo {md}: the shards differ from the "
                               "single-device kernel")
        for variant in variants:
            other = [shard(k, variant) for k in range(MESH_SHARDS)]
            if not all(torch.equal(a, b) for a, b in zip(other, outs)):
                raise RuntimeError(f"#5 halo {md}: the {variant} shards "
                                   "differ from the plain twins")
        print(f"[mesh-kernel] #5 {SBAND} {str(md)[6:]} values, "
              f"{str(dt)[6:]} x, K={E.K} S={E.S} x2-rows/shard={R}, "
              f"{W.idx_shards[0].dtype} shard indices, the shape's route "
              f"{route}: bit-equal to plain and to the single-device "
              "kernel; the counted and padded routes, 16-bit and int32 "
              "indices, bit-equal to them")
        if main:
            order = ("padded32", "padded", "counted", "counted", "padded",
                     "padded32")
            turns = _in_turns(torch, {
                v: lambda v=v: [shard(k, v) for k in range(MESH_SHARDS)]
                for v in variants}, order)
            ms = min(turns[route])
            plain_ms = _median_ms(lambda: [
                le.lane_ell_spmv_halo_plain(E, W.vals_shards[k],
                                            W.idx_shards[k], wins[k], k * R,
                                            E.S)
                for k in range(MESH_SHARDS)], torch, reps=5, batch=2)
            single_ms = _device_ms(lambda: le.lane_ell_spmv(M, x), torch)
            x8 = mesh.scatter(x, W.blocks.rows)
            call_ms = _median_ms(lambda: mo.mesh_lane_ell_spmv(W, x8), torch)
            lib_ms = _device_ms(lambda: C @ x, torch)
            # like for like: 8 CSR SpMVs, each over one shard's rows
            rows_k = R * le.LANES
            parts = []
            for k in range(MESH_SHARDS):
                lo, hi = min(k * rows_k, n), min((k + 1) * rows_k, n)
                if hi > lo:
                    ptr = sband.row_ptr[lo:hi + 1]
                    parts.append(torch.sparse_csr_tensor(
                        torch.from_numpy(ptr - ptr[0]).cuda(),
                        torch.from_numpy(sband.col[ptr[0]:ptr[-1]]
                                         .astype("int64")).cuda(),
                        torch.from_numpy(sband.val[ptr[0]:ptr[-1]]).to(
                            dtype=dt, device="cuda"), (hi - lo, n)))
            y8 = torch.cat([P @ x for P in parts])
            lib_rel = float((y8 - single).abs().max() / single.abs().max())
            if not lib_rel <= TOL["float32"]:
                raise RuntimeError("the per-shard CSR SpMVs disagree")
            lib8_ms = _device_ms(lambda: [P @ x for P in parts], torch)
            padded, counted, slots, _w = _lane_ell_bytes(torch, E, item, 2)
            xwin = window_bytes(wins, item) - n * item   # x: the windows
            bound = _bound(counted + xwin, 2 * slots)
            pad_bound = _bound(padded + xwin, 2 * E.K * n)
            pad16_bound = _bound(padded - 2 * E.K * n + xwin, 2 * E.K * n)
            print(f"[mesh-kernel] #5 {SBAND} f32: 8 shard launches device "
                  f"ms in turns ({', '.join(order)}; padded32: int32 "
                  f"indices, the first port's kernel; the shape's route "
                  f"{route}): "
                  f"{turns} "
                  f"(plain twins {plain_ms:.4f}; single-device "
                  f"{single_ms:.4f}; the whole mesh SpMV {call_ms:.4f}; "
                  f"{len(parts)} CSR SpMVs over the shards' rows "
                  f"{lib8_ms:.4f}, max_rel_err {lib_rel:.1e}; one whole CSR "
                  f"SpMV {lib_ms:.4f}) bound_ms={bound['bound_ms']:.4f} "
                  f"({bound['bound_by']}: the real slots, the counts, the "
                  f"windows, y; every slot with 16-bit indices "
                  f"{pad16_bound['bound_ms']:.4f}, with int32 "
                  f"{pad_bound['bound_ms']:.4f})")
            records["lane_ell_spmv_halo"] = {
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "library_ms": lib8_ms, "whole_library_ms": lib_ms,
                "single_ms": single_ms, "call_ms": call_ms,
                "counted_ms": min(turns["counted"]),
                "padded_ms": min(turns["padded"]),
                "padded32_ms": min(turns["padded32"]),
                "padded_bound_ms": pad16_bound["bound_ms"],
                "padded32_bound_ms": pad_bound["bound_ms"], **bound}
            del parts
        del M, W, E, wins, outs
    del C
    torch.cuda.empty_cache()
    return records


#: the depth of slice 8's stencil and DIA CG rows at 128^3 (the bench's
#: 2500 cut: the mesh rows are host work whose ms/iter a few hundred
#: iterations show)
SLICE8_CG_ITERS = 500


def phase_slice8(torch, bt, sband):
    """[slice8]: the slice's rows on an 8-shard mesh on the card, f32,
    fused, tolerance 0, b = 2, x0 = 1, single-device and mesh in turns
    (single, mesh, mesh, single), each after a warm-up solve with every
    count set to 0 just before the timed solve and read just after: CG on
    the HPCG 128^3 stencil (2500 iterations), DIA CG at 128^3 (2500),
    cg@sband on lane-ELL (400), SGS on fdm:2048 (200, the coloured sweeps
    through #3's shard form); ms/iter, launches and the mesh's exchanges
    and bytes an iteration.  cg@sband also runs the mesh with #5's shard
    launches forced onto the counted route, in turns with the launch
    shape's route (single, mesh, mesh_counted, mesh_counted, mesh,
    single).  Then f64 CG + Jacobi to 1e-8·||r0|| at 128^3,
    mesh against single-device (equal counts, histories within rtol
    1e-8), and one step and a solve of the standalone distributed CG
    (make_sharded_cg, the JAX package's dryrun_multichip's first stage)
    on the DIA 128^3 matrix.  Returns each halo kernel's launches in its
    first mesh row and the rows' numbers."""
    import collections
    import math
    import numpy as np
    from basic_iterative_solvers_tpu_torch.ops import lane_ell as le
    from basic_iterative_solvers_tpu_torch.ops.blas1 import full_value
    from basic_iterative_solvers_tpu_torch.parallel import (
        make_mesh, make_sharded_cg, mesh_census, shard_setup)
    from basic_iterative_solvers_tpu_torch.solvers import make_method
    from basic_iterative_solvers_tpu_torch.stencil_op import sm_count
    S = bt.SolverType
    mesh = make_mesh(MESH_SHARDS, device="cuda")

    def dia_cg():
        A = bt.dia.from_source_device(MAIN_SPEC, torch.float32,
                                      device="cuda")
        n = A.n_rows
        return bt.preprocessing_device(
            A, bt.SolverConfig(dtype=torch.float32, harness="fused",
                               tolerance=0.0, max_iters=SLICE8_CG_ITERS,
                               breakdown_stall=True),
            b=torch.full((n,), 2.0, device="cuda"),
            x0=torch.full((n,), 1.0, device="cuda"))

    rows = (("cg", f"{MAIN_SPEC} f32 CG (stencil)", SLICE8_CG_ITERS,
             "stencil_spmv_halo",
             lambda: _hpcg_cg(torch, bt, MAIN_SPEC, torch.float32,
                              max_iters=SLICE8_CG_ITERS, tolerance=0.0,
                              breakdown_stall=True)),
            ("dia_cg", f"{MAIN_SPEC} f32 DIA CG", SLICE8_CG_ITERS,
             "dia_spmv_halo", dia_cg),
            ("cg@sband", f"{SBAND} f32 cg@sband lane_ell", 400,
             "lane_ell_spmv_halo",
             lambda: _host_solve(torch, bt, sband, "cuda", torch.float32,
                                 "CONJUGATE_GRADIENT",
                                 matrix_format="lane_ell", tolerance=0.0,
                                 max_iters=400, breakdown_stall=True)[0]),
            ("sgs@fdm2048", "fdm:2048 f32 SGS (masked sweeps)", 200,
             "stencil_gs_step_halo",
             lambda: _setup(torch, bt, "fdm:2048", torch.float32, "cuda",
                            S.SYMMETRIC_GAUSS_SEIDEL, max_iters=200,
                            tolerance=0.0)))
    launches, numbers = {}, {}
    for name, label, iters, kernel, make in rows:
        torch.cuda.empty_cache()
        s1 = make()
        s8 = shard_setup(s1, mesh, mode="shard_map")   # s1 stays as it is
        if s8.gs_L_block is not None or s1.gs_L_block is not None:
            raise RuntimeError(f"{label} took the superblock route")
        m1, m8 = make_method(s1), make_method(s8)
        bt.solve(s1, method=m1)                       # warm-up solves
        bt.solve(s8, method=m8)
        lane = kernel == "lane_ell_spmv_halo"
        gs = kernel == "stencil_gs_step_halo"
        spmv = kernel == "stencil_spmv_halo"
        # cg@sband: the mesh also with every shard launch on #5's counted
        # route, in turns with the launch shape's route; sgs@fdm2048: with
        # #3's shard launches on the leg loop, in turns with its box route
        order = (("single", "mesh", "mesh_counted", "mesh_counted", "mesh",
                  "single") if lane else
                 ("single", "mesh", "mesh_legs", "mesh_legs", "mesh",
                  "single") if gs else ("single", "mesh", "mesh", "single"))
        shape_route = (le.halo_route_for(s8.A.rows * le.LANES, sm_count(0))
                       if lane else None)
        ms = {which: [] for which in order}
        for which in order:
            setup, method = (s1, m1) if which == "single" else (s8, m8)
            _mesh_counters(bt, reset=True)
            _sparse_counters(bt, reset=True)
            bt.stencil_op.stencil_gs_color_step.launches = 0
            mesh.reset_counts()
            picked = collections.Counter()
            with _route_forced(le, "halo_route_for",
                               "counted" if which == "mesh_counted"
                               else None), \
                    _route_forced(bt.stencil_op, "gs_halo_route_for",
                                  "legs" if which == "mesh_legs" else None), \
                    _route_recorded(bt.stencil_op, "halo_route_for", picked):
                res = bt.solve(setup, method=method)
            counts = _mesh_counters(bt)
            single = _sparse_counters(bt)
            single["stencil_gs_color_step"] = (
                bt.stencil_op.stencil_gs_color_step.launches)
            exch = dict(mesh.counts)
            it = max(1, res.iter_count)
            ms[which].append(1e3 * res.solve_seconds / it)
            ok = (res.iter_count == iters
                  and math.isfinite(res.final_residual_norm)
                  and bool(torch.isfinite(res.x_star).all()))
            if which != "single":
                ok = ok and counts[kernel] >= MESH_SHARDS * iters
                ok = ok and exch["psum_bytes"] <= 8 * 3 * 8 * exch["psum"]
                ok = ok and exch["gather"] == 0
            if which == "mesh":
                launches.setdefault(kernel, counts[kernel])
            if gs and which != "single":
                want = "legs" if which == "mesh_legs" else "box"
                ok = ok and counts[f"stencil_gs_step_halo_{want}"] == counts[
                    kernel]
                if which == "mesh":
                    launches.setdefault("stencil_gs_step_halo_by_route", {
                        rt: counts[f"stencil_gs_step_halo_{rt}"]
                        for rt in ("box", "legs")})
            if spmv and which != "single":
                # every #1 shard launch on the route its picker named, and
                # that the box route: 128^3 f32 on aligned windows
                ok = ok and all(counts[f"stencil_spmv_halo_{rt}"] ==
                                picked[rt] for rt in ("box", "legs"))
                ok = ok and sum(picked.values()) == counts[kernel]
                ok = ok and counts["stencil_spmv_halo_legs"] == 0
                if which == "mesh":
                    launches.setdefault("stencil_spmv_halo_by_route", {
                        rt: counts[f"stencil_spmv_halo_{rt}"]
                        for rt in ("box", "legs")})
            if lane and which != "single":
                want = "counted" if which == "mesh_counted" else shape_route
                ok = ok and counts[f"lane_ell_spmv_halo_{want}"] == counts[
                    kernel]
                if which == "mesh":
                    launches.setdefault("lane_ell_spmv_halo_by_route", {
                        rt: counts[f"lane_ell_spmv_halo_{rt}"]
                        for rt in le.HALO_ROUTES})
            if which == "single":
                ok = ok and not any(counts.values())
                if gs:
                    ok = ok and single["stencil_gs_color_step"] >= 4 * iters
            per = {k: round(v / it, 3) for k, v in
                   ({**counts, **single} if which != "single" else single)
                   .items() if v}
            print(f"[slice8] {label} {which}: iters={res.iter_count} "
                  f"ms/iter={ms[which][-1]:.5f} r0={res.residual_norms[0]:.6e}"
                  f" final_explicit_f64={res.final_residual_norm:.6e} "
                  f"launches/iter={per}"
                  + (f" exchanges/iter: ppermute="
                     f"{exch['ppermute'] / it:.3f} "
                     f"({exch['ppermute_bytes'] / it / 1e6:.4f} MB) psum="
                     f"{exch['psum'] / it:.3f} ({exch['psum_bytes'] / it:.1f}"
                     f" B) gather={exch['gather'] / it:.3f}"
                     if which != "single" else "")
                  + (f" #5 halo route {shape_route} (the launch shape's)"
                     if which == "mesh" and lane else "")
                  + (f" #1 halo launches by route (the picker's: "
                     f"{dict(picked)}) box={counts['stencil_spmv_halo_box']}"
                     f" legs={counts['stencil_spmv_halo_legs']}"
                     if which != "single" and spmv else ""))
            if not ok:
                raise RuntimeError(f"[slice8] {label} {which} failed its "
                                   "checks")
        _print_census("slice8", label, mesh_census(s8))
        print(f"[slice8] {label}: ms/iter in turns single={ms['single']} "
              f"mesh={ms['mesh']} (per-card vector storage, "
              f"{MESH_SHARDS} shards on one card)")
        numbers[name] = ms
        del s1, s8, m1, m8

    # f64 CG + Jacobi to 1e-8 on the mesh and on one device
    res = {}
    for which in ("single", "mesh"):
        setup = _hpcg_cg(torch, bt, MAIN_SPEC, torch.float64,
                         preconditioner=bt.PrecondType.JACOBI,
                         tolerance=1e-8, max_iters=2000)
        if which == "mesh":
            setup = shard_setup(setup, mesh, mode="shard_map")
        res[which] = bt.solve(setup)
    r1, r8 = res["single"], res["mesh"]
    dev = float(np.max(np.abs(r8.residual_norms[:-1] - r1.residual_norms[:-1])
                       / r1.residual_norms[:-1])) \
        if len(r8.residual_norms) == len(r1.residual_norms) else float("inf")
    print(f"[slice8] {MAIN_SPEC} f64 CG + Jacobi to 1e-8: iters "
          f"single={r1.iter_count} mesh={r8.iter_count} max rel history "
          f"difference {dev:.3e}; final explicit single="
          f"{r1.final_residual_norm:.6e} mesh={r8.final_residual_norm:.6e}")
    if not (r1.converged and r8.converged and r1.iter_count == r8.iter_count
            and dev <= 1e-8):
        raise RuntimeError("the f64 mesh solve differs from the "
                           "single-device solve")

    # the standalone distributed CG on the DIA 128^3 matrix
    from basic_iterative_solvers_tpu_torch.dia import dia_diag
    from basic_iterative_solvers_tpu_torch.ops.dia_spmv import dia_spmv
    for dt in (torch.float32, torch.float64):
        A = bt.dia.from_source_device(MAIN_SPEC, dt, device="cuda")
        n = A.n_rows
        x_star = torch.linspace(0.0, 1.0, n, dtype=dt, device="cuda")
        b = dia_spmv(A, x_star)
        cg = make_sharded_cg(A, b, mesh, D_inv=1.0 / dia_diag(A))
        state = cg.init_state(cg.b * 0.0)
        step = cg.step_fn()
        r0 = float(state["residual_norm"])
        mesh.reset_counts()
        t0 = time.perf_counter()
        state = step(state)
        r1n = float(state["residual_norm"])
        if dt == torch.float32:
            print(f"[slice8] make_sharded_cg {MAIN_SPEC} f32 DIA + Jacobi: "
                  f"one distributed step ||r0||={r0:.6e} ||r1||={r1n:.6e} "
                  f"npad={cg.npad} exchanges={mesh.counts}")
            if not (math.isfinite(r1n) and r1n > 0.0):
                raise RuntimeError("the distributed CG step failed")
            continue
        it = 1
        while r1n > 1e-8 * r0 and it < 2000:
            state = step(state)
            r1n = float(state["residual_norm"])
            it += 1
        secs = time.perf_counter() - t0
        ref = bt.solve(bt.preprocessing_device(
            A, bt.SolverConfig(dtype=dt, harness="host", tolerance=1e-8,
                               preconditioner=bt.PrecondType.JACOBI,
                               max_iters=2000),
            b=b, x0=torch.zeros(n, dtype=dt, device="cuda")))
        err = float((full_value(state["x"])[:n] - x_star).abs().max())
        print(f"[slice8] make_sharded_cg {MAIN_SPEC} f64 DIA + Jacobi to "
              f"1e-8: iters={it} (single-device CG + Jacobi "
              f"{ref.iter_count}) ms/iter={1e3 * secs / it:.3f} "
              f"max|x - x*|={err:.3e}")
        if it != ref.iter_count or not err < 1e-5:
            raise RuntimeError("the distributed CG solve differs from the "
                               "single-device solve")
        del A, cg, state, b, x_star
    torch.cuda.empty_cache()
    return launches, numbers


GSPMD_CG_ITERS = 300
#: a lane-ELL matrix whose rows fill whole x2-rows on one rank (#5's halo
#: form; sband:500000 takes the gather form)
GSPMD_SBAND = "sband:524288,8,400"


def _history_dev(got, ref, floor=0.0):
    """max relative difference of two residual histories over the entries
    where ref's norm is above floor·ref[0] (the final explicit norm left
    out); inf when their lengths differ."""
    got, ref = got[:-1], ref[:-1]
    if len(got) != len(ref):
        return float("inf")
    keep = ref > floor * ref[0]
    return float((abs(got[keep] - ref[keep]) / ref[keep]).max())


def _print_census(phase, label, c):
    """Print a mesh census (parallel/census.mesh_census) and raise where
    its loop gathers or scatters a vector whole."""
    print(f"[{phase}] {label}: mesh census an iteration {c['in_while']}, "
          f"full gathers and scatters {c['full_gathers']}")
    if (c["in_while"]["all-gather"] or c["in_while"]["scatter"]
            or c["full_gathers"]):
        raise RuntimeError(f"[{phase}] {label}: the mesh loop gathers or "
                           "scatters a vector whole")


def phase_gspmd(torch, bt):
    """[gspmd]: the GSPMD mode on one card: NCCL initialised in this
    process at world size 1 (a HashStore), `make_device_mesh()` on cuda:0.
    CG on the HPCG 128^3 stencil, f32, fused, tolerance 0, b = 2, x0 = 1
    (GSPMD_CG_ITERS), single-device, 8-shard shard_map mesh and GSPMD in
    turns (single, mesh, gspmd, gspmd, mesh, single), every count set to 0
    just before each timed solve and read just after: ms/iter, equal
    counts, the f32 histories where above 1e-3·||r0||, #1's halo form
    launched on every GSPMD iteration and the single-device kernels never.
    f64 CG + Jacobi to 1e-8·||r0|| at 128^3, GSPMD against single-device
    (equal counts, histories within [slice8]'s 1e-8).  GSPMD rows of the
    other halo forms: DIA CG at 128^3 (#4), SGS on fdm:2048 (#3's, the
    masked sweeps), CG on GSPMD_SBAND in lane-ELL (#5), each against the
    same setup's single-device solve (equal counts, histories within 1e-3
    where above 1e-3·||r0||, the final x's difference).  The census of the
    GSPMD CG on the card.  One card measures no communication: every
    number here is host and DTensor dispatch at world size 1.  Returns
    each halo form's launches in its GSPMD row and the CG row's ms/iter."""
    import collections
    import math
    import numpy as np
    import torch.distributed as dist
    from basic_iterative_solvers_tpu_torch.ops.blas1 import full_value
    from basic_iterative_solvers_tpu_torch.parallel import (
        fused_collective_census, make_device_mesh, make_mesh, shard_setup)
    from basic_iterative_solvers_tpu_torch.solvers import make_method
    S = bt.SolverType
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        dmesh = make_device_mesh()
        mesh8 = make_mesh(MESH_SHARDS, device="cuda")
        print(f"[gspmd] DeviceMesh {dmesh.device_type} x{dmesh.size()} "
              f"({dist.get_backend()}, world size {dist.get_world_size()})")
        iters = GSPMD_CG_ITERS
        s1 = _hpcg_cg(torch, bt, MAIN_SPEC, torch.float32, max_iters=iters,
                      tolerance=0.0, breakdown_stall=True)
        setups = {"single": s1,
                  "mesh": shard_setup(s1, mesh8, mode="shard_map"),
                  "gspmd": shard_setup(s1, dmesh, mode="gspmd")}
        if type(setups["gspmd"].A).__name__ != "DistStencil":
            raise RuntimeError("[gspmd] the setup took no DTensor operator")
        methods = {k: make_method(v) for k, v in setups.items()}
        for k in setups:                          # warm-up solves
            bt.solve(setups[k], method=methods[k])
        ms, hist, launches = {k: [] for k in setups}, {}, {}
        for which in ("single", "mesh", "gspmd", "gspmd", "mesh",
                      "single"):
            _mesh_counters(bt, reset=True)
            _sparse_counters(bt, reset=True)
            picked = collections.Counter()
            with _route_recorded(bt.stencil_op, "halo_route_for", picked):
                res = bt.solve(setups[which], method=methods[which])
            counts = _mesh_counters(bt)
            single = _sparse_counters(bt)
            it = max(1, res.iter_count)
            ms[which].append(1e3 * res.solve_seconds / it)
            hist[which] = res.residual_norms
            x = full_value(res.x_star)
            ok = (res.iter_count == iters
                  and math.isfinite(res.final_residual_norm)
                  and bool(torch.isfinite(x).all()))
            if which == "gspmd":
                ok = ok and counts["stencil_spmv_halo"] >= iters
                ok = ok and single["stencil_spmv"] == 0
                launches.setdefault("stencil_spmv_halo",
                                    counts["stencil_spmv_halo"])
            if which != "single":
                # every #1 shard launch on the route its picker named, and
                # that the box route: 128^3 f32 on aligned windows
                ok = ok and sum(picked.values()) == counts[
                    "stencil_spmv_halo"] and all(
                    counts[f"stencil_spmv_halo_{rt}"] == picked[rt]
                    for rt in ("box", "legs"))
                ok = ok and counts["stencil_spmv_halo_legs"] == 0
            per = {k: round(v / it, 3) for k, v in {**counts, **single}
                   .items() if v}
            print(f"[gspmd] {MAIN_SPEC} f32 CG {which}: iters="
                  f"{res.iter_count} ms/iter={ms[which][-1]:.5f} "
                  f"r0={res.residual_norms[0]:.6e} final_explicit_f64="
                  f"{res.final_residual_norm:.6e} launches/iter={per}"
                  + (f" #1 halo launches by route (the picker's: "
                     f"{dict(picked)}) box={counts['stencil_spmv_halo_box']}"
                     f" legs={counts['stencil_spmv_halo_legs']}"
                     if which != "single" else ""))
            if not ok:
                raise RuntimeError(f"[gspmd] {MAIN_SPEC} f32 CG {which} "
                                   "failed its checks")
        dev = _history_dev(hist["gspmd"], hist["single"], 1e-3)
        print(f"[gspmd] {MAIN_SPEC} f32 CG: ms/iter in turns single="
              f"{ms['single']} mesh={ms['mesh']} gspmd={ms['gspmd']}; max "
              f"rel history difference gspmd vs single above 1e-3·||r0|| "
              f"{dev:.3e}")
        if not dev <= 1e-3:
            raise RuntimeError("[gspmd] the f32 GSPMD history differs from "
                               "the single-device one")
        c = fused_collective_census(setups["gspmd"])
        print(f"[gspmd] census of the GSPMD CG on the card (world size 1): "
              f"{json.dumps(c)}")
        if c["full_gathers"] or c["in_while"]["all-gather"] \
                or c["in_while"]["all-to-all"]:
            raise RuntimeError("[gspmd] the GSPMD CG gathers a full vector")
        del setups, methods, s1

        # f64 CG + Jacobi to 1e-8 on the DeviceMesh and on one device
        res = {}
        for which in ("single", "gspmd"):
            setup = _hpcg_cg(torch, bt, MAIN_SPEC, torch.float64,
                             preconditioner=bt.PrecondType.JACOBI,
                             tolerance=1e-8, max_iters=2000)
            if which == "gspmd":
                setup = shard_setup(setup, dmesh, mode="gspmd")
            res[which] = bt.solve(setup)
        r1, rg = res["single"], res["gspmd"]
        dev = _history_dev(rg.residual_norms, r1.residual_norms)
        print(f"[gspmd] {MAIN_SPEC} f64 CG + Jacobi to 1e-8: iters "
              f"single={r1.iter_count} gspmd={rg.iter_count} max rel history "
              f"difference {dev:.3e}; final explicit single="
              f"{r1.final_residual_norm:.6e} gspmd="
              f"{rg.final_residual_norm:.6e}")
        if not (r1.converged and rg.converged
                and r1.iter_count == rg.iter_count and dev <= 1e-8):
            raise RuntimeError("[gspmd] the f64 GSPMD solve differs from "
                               "the single-device solve")
        del res, r1, rg, setup

        # the other halo forms' GSPMD rows
        def dia_cg():
            A = bt.dia.from_source_device(MAIN_SPEC, torch.float32,
                                          device="cuda")
            n = A.n_rows
            return bt.preprocessing_device(
                A, bt.SolverConfig(dtype=torch.float32, harness="fused",
                                   tolerance=0.0, max_iters=100,
                                   breakdown_stall=True),
                b=torch.full((n,), 2.0, device="cuda"),
                x0=torch.full((n,), 1.0, device="cuda"))

        def sband_cg():
            A = bt.generators.from_source(GSPMD_SBAND)
            return _host_solve(torch, bt, A, "cuda", torch.float32,
                               "CONJUGATE_GRADIENT",
                               matrix_format="lane_ell", tolerance=0.0,
                               max_iters=100, breakdown_stall=True)[0]

        rows = (("dia_spmv_halo", f"{MAIN_SPEC} f32 DIA CG", 100, dia_cg),
                ("stencil_gs_step_halo", "fdm:2048 f32 SGS (masked sweeps)",
                 20, lambda: _setup(torch, bt, "fdm:2048", torch.float32,
                                    "cuda", S.SYMMETRIC_GAUSS_SEIDEL,
                                    max_iters=20, tolerance=0.0)),
                ("lane_ell_spmv_halo", f"{GSPMD_SBAND} f32 CG lane_ell", 100,
                 sband_cg))
        for kernel, label, n_it, make in rows:
            torch.cuda.empty_cache()
            s1 = make()
            r1 = bt.solve(s1)                     # the single-device solve
            sg = shard_setup(s1, dmesh, mode="gspmd")
            if sg.gs_L_block is not None:
                raise RuntimeError(f"[gspmd] {label} took the superblock "
                                   "route")
            m = make_method(sg)
            bt.solve(sg, method=m)                # warm-up solve
            _mesh_counters(bt, reset=True)
            _sparse_counters(bt, reset=True)
            bt.stencil_op.stencil_gs_color_step.launches = 0
            r = bt.solve(sg, method=m)
            counts = _mesh_counters(bt)
            single = _sparse_counters(bt)
            single["stencil_gs_color_step"] = (
                bt.stencil_op.stencil_gs_color_step.launches)
            it = max(1, r.iter_count)
            per = {k: round(v / it, 3) for k, v in {**counts, **single}
                   .items() if v}
            dev = _history_dev(r.residual_norms, r1.residual_norms, 1e-3)
            x1 = r1.x_star.double()
            dx = float((full_value(r.x_star).double() - x1).abs().max()
                       / x1.abs().max())
            print(f"[gspmd] {label} gspmd: iters={r.iter_count} ms/iter="
                  f"{1e3 * r.solve_seconds / it:.5f} final_explicit_f64="
                  f"{r.final_residual_norm:.6e} launches/iter={per}; "
                  f"single-device iters={r1.iter_count} final_explicit_f64="
                  f"{r1.final_residual_norm:.6e}, max rel history difference "
                  f"above 1e-3·||r0|| {dev:.3e}, max |x - x_single| / "
                  f"max |x_single| {dx:.3e}")
            if not (r.iter_count == n_it and counts[kernel] >= n_it
                    and math.isfinite(r.final_residual_norm)
                    and not any(single.values())
                    and r1.iter_count == r.iter_count and dev <= 1e-3):
                raise RuntimeError(f"[gspmd] {label} failed its checks")
            launches[kernel] = counts[kernel]
            del s1, r1, sg, m, r
        torch.cuda.empty_cache()
        return launches, ms
    finally:
        dist.destroy_process_group()


def _mesh_level_work(MB, li, itemsize, single_work):
    """(bytes, operations) of one level on the mesh, each shard counted as
    _level_work and _plane_level_work count one device: y read and x
    written on its rows of the level's superblock; x read once on each
    line of a source superblock that one of its cross legs (plane groups)
    reaches from those rows, its own lines and the in-grid halo lines (a
    line near a seam counted by both shards that read it); its plane
    values and per-row 1/D on its rows; and the factor-table values the
    single-device level reads.  Operations: the single-device level's
    (single_work: its (bytes, operations), whose byte count less its
    vector rows is its table reads)."""
    import numpy as np
    B = MB.inner
    nx, ny, nz, sx, sy, sz = B.spec_params
    sb, cross, _selfs = B.levels[li]
    my = ny // sy
    n_src = len({src for src, _d in cross})
    table = (single_work[0] // itemsize - B.m * (2 + n_src)
             if B.is_table else 0)
    values = table
    for Bs in MB.shards:
        l0, l1 = Bs.lines[li]
        if l1 == l0:
            continue
        t = np.arange(l0, l1)
        src_lines = set()
        if B.is_plane:
            for src, delta in cross:
                q = delta // nx
                for dl in ((q,) if delta % nx == 0 else (q, q + 1)):
                    ls = t + dl
                    ls = ls[(ls >= 0) & (ls < B.m // nx)]
                    src_lines.update((sy * (ls % my) + src % sy + ny * (
                        sz * (ls // my) + src // sy)).tolist())
        else:
            gy, gz = sy * (t % my) + sb % sy, sz * (t // my) + sb // sy
            for _f, dx, dy, dz in (B.table_cross[li] if B.is_table
                                   else B.const_cross[li]):
                ok = ((gy + dy >= 0) & (gy + dy < ny) & (gz + dz >= 0)
                      & (gz + dz < nz))
                if abs(dx) < nx:
                    src_lines.update(((gy + dy) + ny * (gz + dz))[ok]
                                     .tolist())
        groups = 0
        if B.is_plane:
            groups = sum(v.shape[0] for v in (Bs.vals_cross[li],
                                              Bs.vals_self[li])
                         if v is not None)
        per_row = 0 if B.is_table or Bs.dinv_rows is None else 1
        values += (nx * len(src_lines)
                   + (l1 - l0) * nx * (2 + groups + per_row))
    return values * itemsize, single_work[1]


def phase_mesh_super_level(torch, bt, setup5b, library):
    """[mesh-super-level]: kernel #9's mesh form on an 8-shard mesh on the
    card, every level of L and U in each mode: const (the 128^3 GS pair),
    factor table (the 128^3 ILU(0) pair) and plane (the fdm:2048 ILU(0)
    pair from host CSR: L plane, U const with a per-row D), f32 and f64 (the
    plane pair widened); each shard's launch on each route of its mode
    (_routes_of) bit-equal to its plain twin on the same window, the
    shards' rows together bit-equal to the single-device kernel's level.
    Timed (f32; the last L level of each mode and the fdm:2048 pair's U
    levels): the 8 launches on both routes in turns by device time
    (_in_turns), the single-device level, the plain twins, the whole mesh
    level with its exchange, and the whole solve of the triangle on the
    mesh and on one device, L's beside torch.triangular_solve's
    (`library`, measured earlier in this run).  Returns the const mode's
    record (every timed level's in by_mode)."""
    from basic_iterative_solvers_tpu_torch.coloring import spec_for_device
    from basic_iterative_solvers_tpu_torch.ops import block_trisolve as bk
    from basic_iterative_solvers_tpu_torch.parallel import make_mesh
    mesh = make_mesh(MESH_SHARDS, device="cuda")
    counter = bk.super_level_halo
    records = {}

    def pairs(mode, dt):
        if mode == "plane":
            L, U = setup5b.M.L_block, setup5b.M.U_block
            return (L, U) if dt == torch.float32 else (_widen(L, torch),
                                                       _widen(U, torch))
        A = bt.stencil_op.from_source_operator(MAIN_SPEC, dt, device="cuda")
        if mode == "const":
            return bk.build_superblock_gs_pair_stencil(
                A, spec_for_device(A), dtype=dt, need_d=True)
        return bk.build_superblock_ilu0_pair_stencil(A, spec_for_device(A),
                                                     dtype=dt)

    for mode, spec in (("const", MAIN_SPEC), ("table", MAIN_SPEC),
                       ("plane", FDM_5B)):
        for dt in (torch.float32, torch.float64):
            L, U = pairs(mode, dt)
            item = torch.empty((), dtype=dt).element_size()
            g = torch.Generator(device="cuda").manual_seed(31)
            for tri, B in (("L", L), ("U", U)):
                MB = bk.shard_superblock(B, mesh)
                n, R, H = B.n_rows, MB.rows, MB.halo
                pad = MESH_SHARDS * R - n
                attr = ("table_launches" if B.is_table else "plane_launches"
                        if B.is_plane else "launches")
                err = 0.0
                for li in range(len(B.levels)):
                    y = torch.randn(n, dtype=dt, device="cuda", generator=g)
                    x = torch.randn(n, dtype=dt, device="cuda", generator=g)
                    single = bk.super_level(B, li, y, x.clone())
                    xw = torch.nn.functional.pad(x, (H, pad + H))
                    ys = [v.clone() for v in torch.nn.functional.pad(
                        y, (0, pad)).split(R)]
                    wins = [xw[k * R:(k + 1) * R + 2 * H].clone()
                            for k in range(MESH_SHARDS)]
                    twins = [bk.super_level_halo_plain(
                        Bs, li, ys[k], wins[k].clone())
                        for k, Bs in enumerate(MB.shards)]
                    owners = sum(1 for Bs in MB.shards
                                 if Bs.lines[li][1] > Bs.lines[li][0])
                    # each route of the mode forced in turn (float64
                    # factor-table levels have only the direct route)
                    routes = _routes_of(B, item)
                    forced = {rt: [w.clone() for w in wins] for rt in routes}
                    kind = ("table" if B.is_table else "plane"
                            if B.is_plane else "const")
                    before = getattr(counter, attr)
                    for k, Bs in enumerate(MB.shards):
                        bk.super_level_halo(Bs, li, ys[k], wins[k])
                    for rt, outs in forced.items():
                        by_rt = getattr(counter, f"{kind}_{rt}_launches")
                        with _on_route(rt, MB):
                            for k, Bs in enumerate(MB.shards):
                                bk.super_level_halo(Bs, li, ys[k], outs[k])
                        before += owners
                        if (getattr(counter, f"{kind}_{rt}_launches")
                                != by_rt + owners):
                            raise RuntimeError(f"[mesh-super-level] {mode} "
                                               f"{rt} count did not grow by "
                                               "one an owning shard")
                    torch.cuda.synchronize()
                    if getattr(counter, attr) != before + owners:
                        raise RuntimeError(f"[mesh-super-level] {mode} "
                                           "launch count did not grow by one "
                                           "an owning shard")
                    for k in range(MESH_SHARDS):
                        err = max(err, float((wins[k] - twins[k]).abs()
                                             .max()))
                        if not torch.equal(wins[k], twins[k]):
                            raise RuntimeError(
                                f"[mesh-super-level] {mode} {dt} {tri} "
                                f"level {li} shard {k} differs from its "
                                "plain twin")
                        for rt, outs in forced.items():
                            if not torch.equal(outs[k], wins[k]):
                                raise RuntimeError(
                                    f"[mesh-super-level] {dt} {tri} level "
                                    f"{li} shard {k}: the {rt} route "
                                    "differs")
                    own = torch.cat([w[H:H + R] for w in wins])[:n]
                    if not torch.equal(own, single):
                        raise RuntimeError(
                            f"[mesh-super-level] {mode} {dt} {tri} level "
                            f"{li}: the shards differ from the single-device "
                            "kernel")
                    # the last L level of each mode; the fdm:2048 pair's
                    # U levels too (const with a per-row D)
                    timed = dt == torch.float32 and (
                        li == len(B.levels) - 1 if tri == "L"
                        else mode == "plane")
                    if not timed:
                        continue

                    def shards(rt):
                        def run():
                            with _on_route(rt, MB):
                                return [bk.super_level_halo(
                                    Bs, li, ys[k], wins[k])
                                    for k, Bs in enumerate(MB.shards)]
                        return run
                    turns = _in_turns(torch, {rt: shards(rt)
                                              for rt in routes},
                                      ("direct", routes[0], routes[0],
                                       "direct"))
                    shard_route = bk.level_route_for(
                        B, li, item, MB.shards[0], y.device)
                    ms = min(turns[shard_route])
                    routes_text = (f" (the shards' route {shard_route};"
                                   f" both in turns: {turns})")
                    xs = x.clone()
                    single_ms = _device_ms(
                        lambda: bk.super_level(B, li, y, xs), torch)
                    plain_ms = _median_ms(lambda: [
                        bk.super_level_halo_plain(Bs, li, ys[k], wins[k])
                        for k, Bs in enumerate(MB.shards)], torch, reps=5,
                        batch=2)

                    def mesh_level():
                        for k, Bs in enumerate(MB.shards):
                            bk.super_level_halo(Bs, li, ys[k], wins[k])
                        bk._mesh_exchange(MB, li, wins)

                    call_ms = _median_ms(mesh_level, torch)
                    y8 = mesh.scatter(y, R)
                    solve_mesh_ms = _median_ms(
                        lambda: bk._solve_super_mesh(MB, y8), torch, reps=5)
                    out = torch.empty_like(y)
                    solve_ms = _median_ms(
                        lambda: bk._solve_super(B, y, out), torch, reps=5)
                    work = (_plane_level_work(B, li, item) if mode == "plane"
                            else _level_work(B, li, item))
                    bound = _bound(*_mesh_level_work(MB, li, item, work))
                    lib = library[mode] if tri == "L" else None
                    print(f"[mesh-super-level] {spec} f32 {_mode(B)} {tri} "
                          f"level {li} (superblock {B.levels[li][0]}, "
                          f"{len(B.levels[li][1])} cross groups) rows/shard="
                          f"{R} halo={H}: 8 shard launches ms={ms:.4f}"
                          f"{routes_text} "
                          f"(single-device level {single_ms:.4f}; plain "
                          f"twins {plain_ms:.4f}; the whole mesh level with "
                          f"its exchange {call_ms:.4f}) bound_ms="
                          f"{bound['bound_ms']:.5f} ({bound['bound_by']}); "
                          f"whole {tri} solve: mesh {solve_mesh_ms:.4f}, one "
                          f"device {solve_ms:.4f}"
                          + (f", torch.triangular_solve {lib:.4f} (measured "
                             "above)" if lib is not None else ""))
                    key = mode if tri == "L" else f"{_mode(B)} U level {li}"
                    records[key] = {
                        "max_abs_err": err, "ms": ms,
                        "direct_ms": min(turns["direct"]),
                        "plain_ms": plain_ms,
                        "library_ms": None, "single_ms": single_ms,
                        "call_ms": call_ms, "solve_mesh_ms": solve_mesh_ms,
                        "solve_ms": solve_ms,
                        "triangular_solve_ms": lib, **bound}
                print(f"[mesh-super-level] {spec} {str(dt)[6:]} {tri} "
                      f"({_mode(B)}, {len(B.levels)} levels) rows/shard={R} "
                      f"halo={H}: every shard bit-equal to its plain twin "
                      f"(max_abs_err {err:.1e}), the 8 shards bit-equal to "
                      "the single-device kernel"
                      + f"; the {' and '.join(routes)} routes' shards "
                      "bit-equal to them")
                del MB
            del L, U
            torch.cuda.empty_cache()
    rec = dict(records["const"])
    rec["by_mode"] = {m: {k: records[m][k] for k in
                          ("ms", "direct_ms", "single_ms", "plain_ms",
                           "call_ms", "bound_ms", "solve_mesh_ms", "solve_ms",
                           "triangular_solve_ms")} for m in records}
    return rec


#: [slice8b]'s f64 BiCGSTAB + SGS check: steps run, residuals held (r0
#: and the first two steps' norms), their rtol against one device
BICG_F64_STEPS, BICG_F64_HELD, BICG_F64_RTOL = 6, 3, 1e-8
#: [slice8b]: (row, the bench's iterations)
SLICE8B_ROWS = (("pcg", 300), ("pcg_ilu0", 300),
                ("pbicgstab@anderson128", 200), ("pcg_ilu0@fdm2048", 300))


def _slice8b_f64_prefix(torch, bt, mesh, name):
    """`name`'s first ten residuals in float64, the mesh against one
    device, within 1e-8 (the f64 mesh checks' tolerance), equal counts."""
    import numpy as np
    from basic_iterative_solvers_tpu_torch.parallel import shard_setup
    s1 = _colored_host_setup(torch, bt, FDM_5B, torch.float64,
                             "CONJUGATE_GRADIENT", "ILU0", max_iters=9,
                             tolerance=0.0, breakdown_stall=True)[0]
    r1 = bt.solve(s1)
    r8 = bt.solve(shard_setup(s1, mesh, mode="shard_map"))
    h1, h8 = (np.asarray(r.residual_norms[:10]) for r in (r1, r8))
    dev = (float(np.max(np.abs(h8 - h1) / h1)) if h1.shape == h8.shape
           else float("inf"))
    print(f"[slice8b] {name} f64: the mesh's first ten residuals against "
          f"the single-device solve's: max rel difference {dev:.3e} "
          f"(iters {r1.iter_count}, {r8.iter_count})")
    if not (r1.iter_count == r8.iter_count and dev <= 1e-8):
        raise RuntimeError(f"[slice8b] {name}: the f64 mesh history "
                           "departs from the single-device one")
    del s1, r1, r8
    torch.cuda.empty_cache()


def phase_slice8b(torch, bt, setup5b):
    """[slice8b]: the superblock rows on the 8-shard mesh on the card, f32,
    fused, tolerance 0, b = 2, x0 = 1, at full size: pcg (CG + SGS, const
    mode), pcg_ilu0 (factor table), pbicgstab@anderson128 (const mode with
    a per-row D from host CSR, the stencil injected) and pcg_ilu0@fdm2048
    (L plane, U const with a per-row D; phase 23's set-up), at
    SLICE8B_ROWS' iteration counts (a quarter of the bench's: the mesh
    rows are host work).  Single-device and mesh in turns (single, mesh,
    mesh, single), each after a warm-up solve, every count set to 0 just
    before the timed solve and read just after (pcg_ilu0@fdm2048 also on
    the direct route: the line route, the picker's, and the direct route
    on both, in turns): ms/iter, #9's launches by mode and route (the
    plane and const levels all on the forced route or on the one the
    picker names), the mesh's exchanges and bytes an iteration, peak
    memory, and the
    mesh's history against the single-device one (every row's first ten
    residuals within 1e-4: f32, the psum sums the dots per shard, the
    stencil's fused dots too, in float64 partials; and pcg_ilu0@fdm2048's
    also in f64 within 1e-8), and the mesh census.
    Then
    f64 CG + SGS at 128^3 to 1e-8·||r0|| on the mesh and on one device:
    equal counts, histories within rtol 1e-8; and f64 BiCGSTAB + SGS on
    anderson128, six steps on each, its first three residuals within rtol
    1e-8.  Returns each row's mesh #9 launches (by row) and the rows'
    numbers."""
    import math
    import numpy as np
    from basic_iterative_solvers_tpu_torch.ops import block_trisolve as bk
    from basic_iterative_solvers_tpu_torch.parallel import (make_mesh,
                                                            mesh_census,
                                                            shard_setup)
    from basic_iterative_solvers_tpu_torch.solvers import make_method
    S, P = bt.SolverType, bt.PrecondType
    mesh = make_mesh(MESH_SHARDS, device="cuda")
    halo = bk.super_level_halo
    modes = {"super_level_halo": "launches",
             "super_level_halo_table": "table_launches",
             "super_level_halo_plane": "plane_launches",
             **{f"super_level_halo_{k}_{rt}": f"{k}_{rt}_launches"
                for k, rts in (("table", ("staged", "direct")),
                               ("plane", ("line", "direct")),
                               ("const", ("line", "direct")))
                for rt in rts}}

    def counts(reset=False):
        out = _row_counts(bt, reset=reset)
        out.update(_mesh_counters(bt, reset=reset))
        for key, attr in modes.items():
            if reset:
                setattr(halo, attr, 0)
            out[key] = getattr(halo, attr)
        return out

    def stencil_row(precond, iters):
        return _setup(torch, bt, MAIN_SPEC, torch.float32, "cuda",
                      S.CONJUGATE_GRADIENT, preconditioner=P[precond],
                      max_iters=iters, tolerance=0.0, breakdown_stall=True)

    def anderson(iters):
        return _colored_host_setup(
            torch, bt, ANDERSON_128, torch.float32, "BICGSTAB",
            "SYMMETRIC_GAUSS_SEIDEL", stencil=True, max_iters=iters,
            tolerance=0.0, breakdown_stall=True)[0]

    makers = {"pcg": lambda it: stencil_row("SYMMETRIC_GAUSS_SEIDEL", it),
              "pcg_ilu0": lambda it: stencil_row("ILU0", it),
              "pbicgstab@anderson128": anderson,
              "pcg_ilu0@fdm2048": lambda it: dataclasses.replace(
                  setup5b, config=dataclasses.replace(setup5b.config,
                                                      max_iters=it))}
    launches, numbers = {}, {}
    for name, iters in SLICE8B_ROWS:
        torch.cuda.empty_cache()
        s1 = makers[name](iters)
        s8 = shard_setup(s1, mesh, mode="shard_map")
        L8, U8 = s8.M.L_block, s8.M.U_block
        if not (isinstance(L8, bk.MeshSuperBlockTriSolve)
                and isinstance(U8, bk.MeshSuperBlockTriSolve)):
            raise RuntimeError(f"[slice8b] {name}: the blocks did not shard")
        per_apply = {}
        for B8 in (L8, U8):
            key = ("super_level_halo_table" if B8.inner.is_table else
                   "super_level_halo_plane" if B8.inner.is_plane
                   else "super_level_halo")
            per_apply[key] = per_apply.get(key, 0) + sum(
                1 for Bs in B8.shards for l0, l1 in Bs.lines if l1 > l0)
        applies = 2 if name.startswith("pbicgstab") else 1
        m1, m8 = make_method(s1), make_method(s8)
        picked = {"single": _picked_routes(bk, 4, s1.M.L_block,
                                           s1.M.U_block),
                  "mesh": _picked_routes(bk, 4, L8, U8)}
        bt.solve(s1, method=m1)                              # warm-up solves
        bt.solve(dataclasses.replace(s8, config=dataclasses.replace(
            s8.config, max_iters=10)))
        # the fdm:2048 row also on the direct route: the four in turns
        order = (("single", "mesh", "mesh direct", "single direct",
                  "single direct", "mesh direct", "mesh", "single")
                 if name == "pcg_ilu0@fdm2048" else
                 ("single", "mesh", "mesh", "single"))
        ms = {which: [] for which in order}
        hist = {}
        for which in order:
            mesh_run = which.startswith("mesh")
            setup, method = (s8, m8) if mesh_run else (s1, m1)
            route = "direct" if which.endswith("direct") else None
            blocks = ((L8, U8) if mesh_run else (s1.M.L_block, s1.M.U_block))
            torch.cuda.reset_peak_memory_stats()
            counts(reset=True)
            mesh.reset_counts()
            with (_on_route(route, *blocks) if route
                  else contextlib.nullcontext()):
                res = bt.solve(setup, method=method)
            got = counts()
            # plane and const levels all on the forced route, or on the
            # one the picker names
            kind = "mesh" if mesh_run else "single"
            want = route or (next(iter(picked[kind]))
                             if len(picked[kind]) == 1 else None)
            exch = dict(mesh.counts)
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            it = max(1, res.iter_count)
            ms[which].append(1e3 * res.solve_seconds / it)
            hist[which] = np.asarray(res.residual_norms[:10])
            ok = (res.iter_count == iters
                  and math.isfinite(res.final_residual_norm)
                  and bool(torch.isfinite(res.x_star).all()))
            n_applies = applies * iters + 1
            if mesh_run:
                ok = ok and all(got[k] == v * n_applies
                                for k, v in per_apply.items())
                ok = ok and (got["super_level_halo_table_staged"]
                             + got["super_level_halo_table_direct"]
                             == got["super_level_halo_table"])
                ok = ok and not any(got[k] for k in ("super_level",
                                                     "super_level_table",
                                                     "super_level_plane"))
                if picked[kind] or route:
                    ok = ok and want is not None and _all_on_route(
                        got, want, "super_level_halo")
                if route is None:
                    launches.setdefault(name, {
                        k: got[k] for k in (*per_apply, *modes) if got[k]})
            else:
                ok = ok and not any(got[k] for k in modes)
                if picked[kind] or route:
                    ok = ok and want is not None and _all_on_route(got, want)
            per = {k: round(v / it, 3) for k, v in got.items() if v}
            print(f"[slice8b] {name} f32 {which}: iters={res.iter_count} "
                  f"ms/iter={ms[which][-1]:.5f} r0={res.residual_norms[0]:.6e}"
                  f" final_explicit_f64={res.final_residual_norm:.6e} "
                  f"peak_GB={peak_gb:.3f} launches/iter={per}"
                  + (f" exchanges/iter: ppermute={exch['ppermute'] / it:.3f}"
                     f" ({exch['ppermute_bytes'] / it / 1e6:.4f} MB) psum="
                     f"{exch['psum'] / it:.3f} ({exch['psum_bytes'] / it:.1f}"
                     " B)" if mesh_run else "")
                  + f" levels by the picker's route {picked[kind]}")
            if not ok:
                raise RuntimeError(f"[slice8b] {name} {which} failed its "
                                   f"checks: {got} against {per_apply} x "
                                   f"{n_applies}")
        h1, h8 = hist["single"], hist["mesh"]
        dev = float(np.max(np.abs(h8 - h1) / h1))
        print(f"[slice8b] {name}: the mesh's first ten residuals against "
              f"the single-device solve's: max rel difference {dev:.3e}")
        if not dev <= 1e-4:
            raise RuntimeError(f"[slice8b] {name}: the mesh's history "
                               "departs from the single-device one")
        if name == "pcg_ilu0@fdm2048":
            _slice8b_f64_prefix(torch, bt, mesh, name)
        _print_census("slice8b", name, mesh_census(s8))
        print(f"[slice8b] {name}: ms/iter in turns single={ms['single']} "
              f"mesh={ms['mesh']} (per-card vector storage, "
              f"{MESH_SHARDS} shards on one card)")
        numbers[name] = ms
        del s1, s8, m1, m8, L8, U8
    torch.cuda.empty_cache()

    # f64 CG + SGS to 1e-8 on the mesh and on one device
    res = {}
    for which in ("single", "mesh"):
        setup = _hpcg_cg(torch, bt, MAIN_SPEC, torch.float64,
                         preconditioner=P.SYMMETRIC_GAUSS_SEIDEL,
                         tolerance=1e-8, max_iters=1000)
        if which == "mesh":
            setup = shard_setup(setup, mesh, mode="shard_map")
        res[which] = bt.solve(setup)
    r1, r8 = res["single"], res["mesh"]
    h1, h8 = (np.asarray(r.residual_norms[:-1]) for r in (r1, r8))
    dev = (float(np.max(np.abs(h8 - h1) / h1)) if h1.shape == h8.shape
           else float("inf"))
    print(f"[slice8b] {MAIN_SPEC} f64 CG + SGS to 1e-8: iters "
          f"single={r1.iter_count} mesh={r8.iter_count} max rel history "
          f"difference {dev:.3e}; final explicit single="
          f"{r1.final_residual_norm:.6e} mesh={r8.final_residual_norm:.6e} "
          f"ms/iter single={1e3 * r1.solve_seconds / r1.iter_count:.4f} "
          f"mesh={1e3 * r8.solve_seconds / r8.iter_count:.4f}")
    if not (r1.converged and r8.converged and r1.iter_count == r8.iter_count
            and dev <= 1e-8):
        raise RuntimeError("the f64 mesh CG + SGS solve differs from the "
                           "single-device solve")
    torch.cuda.empty_cache()

    # f64 BiCGSTAB + SGS on anderson128: its first residuals on the mesh
    # and on one device (BiCGSTAB amplifies the psum's regrouping of the
    # dots, so only the first steps are held: ROADMAP queue 3)
    s1 = _colored_host_setup(
        torch, bt, ANDERSON_128, torch.float64, "BICGSTAB",
        "SYMMETRIC_GAUSS_SEIDEL", stencil=True, max_iters=BICG_F64_STEPS,
        tolerance=0.0, breakdown_stall=True)[0]
    h = {which: np.asarray(bt.solve(
        shard_setup(s1, mesh, mode="shard_map") if which == "mesh" else s1
    ).residual_norms) for which in ("single", "mesh")}
    rel = np.abs(h["mesh"] - h["single"]) / h["single"]
    print(f"[slice8b] pbicgstab@anderson128 f64, {BICG_F64_STEPS} steps: "
          "the mesh's residuals against the single-device solve's, rel "
          f"differences {np.array2string(rel, precision=2)} (the first "
          f"{BICG_F64_HELD} held within {BICG_F64_RTOL:.0e})")
    if not (len(h["mesh"]) == len(h["single"])
            and float(rel[:BICG_F64_HELD].max()) <= BICG_F64_RTOL):
        raise RuntimeError("the f64 mesh BiCGSTAB + SGS residuals depart "
                           "from the single-device solve's")
    del s1
    torch.cuda.empty_cache()
    return launches, numbers


#: [mesh-cards]' f32 rows: iterations of each (tolerance 0)
MESH_CARDS_ITERS = 100


def _on_cards(mesh, vectors=(), operators=()) -> int:
    """Check that every per-shard tensor of the MeshVectors `vectors` and
    of the mesh operators and superblock solves `operators` (their shard
    tuples, the superblock shards' tensors and exchange indices) lies on
    its shard's card; returns how many it checked."""
    import dataclasses
    import torch
    count = 0

    def check(t, k):
        nonlocal count
        if isinstance(t, torch.Tensor):
            if t.device != mesh.devices[k]:
                raise RuntimeError(f"[mesh-cards] shard {k}'s data lies on "
                                   f"{t.device}, not {mesh.devices[k]}")
            count += 1
        elif isinstance(t, (tuple, list)):
            for u in t:
                check(u, k)
        elif dataclasses.is_dataclass(t) and not isinstance(t, type):
            for f in dataclasses.fields(t):
                if f.name not in ("B", "inner", "_args"):
                    check(getattr(t, f.name), k)

    def per_shard(parts):
        if len(parts) != mesh.size:
            raise RuntimeError(f"[mesh-cards] {len(parts)} shard parts for "
                               f"{mesh.size} cards")
        for k, part in enumerate(parts):
            check(part, k)

    for v in vectors:
        if v is not None:
            per_shard(v.shards)
    for op in operators:
        if op is None:
            continue
        for name in ("ops", "diag_shards", "data_shards", "vals_shards",
                     "idx_shards", "len_shards", "shards"):
            if getattr(op, name, None):
                per_shard(getattr(op, name))
        for level in getattr(op, "exchange", ()):
            per_shard(level)
    return count


def _setup_on_cards(setup, mesh) -> int:
    """_on_cards over a mesh setup's vectors, operators and blocks."""
    M = setup.M
    return _on_cards(
        mesh, (setup.b, setup.x0, setup.A_D, setup.color_arr, M.A_D,
               M.A_D_inv, M.color_arr),
        (setup.A, M.L_strict_dev, M.U_strict_dev, M.A_full_dev, M.L_block,
         M.U_block))


def phase_mesh_cards(torch, bt):
    """[mesh-cards]: the shard_map mode on make_mesh() over every card,
    where there are two or more: CG on the 128^3 stencil, DIA CG at 128^3,
    SGS on fdm:2048 and pcg_ilu0 at 128^3 (f32, fused, tolerance 0,
    MESH_CARDS_ITERS iterations, b = 2, x0 = 1) against one device: equal
    counts, histories within [slice8]'s f32 1e-3 above 1e-3·||r0||, every
    shard's vectors and operator data on its card, x back on the cards, no
    vector gathered whole in the loop (the mesh census); then f64 CG +
    Jacobi at 128^3 to 1e-8 within [slice8]'s 1e-8 of one device.  With
    one card it says that it did not run."""
    count = torch.cuda.device_count()
    if count < 2:
        print(f"[mesh-cards] not run: {count} card")
        return None
    from basic_iterative_solvers_tpu_torch.parallel import (
        make_mesh, mesh_census, shard_setup)
    S, P = bt.SolverType, bt.PrecondType
    mesh = make_mesh()
    iters = MESH_CARDS_ITERS
    kw = dict(max_iters=iters, tolerance=0.0, breakdown_stall=True)

    def dia_cg():
        A = bt.dia.from_source_device(MAIN_SPEC, torch.float32,
                                      device="cuda")
        n = A.n_rows
        return bt.preprocessing_device(
            A, bt.SolverConfig(dtype=torch.float32, harness="fused", **kw),
            b=torch.full((n,), 2.0, device="cuda"),
            x0=torch.full((n,), 1.0, device="cuda"))

    rows = (("cg", lambda: _hpcg_cg(torch, bt, MAIN_SPEC, torch.float32,
                                    **kw)),
            ("dia_cg", dia_cg),
            ("sgs@fdm2048", lambda: _setup(
                torch, bt, "fdm:2048", torch.float32, "cuda",
                S.SYMMETRIC_GAUSS_SEIDEL, max_iters=iters, tolerance=0.0)),
            ("pcg_ilu0", lambda: _hpcg_cg(torch, bt, MAIN_SPEC, torch.float32,
                                          preconditioner=P.ILU0, **kw)))
    out = {}
    for name, make in rows:
        torch.cuda.empty_cache()
        s1 = make()
        sm = shard_setup(s1, mesh, mode="shard_map")
        placed = _setup_on_cards(sm, mesh)
        res = {}
        for which, setup in (("single", s1), ("cards", sm), ("cards", sm),
                             ("single", s1)):
            r = bt.solve(setup)
            res.setdefault(which, []).append(r)
        r1, rm = res["single"][-1], res["cards"][-1]
        dev = _history_dev(rm.residual_norms, r1.residual_norms, 1e-3)
        _on_cards(mesh, (rm.x_star,))
        ms = {w: [round(1e3 * r.solve_seconds / max(1, r.iter_count), 5)
                  for r in rs] for w, rs in res.items()}
        print(f"[mesh-cards] {name} f32 on {mesh.size} cards: iters "
              f"single={r1.iter_count} cards={rm.iter_count}, max rel "
              f"history difference above 1e-3·||r0|| {dev:.3e}, "
              f"{placed} shard tensors each on its card, ms/iter in turns "
              f"{ms}")
        if not (r1.iter_count == rm.iter_count == iters and dev <= 1e-3):
            raise RuntimeError(f"[mesh-cards] {name} differs from one "
                               "device")
        _print_census("mesh-cards", name, mesh_census(sm))
        out[name] = ms
        del s1, sm, res, r1, rm
    res = {}
    for which in ("single", "cards"):
        setup = _hpcg_cg(torch, bt, MAIN_SPEC, torch.float64,
                         preconditioner=P.JACOBI, tolerance=1e-8,
                         max_iters=2000)
        if which == "cards":
            setup = shard_setup(setup, mesh, mode="shard_map")
        res[which] = bt.solve(setup)
    r1, rm = res["single"], res["cards"]
    dev = _history_dev(rm.residual_norms, r1.residual_norms)
    print(f"[mesh-cards] {MAIN_SPEC} f64 CG + Jacobi to 1e-8 on "
          f"{mesh.size} cards: iters single={r1.iter_count} "
          f"cards={rm.iter_count} max rel history difference {dev:.3e}")
    if not (r1.converged and rm.converged
            and r1.iter_count == rm.iter_count and dev <= 1e-8):
        raise RuntimeError("[mesh-cards] the f64 solve on the cards differs "
                           "from one device")
    torch.cuda.empty_cache()
    return out


def _same_card(torch, phase, before):
    """Raise where a phase left the process on another current card."""
    now = torch.cuda.current_device()
    print(f"[{phase}] current device {now} (before the phase {before})")
    if now != before:
        raise RuntimeError(f"[{phase}] the phase left the process on card "
                           f"{now}, not {before}")


def main():
    import torch
    t_last = [time.perf_counter()]

    def lap(phase):
        now = time.perf_counter()
        print(f"[time] {phase} {now - t_last[0]:.1f} s")
        t_last[0] = now

    name = phase_device(torch)
    lap("device")
    import basic_iterative_solvers_tpu_torch as bt
    phase_build(torch)
    lap("build")
    phase_native(torch, bt)
    lap("native")
    from basic_iterative_solvers_tpu_torch.ops import gmres_basis
    record = phase_kernel_vs_plain(torch, bt.stencil_op)
    lap("kernel_vs_plain")
    basis_records = phase_basis_vs_plain(torch, gmres_basis)
    lap("basis_vs_plain")
    phase_cpu_vs_card(torch, bt)
    lap("cpu_vs_card")
    phase_cpu_vs_card_slice2(torch, bt)
    lap("cpu_vs_card_slice2")
    launches, _, main_routes = phase_main_path(torch, bt)
    lap("main_path")
    slice2_launches = phase_slice_path(torch, bt)
    lap("slice_path")
    phase_capacity(torch, bt)
    lap("capacity")
    gs_record = phase_gs_step_vs_plain(torch, bt)
    lap("gs_step_vs_plain")
    level_record = phase_super_level_vs_plain(torch, bt)
    lap("super_level_vs_plain")
    phase_cpu_vs_card_slice3(torch, bt)
    lap("cpu_vs_card_slice3")
    super_launches, super_routes, gs_launches, gs_routes = \
        phase_slice3_path(torch, bt)
    lap("slice3_path")
    table_record, whole_l = phase_ilu0_level_vs_plain(torch, bt)
    lap("ilu0_level_vs_plain")
    split_records, ab = phase_split_vs_plain(torch, bt)
    ab384 = ab[f"{ILU_384} float32"]
    lap("split_vs_plain")
    phase_cpu_vs_card_ilu0(torch, bt)
    lap("cpu_vs_card_ilu0")
    slice4_launches = phase_slice4_path(torch, bt)
    lap("slice4_path")
    dia_record = phase_dia_vs_plain(torch, bt)
    lap("dia_vs_plain")
    lane_record, sband = phase_lane_ell_vs_plain(torch, bt)
    lap("lane_ell_vs_plain")
    rank_record, band = phase_rankspace_vs_plain(torch, bt)
    lap("rankspace_vs_plain")
    phase_cpu_vs_card_slice5(torch, bt)
    lap("cpu_vs_card_slice5")
    slice5_launches = phase_slice5_path(torch, bt, sband, band)
    lap("slice5_path")
    bf16_records = phase_bf16_vs_plain(torch, bt, sband)
    lap("bf16")
    card = torch.cuda.current_device()
    mesh_records = phase_mesh_kernel_vs_plain(torch, bt, sband)
    _same_card(torch, "mesh-kernel", card)
    lap("mesh-kernel")
    mesh_launches, _slice8 = phase_slice8(torch, bt, sband)
    _same_card(torch, "slice8", card)
    lap("slice8")
    gspmd_launches, _gspmd = phase_gspmd(torch, bt)
    _same_card(torch, "gspmd", card)
    lap("gspmd")
    del sband, band
    setup5b, _gen5b, setup5b_s = phase_slice5b_build(torch, bt)
    lap("slice5b_build")
    plane_launches, plane_routes = phase_slice5b_rows(torch, bt, setup5b,
                                                      setup5b_s)
    lap("slice5b_rows")
    plane_record, split5b, whole5b = phase_plane_level_vs_plain(
        torch, bt, setup5b)
    torch.cuda.empty_cache()
    lap("plane_level_vs_plain")
    mega_record = phase_mega_vs_per_level(torch, bt, setup5b)
    lap("mega_vs_per_level")
    mega_launches, mega_routes = phase_mega_rows(torch, bt)
    lap("mega_rows")
    mesh_level_record = phase_mesh_super_level(
        torch, bt, setup5b, {"const": mega_record["library_ms"],
                             "table": whole_l["library_ms"],
                             "plane": whole5b["library_ms"]})
    _same_card(torch, "mesh-super-level", card)
    lap("mesh_super_level")
    mesh_super_launches, _slice8b = phase_slice8b(torch, bt, setup5b)
    del setup5b
    torch.cuda.empty_cache()
    _same_card(torch, "slice8b", card)
    lap("slice8b")
    phase_mesh_cards(torch, bt)
    _same_card(torch, "mesh-cards", card)
    lap("mesh_cards")
    stream_record = phase_stream_vs_plain(torch, bt, record["library_ms"])
    lap("stream_vs_plain")
    phase_routes_bit_equal(torch, bt)
    lap("routes_bit_equal")
    phase_cpu_vs_card_slice6(torch, bt)
    lap("cpu_vs_card_slice6")
    stream_launches, slice6_per_iter = phase_slice6_rows(torch, bt)
    lap("slice6_rows")
    phase_cg_mg_refine(torch, bt)
    lap("cg_mg_refine")
    phase_pipelined_row(torch, bt)
    lap("pipelined_row")
    phase_cpu_vs_card_slice7(torch, bt)
    lap("cpu_vs_card_slice7")
    bf16_launches, _slice7_rows = phase_slice7_cli(torch, bt)
    lap("slice7_cli")
    phase_entry_point(torch)
    lap("entry_point")
    phase_orthog_share(torch, bt)
    lap("orthog_share")
    print(f"[summary] {FDM_5B} f32 ILU(0): whole L solve "
          f"torch.triangular_solve {whole5b['library_ms']:.4f} ms, "
          f"blocked_trisolve {whole5b['blocked_trisolve_ms']:.4f} ms; "
          f"apply fused {whole5b['fused']} ms, split {whole5b['split']} "
          f"ms, split direct {whole5b['split_direct']} ms (device, in "
          f"turns); {MAIN_SPEC} f32 const L "
          f"solve: one launch, brick route {mega_record['ms']:.4f} ms, "
          f"direct route {mega_record['direct_ms']:.4f} ms, per level "
          f"{mega_record['per_level_ms']:.4f} ms (device, in turns)")
    print(f"[summary] whole L solve at {MAIN_SPEC} f32: "
          f"torch.triangular_solve {whole_l['library_ms']:.4f} ms, "
          f"blocked_trisolve {whole_l['blocked_trisolve_ms']:.4f} ms; "
          f"{ILU_384} f32 ILU(0) apply: fused {ab384['fused']} ms, split "
          f"{ab384['split']} ms, split direct {ab384['split_direct']} ms "
          f"(device, in turns)")
    src = "basic_iterative_solvers_tpu_torch/csrc/"
    kernels = [{"name": "stencil_spmv", "route": "cuda",
                "source": src + "stencil_spmv.cu",
                "replaces": "basic_iterative_solvers_tpu/stencil_op.py:538",
                "launches": launches, "launches_by_route": main_routes,
                **record}]
    for kernel, line in (("project_gram", 135), ("correct_write", 203)):
        kernels.append({
            "name": kernel, "route": "cuda", "source": src + "gmres_basis.cu",
            "replaces": ("basic_iterative_solvers_tpu/ops/gmres_basis.py:"
                         f"{line}"),
            "launches": slice2_launches[kernel],
            "launches_by_route": {
                rt: slice2_launches[f"{kernel}_{rt}"]
                for rt in ("ring", "strided")},
            **basis_records[kernel]})
    kernels.append({
        "name": "stencil_gs_color_step", "route": "cuda",
        "source": src + "stencil_spmv.cu",
        "replaces": "basic_iterative_solvers_tpu/stencil_op.py:660",
        "launches": gs_launches, "launches_by_route": gs_routes,
        **gs_record})
    kernels.append({
        "name": "super_level", "route": "cuda",
        "source": src + "block_trisolve.cu",
        "replaces": "basic_iterative_solvers_tpu/ops/block_trisolve.py:1611",
        "launches": super_launches, "launches_by_route": super_routes,
        **level_record})
    # slice 4's kernels: `launches` is the count of the row that is the
    # kernel's main path (pcg_ilu0 at 128^3; the split 384^3 row for the
    # split pair), and `launches_by_row` each row's own count
    by_route = {
        "super_level_table": {row: {
            rt: slice4_launches[row][f"super_level_table_{rt}"]
            for rt in ("staged", "direct")} for row in ("pcg_ilu0",
                                                        "pcg_ilu0@384")},
        "lane_ell_spmv": slice5_launches["lane_ell_spmv_by_route"],
        "rank_level": slice5_launches["rank_level_by_route"],
        "lane_ell_spmv_bf16": bf16_launches["lane_ell_spmv_bf16_by_route"],
        "stencil_gs_step_bf16diag": bf16_launches[
            "stencil_gs_step_bf16diag_by_route"],
        "lane_ell_spmv_halo": mesh_launches["lane_ell_spmv_halo_by_route"],
        "stencil_gs_step_halo": mesh_launches[
            "stencil_gs_step_halo_by_route"],
        "stencil_spmv_halo": mesh_launches["stencil_spmv_halo_by_route"],
        "super_level_halo": {f"{k}_{rt}": sum(
            c.get(f"super_level_halo_{k}_{rt}", 0)
            for c in mesh_super_launches.values())
            for k, rts in (("table", ("staged", "direct")),
                           ("plane", ("line", "direct")),
                           ("const", ("line", "direct"))) for rt in rts}}
    for kernel in ("super_acc", "super_parity"):
        split_records[kernel].setdefault("by_mode", {}).update(
            {f"plane, {label}": recs[kernel]
             for label, recs in split5b.items()})
        by_route[kernel] = {
            rt: slice4_launches["pcg_ilu0@384 split"][f"{kernel}_{rt}"]
            for rt in ("staged", "line", "direct")}
    for kernel, line, main_row, record in (
            ("super_level_table", 1611, "pcg_ilu0", table_record),
            ("super_acc", 1999, "pcg_ilu0@384 split",
             split_records["super_acc"]),
            ("super_parity", 2069, "pcg_ilu0@384 split",
             split_records["super_parity"])):
        kernels.append({
            "name": kernel, "route": "cuda",
            "source": src + "block_trisolve.cu",
            "replaces": ("basic_iterative_solvers_tpu/ops/block_trisolve.py:"
                         f"{line}"),
            "launches": slice4_launches[main_row][kernel],
            "launches_by_row": {row: counts[kernel] for row, counts
                                in slice4_launches.items() if counts[kernel]},
            **({"launches_by_route": by_route[kernel]}
               if kernel in by_route else {}),
            **record})
    for kernel, source, line, record in (
            ("dia_spmv", "sparse_spmv.cu", "ops/pallas_spmv.py:72",
             dia_record),
            ("lane_ell_spmv", "sparse_spmv.cu", "ops/lane_ell.py:189",
             lane_record),
            ("rank_level", "block_trisolve.cu", "ops/block_trisolve.py:357",
             rank_record)):
        kernels.append({
            "name": kernel, "route": "cuda", "source": src + source,
            "replaces": "basic_iterative_solvers_tpu/" + line,
            "launches": slice5_launches[kernel],
            **({"launches_by_route": by_route[kernel]}
               if kernel in by_route else {}),
            **record})
    for kernel, line, launched, record in (
            ("super_level_plane", 1611, plane_launches,
             dict(plane_record, launches_by_route=plane_routes)),
            ("super_solve_mega", 2171, mega_launches,
             dict(mega_record, launches_by_route=mega_routes,
                  routes=["brick", "direct"]))):
        kernels.append({
            "name": kernel, "route": "cuda",
            "source": src + "block_trisolve.cu",
            "replaces": ("basic_iterative_solvers_tpu/ops/block_trisolve.py:"
                         f"{line}"),
            "launches": launched, **record})
    kernels.append({
        "name": "stencil_spmv_stream", "route": "cuda",
        "source": src + "stencil_spmv.cu",
        "replaces": "basic_iterative_solvers_tpu/stencil_op.py:422",
        "launches": stream_launches,
        "launches_by_route": {"box": stream_launches, "legs": 0},
        "launches_per_iter_by_row": {row: per[True]["stencil_spmv_stream"]
                                     for row, per in slice6_per_iter.items()},
        **stream_record})
    for kernel, source, line in (
            ("dia_spmv_bf16", "sparse_spmv.cu", "ops/pallas_spmv.py:72"),
            ("lane_ell_spmv_bf16", "sparse_spmv.cu", "ops/lane_ell.py:189"),
            ("stencil_spmv_bf16diag", "stencil_spmv.cu", "stencil_op.py:538"),
            ("stencil_spmv_stream_bf16diag", "stencil_spmv.cu",
             "stencil_op.py:422"),
            ("stencil_gs_step_bf16diag", "stencil_spmv.cu",
             "stencil_op.py:660")):
        kernels.append({
            "name": kernel, "route": "cuda", "source": src + source,
            "replaces": "basic_iterative_solvers_tpu/" + line,
            "launches": bf16_launches.get(kernel, 0),
            **({"launches_by_route": by_route[kernel]}
               if kernel in by_route else {}),
            **bf16_records[kernel]})
    for kernel, source, line in (
            ("stencil_spmv_halo", "stencil_spmv.cu", "stencil_op.py:538"),
            ("stencil_gs_step_halo", "stencil_spmv.cu", "stencil_op.py:660"),
            ("dia_spmv_halo", "sparse_spmv.cu", "ops/pallas_spmv.py:72"),
            ("lane_ell_spmv_halo", "sparse_spmv.cu", "ops/lane_ell.py:268")):
        kernels.append({
            "name": kernel, "route": "cuda", "source": src + source,
            "replaces": "basic_iterative_solvers_tpu/" + line,
            "launches": mesh_launches.get(kernel, 0),
            "launches_by_row": {"slice8 mesh": mesh_launches.get(kernel, 0),
                                "gspmd": gspmd_launches.get(kernel, 0)},
            **({"launches_by_route": by_route[kernel]}
               if kernel in by_route else {}),
            **mesh_records[kernel]})
    kernels.append({
        "name": "super_level_halo", "route": "cuda",
        "source": src + "block_trisolve.cu",
        "replaces": "basic_iterative_solvers_tpu/ops/block_trisolve.py:1611",
        "launches": mesh_super_launches["pcg"]["super_level_halo"],
        "launches_by_row": {row: sum(v for k, v in c.items()
                                     if not k.endswith(("_staged",
                                                        "_direct", "_line")))
                            for row, c in mesh_super_launches.items()},
        "launches_by_route": by_route["super_level_halo"],
        **mesh_level_record})
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for k in kernels:
        if not set(keys) <= set(k) or not k["launches"]:
            raise RuntimeError(f"kernel record incomplete or never launched "
                               f"on a main path: {k}")
    print(json.dumps({"kernels": [
        {key: k[key] for key in keys + ("launches_by_row",
                                        "launches_per_iter_by_row",
                                        "resident_ms", "call_ms",
                                        "legs_ms", "legs_ms_384",
                                        "resident_ms_384",
                                        "single_ms", "ms_384",
                                        "f32_ms_384", "bound_ms_384",
                                        "by_mode", "wrapper_ms",
                                        "strided_ms", "f32_ms",
                                        "f32_library_ms", "f32_bound_ms",
                                        "f32_strided_ms",
                                        "launches_by_route", "padded_ms",
                                        "idx32_ms", "padded_bound_ms",
                                        "counted_ms", "padded32_ms",
                                        "padded32_bound_ms",
                                        "whole_library_ms", "direct_ms",
                                        "direct_ms_384", "apply_ms_384",
                                        "scalar_ms", "sector_bound_ms",
                                        "direct_apply_ms_384",
                                        "bound_apply_ms_384", "routes",
                                        "per_level_ms", "level_bound_ms",
                                        "floor_ms", "direct_first_ms",
                                        "in_place_ms", "grid", "brick",
                                        "gspmd1_ms", "gspmd1_legs_ms",
                                        "gspmd1_bound_ms", "by_type",
                                        "wrapper_legs_ms")
         if key in k}
        for k in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
