"""Drive the PyTorch/CUDA port (basic_iterative_solvers_tpu_torch) on one
NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the script
exits non-zero:
  1. device: the card's name and power limit;
  2. build: compile the CUDA kernels from this checkout;
  3. the stencil SpMV kernel against its plain PyTorch version on the card,
     at the main path's shapes, both timed;
  4. the GMRES basis kernels (project_gram, correct_write) against their
     plain versions at the 128^3 GMRES(50) shape, both basis dtypes, both
     timed;
  5. the same CG solve on the CPU (plain path) and on the card (kernel);
  6. the same BiCGSTAB and GMRES solves on the CPU and on the card;
  7. the main path: CG on HPCG 128^3 in float32 through the public entry
     points, 2500 iterations, counting the kernel's launches; then a
     float64 solve of the same operator to convergence;
  8. the second slice's path: Jacobi, BiCGSTAB and fused-mode GMRES(50)
     with a bfloat16 basis on HPCG 128^3 in float32, the bench's
     iteration counts, counting every kernel's launches; then float64
     GMRES(50) and BiCGSTAB solves of the same operator to convergence;
  9. capacity: CG on HPCG 384^3 in float32;
 10. the multicolour GS step kernel against its plain version, every
     colour, on the three operators of phase 3, both dtypes, timed;
 11. the superblock level kernel against its plain version on every level
     of the L and U solves of HPCG 128^3, and a whole symmetric apply, both
     dtypes, timed;
 12. the same GS-family solves on the CPU and on the card (SGS and CG + SGS
     on HPCG 32^3, the superblock route; SGS on fdm:256, the masked
     colour sweeps);
 13. the third slice's path: the bench's gs, sgs, pcg, pgmres and
     pbicgstab rows on HPCG 128^3 in float32, counting every kernel's
     launches; then a float64 CG + SGS solve to convergence; and SGS on
     fdm:2048 through the GS colour-step kernel;
 14. the superblock level kernel in factor-table mode (exact ILU(0))
     against its plain version on every level of the L and U solves of
     HPCG 128^3 and on a whole ILU(0) apply, both dtypes, bit for bit; at
     384^3 one L and one U level and a whole apply; and one whole L solve
     through torch.triangular_solve on the sparse lower triangle, the
     library's nearest call;
 15. the split route's kernels (super_acc, super_parity) against their
     plain versions on every level at 384^3, then the split and the fused
     route on whole 384^3 applies, in turns (fused, split, split, fused);
 16. the same CG + ILU(0) solve on the CPU and on the card (HPCG 32^3);
 17. the fourth slice's path: the bench's pcg_ilu0 rows, HPCG 128^3 (1200
     iterations) and 384^3 (100), fused and, at 384^3, split
     (BIS_SB_ALIGNED=0), counting every kernel's launches, with set-up
     seconds and peak memory; then a float64 CG + ILU(0) solve to
     convergence;
 18. the DIA SpMV kernel against its plain version on the DIA operators of
     HPCG 128^3 (f32, f64) and 384^3 (f32) built on the card, with the
     library's CSR SpMV of the same matrix;
 19. the lane-ELL SpMV kernel against its plain version on
     sband:500000,8,400 (f32, f64), with the library's CSR SpMV;
 20. the rank-space level kernel against its plain version on every level
     with groups of the SGS pair of band:8388608,2 (f32, f64), whole
     applies against the CPU's, and torch.triangular_solve's whole L
     solve;
 21. the same DIA, lane-ELL and rank-space solves on the CPU and on the
     card (f64, small sizes);
 22. the fifth slice's paths: DIA CG at 128^3 (2500 iterations) and 384^3
     (150), cg@sband on lane-ELL (400) and the gather ELL (40),
     pbicgstab@band (800), counting every kernel's launches, with set-up
     seconds; then natural-order f64 CG + SGS and CG + ILU(0) on fdm:256
     on the CPU and on the card, equal iteration counts;
 23. the slice-5b rows ([slice5b]): the coloured host route under the
     source's grid colour spec, pcg_ilu0@fdm2048 (CG + ILU(0), 1200
     iterations, the pair from host CSR: L in plane mode, U const with a
     per-row D, the JAX CLI's route: the JAX bench's stencil injection
     takes the factor-table pair here) and pbicgstab@anderson128
     (BiCGSTAB + SGS, 800, the stencil injected: const mode with a per-row
     D), with every kernel's launches, set-up seconds and peak memory; f64
     CG + ILU(0) on fdm:256 on that route on the CPU and on the card;
 24. the plane mode of the superblock level kernel and the per-row D of
     its const mode ([plane-level]) against their plain versions on every
     level of the fdm:2048 pair, f32 and widened to f64, bit for bit, whole
     applies, the split route's kernels in plane mode ([plane-split]) and
     the fused/split A/B in turns, torch.triangular_solve's whole L solve,
     and the hpcg:32x32x32 plane pair against its factor-table pair;
 25. the one-launch const solve ([mega]) against the per-level route and
     the plain loop on the HPCG 128^3 SGS pair, f32 and f64, bit for bit,
     and torch.triangular_solve's whole const L solve; then the bench's sgs and pcg rows with BIS_SB_MEGA's switch (the
     module attribute MEGA) on and off in turns.
The second-to-last line is a JSON object describing each kernel: launches
on the main paths, error against plain, kernel, plain and library times,
and the bound (the larger of the bytes it must move over the card's
memory rate and its operations over the float32 rate); the last is
{"ok": true, "device": {...}}.
"""
import dataclasses
import json
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


def phase_build():
    from basic_iterative_solvers_tpu_torch import _build
    t0 = time.perf_counter()
    _build.load_library()
    print(f"[build] {', '.join(src.name for src in _build.SOURCES)} built "
          f"and loaded in {time.perf_counter() - t0:.2f} s")


def phase_kernel_vs_plain(torch, so):
    """Every SpMV form the main path and the explicit residual use, plus
    the other dot kinds, on the card; returns the main-path record."""
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
                k, p = (k, p) if dots else ((k,), (p,))
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
                      f"dots={','.join(dots) or '-'} max_rel_err={rel:.3e} "
                      f"dot_rel_err={[f'{e:.3e}' for e in dot_rel]} "
                      f"kernel_ms={ms:.4f} "
                      f"plain_ms={plain_ms:.4f} kernel_GB/s={gbs:.0f}")
                if not (rel <= tol and all(e <= tol for e in dot_rel)):
                    raise RuntimeError(f"kernel disagrees with plain beyond "
                                       f"{tol}: {spec} {dt} {dots}")
                if (spec, dt, dots) == (MAIN_SPEC, torch.float32, ("x",)):
                    record = {"max_abs_err": abs_err, "ms": ms,
                              "plain_ms": plain_ms}
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


def phase_basis_vs_plain(torch, gb):
    """project_gram and correct_write against their plain versions on the
    same CUDA tensors: Pw/Pv within BASIS_TOL, the written row and vnext
    bit for bit (both round each product and difference alone), nrm2
    within 1e-5 relative; both timed at j = 49.  Returns the bf16 records
    (the main path's basis)."""
    records = {}
    g = torch.Generator(device="cuda").manual_seed(1)
    n, m = BASIS_N, BASIS_M
    for dt in (torch.float32, torch.bfloat16):
        V = torch.randn(m + 1, n, device="cuda", generator=g).to(dt)
        w = torch.randn(n, device="cuda", generator=g)
        vc = torch.randn(n, device="cuda", generator=g)
        ht = torch.randn(m + 1, device="cuda", generator=g)
        for j in BASIS_JS:
            before = (gb.project_gram.launches, gb.correct_write.launches)
            Pk = gb.project_gram(V, w, vc, j)
            Pp = gb.project_gram_plain(V, w, vc, j)
            Vk, Vp = V.clone(), V.clone()
            vk, nk = gb.correct_write(Vk, w, ht, j)
            vp, np_ = gb.correct_write_plain(Vp, w, ht, j)
            torch.cuda.synchronize()
            if (gb.project_gram.launches, gb.correct_write.launches) != (
                    before[0] + 1, before[1] + 1):
                raise RuntimeError("a basis kernel's launch count did not "
                                   "grow")
            Vf = V[:j + 1].float()
            pg_err = max(float(((k[:j + 1] - p[:j + 1]).abs()
                                / (Vf * v).abs().sum(1)).max())
                         for k, p, v in zip(Pk, Pp, (w, vc)))
            pg_abs = max(float((k - p).abs().max()) for k, p in zip(Pk, Pp))
            tail = max(float(k[j + 1:].abs().max()) for k in Pk)  # j < m
            rows_equal = torch.equal(Vk, Vp) and torch.equal(vk, vp)
            nrm_rel = abs(float(nk) - float(np_)) / float(np_)
            line = (f"[basis] n={n} m={m} {str(dt)[6:]} j={j} "
                    f"project_gram_rel_err={pg_err:.3e} "
                    f"tail={tail:.1e} correct_write_rows_equal={rows_equal} "
                    f"nrm2_rel_err={nrm_rel:.3e}")
            if not (pg_err <= BASIS_TOL and tail == 0.0 and rows_equal
                    and nrm_rel <= 1e-5):
                raise RuntimeError(f"basis kernels disagree with plain: "
                                   f"{line}")
            if j == BASIS_JS[-1]:
                # bytes each must move: rows 0..j, plus w and vc, or plus
                # w, vnext and the written row
                row = n * V.element_size()
                pg_bytes = (j + 1) * row + 2 * 4 * n
                cw_bytes = (j + 2) * row + 2 * 4 * n
                t = {}
                for name, fn in (
                        ("pg", lambda: gb.project_gram(V, w, vc, j)),
                        ("pg_plain", lambda: gb.project_gram_plain(V, w, vc,
                                                                   j)),
                        ("cw", lambda: gb.correct_write(Vk, w, ht, j)),
                        ("cw_plain", lambda: gb.correct_write_plain(
                            Vp, w, ht, j))):
                    t[name] = _median_ms(fn, torch)
                line += (f" project_gram_ms={t['pg']:.4f} "
                         f"plain_ms={t['pg_plain']:.4f} "
                         f"GB/s={pg_bytes / (t['pg'] * 1e6):.0f} "
                         f"correct_write_ms={t['cw']:.4f} "
                         f"plain_ms={t['cw_plain']:.4f} "
                         f"GB/s={cw_bytes / (t['cw'] * 1e6):.0f}")
                if dt == torch.bfloat16:
                    # the library's nearest calls, in the basis dtype: one
                    # matmul of rows 0..j with [w, vc]; one addmv w − Vᵀh,
                    # which leaves out the row write, the float32 vnext and
                    # the norm
                    W = torch.stack([w, vc], 1).to(dt)
                    hb, wb = ht[:j + 1].to(dt), w.to(dt)
                    lib_pg = _median_ms(lambda: torch.matmul(V[:j + 1], W),
                                        torch)
                    lib_cw = _median_ms(lambda: torch.addmv(
                        wb, V[:j + 1].t(), hb, alpha=-1), torch)
                    line += (f" library: matmul_ms={lib_pg:.4f} "
                             f"addmv_ms={lib_cw:.4f}")
                    records["project_gram"] = {
                        "max_abs_err": pg_abs, "ms": t["pg"],
                        "plain_ms": t["pg_plain"], "library_ms": lib_pg,
                        **_bound(pg_bytes, 4 * (j + 1) * n)}
                    records["correct_write"] = {
                        "max_abs_err": float((vk - vp).abs().max()),
                        "ms": t["cw"], "plain_ms": t["cw_plain"],
                        "library_ms": lib_cw,
                        **_bound(cw_bytes, 2 * (j + 1) * n + 2 * n)}
            print(line)
        del V, Vk, Vp
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
    so.stencil_spmv.launches = 0
    res = bt.solve(setup, method=method)
    launches = so.stencil_spmv.launches
    ms = 1e3 * res.solve_seconds / max(1, res.iter_count)
    print(f"[main] {MAIN_SPEC} f32 CG fused: iters={res.iter_count} "
          f"ms/iter={ms:.5f} r0={res.residual_norms[0]:.6e} "
          f"final_explicit_f64={res.final_residual_norm:.6e} "
          f"spmv_launches={launches}")
    if not (res.iter_count == 2500 and math.isfinite(res.final_residual_norm)
            and launches >= 2500 and res.x_star.shape == (setup.n,)
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
    return launches, ms


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
        gb.project_gram.launches = gb.correct_write.launches = 0
        res = bt.solve(setup, method=solver)
        counts = {"stencil_spmv": so.stencil_spmv.launches,
                  "project_gram": gb.project_gram.launches,
                  "correct_write": gb.correct_write.launches}
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
            ok = ok and min(counts["project_gram"],
                            counts["correct_write"]) >= res.iter_count
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


def phase_gs_step_vs_plain(torch, bt):
    """stencil_gs_color_step against its plain version on every colour of
    the three operators, f32 and f64, within TOL of max|x'|; colour 0
    timed.  Returns the record of fdm:2048 f32 (the masked route that
    phase 13 drives)."""
    from basic_iterative_solvers_tpu_torch.coloring import spec_for_device
    so = bt.stencil_op
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
            worst_rel, worst_abs = 0.0, 0.0
            for c in range(cs.n_colors):
                before = so.stencil_gs_color_step.launches
                k = so.stencil_gs_color_step(A, x, rhs, dinv, cs, c)
                p = so.stencil_gs_color_step_plain(A, x, rhs, dinv, cs, c)
                torch.cuda.synchronize()
                if so.stencil_gs_color_step.launches != before + 1:
                    raise RuntimeError("the GS step's launch count did not "
                                       "grow")
                abs_err = float((k - p).abs().max())
                worst_abs = max(worst_abs, abs_err)
                worst_rel = max(worst_rel, abs_err / float(p.abs().max()))
            ms = _median_ms(lambda: so.stencil_gs_color_step(
                A, x, rhs, dinv, cs, 0), torch)
            plain_ms = _median_ms(lambda: so.stencil_gs_color_step_plain(
                A, x, rhs, dinv, cs, 0), torch, reps=5)
            print(f"[gs-step] {spec} {str(dt)[6:]} {cs.kind} "
                  f"colors={cs.n_colors} max_rel_err={worst_rel:.3e} "
                  f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}")
            if not worst_rel <= tol:
                raise RuntimeError(f"GS step kernel disagrees with plain "
                                   f"beyond {tol}: {spec} {dt}")
            if (spec, dt) == ("fdm:2048", torch.float32):
                # out of place: x and x' whole, rhs and dinv on colour 0's
                # rows; per such row its legs' products and sums, then
                # rhs − s, ·dinv and + x
                n, n_c = A.n_rows, A.n_rows // cs.n_colors
                record = {"max_abs_err": worst_abs, "ms": ms,
                          "plain_ms": plain_ms, "library_ms": None,
                          **_bound(4 * (2 * n + 2 * n_c),
                                   n_c * (2 * len(A.legs) + 2))}
    return record


def phase_super_level_vs_plain(torch, bt):
    """super_level against its plain version on every level of the L and U
    solves of HPCG 128^3 (x random, so every source superblock holds
    values), and blocked_sgs whole, f32 and f64, within TOL; every level
    timed.  Returns the f32 record (ms: the mean level)."""
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
        worst_rel, worst_abs, ms, plain_ms = 0.0, 0.0, [], []
        for name, B in (("L", L), ("U", U)):
            for li in range(len(B.levels)):
                before = bk.super_level.launches
                xk, xp = x.clone(), x.clone()
                bk.super_level(B, li, y, xk)
                bk.super_level_plain(B, li, y, xp)
                torch.cuda.synchronize()
                if bk.super_level.launches != before + 1:
                    raise RuntimeError("the super-level launch count did "
                                       "not grow")
                abs_err = float((xk - xp).abs().max())
                rel = abs_err / float(xp.abs().max())
                worst_abs, worst_rel = max(worst_abs, abs_err), max(
                    worst_rel, rel)
                ms.append(_median_ms(lambda: bk.super_level(B, li, y, xk),
                                     torch))
                plain_ms.append(_median_ms(
                    lambda: bk.super_level_plain(B, li, y, xp), torch,
                    reps=5))
                print(f"[super-level] {MAIN_SPEC} {str(dt)[6:]} {name} "
                      f"level {li} (superblock {B.levels[li][0]}, "
                      f"{len(B.const_cross[li])} cross legs) "
                      f"max_rel_err={rel:.3e} kernel_ms={ms[-1]:.4f} "
                      f"plain_ms={plain_ms[-1]:.4f}")
        zk = bk.blocked_sgs(L, U, y)
        before = bk.super_level.launches
        zp = bk.blocked_sgs(L, U, y.cpu()).to("cuda")
        if bk.super_level.launches != before:
            raise RuntimeError("a CPU solve launched a kernel")
        sgs_rel = float((zk - zp).abs().max()) / float(zp.abs().max())
        sgs_ms = _median_ms(lambda: bk.blocked_sgs(L, U, y), torch)
        print(f"[super-level] {MAIN_SPEC} {str(dt)[6:]} blocked_sgs "
              f"(2x{L.S} levels) against the CPU's plain solve: "
              f"max_rel_err={sgs_rel:.3e} ms={sgs_ms:.4f}")
        if not (worst_rel <= tol and sgs_rel <= tol):
            raise RuntimeError(f"super-level kernel disagrees with plain "
                               f"beyond {tol}: {dt}")
        if dt == torch.float32:
            record = {"max_abs_err": worst_abs,
                      "ms": statistics.mean(ms),
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
               "project_gram": (gb.project_gram, "launches"),
               "correct_write": (gb.correct_write, "launches"),
               "super_level": (bk.super_level, "launches"),
               "super_level_table": (bk.super_level, "table_launches"),
               "super_level_plane": (bk.super_level, "plane_launches"),
               "super_acc": (bk.super_acc, "launches"),
               "super_parity": (bk.super_parity, "launches"),
               "super_solve_mega": (bk.super_solve_mega, "launches")}
    if reset:
        for fn, attr in kernels.values():
            setattr(fn, attr, 0)
    return {name: getattr(fn, attr) for name, (fn, attr) in kernels.items()}


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
    for name, method, precond, iters, kw in SLICE3_ROWS:
        setup = _setup(torch, bt, MAIN_SPEC, torch.float32, "cuda",
                       S[method], preconditioner=P[precond],
                       max_iters=iters, tolerance=0.0, breakdown_stall=True,
                       precond_inner_iters=1, **kw)
        if setup.gs_L_block is None and setup.M.L_block is None:
            raise RuntimeError(f"{name} did not take the superblock route")
        solver = make_method(setup)
        bt.solve(setup, method=solver)                # warm-up solve
        _counters(so, gb, bk, reset=True)
        res = bt.solve(setup, method=solver)
        counts = _counters(so, gb, bk)
        super_launches += counts["super_level"]
        ms = 1e3 * res.solve_seconds / max(1, res.iter_count)
        print(f"[slice3] {MAIN_SPEC} f32 {name} fused: "
              f"iters={res.iter_count} restarts={res.gmres_restart_count} "
              f"ms/iter={ms:.5f} r0={res.residual_norms[0]:.6e} "
              f"final_explicit_f64={res.final_residual_norm:.6e} "
              f"launches={counts}")
        if not (res.iter_count + res.gmres_restart_count == iters
                and math.isfinite(res.final_residual_norm)
                and bool(torch.isfinite(res.x_star).all())
                and counts["super_level"] >= res.iter_count
                and counts["stencil_spmv"] >= res.iter_count
                and counts["stencil_gs_color_step"] == 0):
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
    _counters(so, gb, bk, reset=True)
    res = bt.solve(setup, method=solver)
    counts = _counters(so, gb, bk)
    ms = 1e3 * res.solve_seconds / max(1, res.iter_count)
    print(f"[slice3] fdm:2048 f32 SGS fused (masked sweeps): "
          f"iters={res.iter_count} ms/iter={ms:.5f} "
          f"r0={res.residual_norms[0]:.6e} "
          f"final_explicit_f64={res.final_residual_norm:.6e} "
          f"launches={counts}")
    if not (res.iter_count == 200 and math.isfinite(res.final_residual_norm)
            and bool(torch.isfinite(res.x_star).all())
            and counts["stencil_gs_color_step"] >= 4 * res.iter_count
            and counts["super_level"] == 0):
        raise RuntimeError("fdm:2048 SGS run failed its checks")
    return super_launches, counts["stencil_gs_color_step"]


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


def _check_levels(torch, bk, label, B, y, x, levels, timed=True,
                  tag="ilu0-level"):
    """super_level against super_level_plain on the given levels of B, bit
    for bit, each launch counted in its mode's counter; returns ([kernel
    ms], [plain ms], worst abs error)."""
    attr = ("table_launches" if B.is_table else
            "plane_launches" if B.is_plane else "launches")
    ms, plain_ms, worst = [], [], 0.0
    for li in levels:
        before = getattr(bk.super_level, attr)
        xk, xp = x.clone(), x.clone()
        bk.super_level(B, li, y, xk)
        bk.super_level_plain(B, li, y, xp)
        torch.cuda.synchronize()
        if getattr(bk.super_level, attr) != before + 1:
            raise RuntimeError(f"the {attr} count did not grow")
        equal = torch.equal(xk, xp)
        worst = max(worst, float((xk - xp).abs().max()))
        line = (f"[{tag}] {label} {'U' if B.upper else 'L'} level {li} "
                f"({_mode(B)}, superblock {B.levels[li][0]}, "
                f"{len(B.levels[li][1])} cross legs) bit_equal={equal}")
        if timed:
            ms.append(_median_ms(lambda: bk.super_level(B, li, y, xk),
                                 torch))
            plain_ms.append(_median_ms(
                lambda: bk.super_level_plain(B, li, y, xp), torch, reps=3,
                batch=3))
            line += f" kernel_ms={ms[-1]:.4f} plain_ms={plain_ms[-1]:.4f}"
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
    bit: every level of the L and U solves of HPCG 128^3 and a whole
    blocked_ilu0, f32 and f64, every level timed; at 384^3 f32 the last L
    and the last U level (the most cross legs) and a whole apply, timed.
    Then one whole L solve of 128^3 through torch.triangular_solve (the
    library's sparse triangular solve) against blocked_trisolve.  Returns
    the 128^3 f32 record (ms: the mean level) and the two L solves' ms."""
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
        ms, plain_ms, worst = [], [], 0.0
        for B in (L, U):
            levels = (range(len(B.levels)) if spec == MAIN_SPEC
                      else (len(B.levels) - 1,))
            k, p, e = _check_levels(torch, bk, label, B, y, x, levels)
            ms += k
            plain_ms += p
            worst = max(worst, e)
        zk = bk.blocked_ilu0(L, U, y)
        zp = _plain_ilu0(bk, L, U, y)
        torch.cuda.synchronize()
        apply_ms = _median_ms(lambda: bk.blocked_ilu0(L, U, y), torch)
        works = [_level_work(B, li, A.coeffs.element_size())
                 for B in (L, U) for li in range(len(B.levels))]
        bound = _bound(sum(b for b, _o in works), sum(o for _b, o in works))
        print(f"[ilu0-level] {label} blocked_ilu0 (2x{L.S} levels) against "
              f"the plain levels: bit_equal={torch.equal(zk, zp)} "
              f"ms={apply_ms:.4f} bound_ms={bound['bound_ms']:.4f} "
              f"({bound['bound_by']}, at the float32 rate)")
        if not torch.equal(zk, zp):
            raise RuntimeError(f"{label}: whole ILU(0) apply disagrees")
        if spec == MAIN_SPEC and dt == torch.float32:
            record = {"max_abs_err": worst, "ms": statistics.mean(ms),
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
        del A, L, U, x, y, zk, zp
        torch.cuda.empty_cache()
    return record, whole_l


def phase_split_vs_plain(torch, bt):
    """super_acc and super_parity against their plain versions on every
    level of the 384^3 f32 pair, bit for bit, each timed; then whole
    applies on the fused and the split route in turns (fused, split,
    split, fused), equal bit for bit.  Returns the two records and the
    A/B times."""
    from basic_iterative_solvers_tpu_torch.ops import block_trisolve as bk
    dt = torch.float32
    A, L, U, _s = _ilu0_pair(torch, bt, ILU_384, dt)
    Ls, Us = _split_pair(L, U)
    g = torch.Generator(device="cuda").manual_seed(5)
    y = torch.randn(A.n_rows, dtype=dt, device="cuda", generator=g)
    x = torch.randn(A.n_rows, dtype=dt, device="cuda", generator=g)
    acc_k = torch.empty(L.m, dtype=dt, device="cuda")
    acc_p = torch.empty_like(acc_k)
    t = {"acc": [], "acc_plain": [], "par": [], "par_plain": []}
    work = {"acc": [], "par": []}
    worst = {"acc": 0.0, "par": 0.0}
    for B in (Ls, Us):
        for li, (_sb, cross, _s2) in enumerate(B.levels):
            if cross:
                before = bk.super_acc.launches
                bk.super_acc(B, li, y, x, acc_k)
                bk.super_acc_plain(B, li, y, x, acc_p)
                torch.cuda.synchronize()
                if bk.super_acc.launches != before + 1:
                    raise RuntimeError("the acc launch count did not grow")
                if not torch.equal(acc_k, acc_p):
                    raise RuntimeError(f"super_acc disagrees with plain on "
                                       f"level {li}")
                t["acc"].append(_median_ms(
                    lambda: bk.super_acc(B, li, y, x, acc_k), torch))
                t["acc_plain"].append(_median_ms(
                    lambda: bk.super_acc_plain(B, li, y, x, acc_p), torch,
                    reps=3, batch=3))
                work["acc"].append(_level_work(B, li, 4, "acc"))
            a = acc_k if cross else None
            for p in bk._parity_order(B):
                xk, xp = x.clone(), x.clone()
                before = bk.super_parity.launches
                bk.super_parity(B, li, p, y, a, xk)
                bk.super_parity_plain(B, li, p, y, a, xp)
                torch.cuda.synchronize()
                if bk.super_parity.launches != before + 1:
                    raise RuntimeError("the parity launch count did not "
                                       "grow")
                if not torch.equal(xk, xp):
                    raise RuntimeError(f"super_parity disagrees with plain "
                                       f"on level {li} parity {p}")
                t["par"].append(_median_ms(
                    lambda: bk.super_parity(B, li, p, y, a, xk), torch))
                t["par_plain"].append(_median_ms(
                    lambda: bk.super_parity_plain(B, li, p, y, a, xp),
                    torch, reps=3, batch=3))
                work["par"].append(_level_work(B, li, 4, "parity", p))
            print(f"[ilu0-split] {ILU_384} f32 {'U' if B.upper else 'L'} "
                  f"level {li}: super_acc and super_parity bit_equal=True "
                  f"acc_ms={t['acc'][-1] if cross else 0:.4f} "
                  f"parity_ms={t['par'][-2]:.4f},{t['par'][-1]:.4f}")
    ab = {"fused": [], "split": []}
    out = {}
    for route in ("fused", "split", "split", "fused"):
        pair = (L, U) if route == "fused" else (Ls, Us)
        out[route] = bk.blocked_ilu0(*pair, y)
        ab[route].append(_median_ms(lambda: bk.blocked_ilu0(*pair, y),
                                    torch))
    equal = torch.equal(out["fused"], out["split"])
    print(f"[ilu0-split] {ILU_384} f32 whole apply A/B in turns: fused_ms="
          f"{ab['fused']} split_ms={ab['split']} bit_equal={equal}")
    if not equal:
        raise RuntimeError("split and fused 384^3 applies differ")
    records = {}
    for name, key in (("super_acc", "acc"), ("super_parity", "par")):
        records[name] = {"max_abs_err": 0.0,
                         "ms": statistics.mean(t[key]),
                         "plain_ms": statistics.mean(t[key + "_plain"]),
                         "library_ms": None, **_mean_bound(work[key])}
    del A, L, U, Ls, Us, x, y, acc_k, acc_p, out
    torch.cuda.empty_cache()
    return records, ab


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
    the package reads at import: set here on the module).  Set-up seconds
    and peak memory per row.  Then float64 CG + ILU(0) on 128^3 to 1e-8.
    Returns each row's launches of the factor-table level and of the split
    pair, by row name."""
    import math
    from basic_iterative_solvers_tpu_torch.ops import block_trisolve as bk
    from basic_iterative_solvers_tpu_torch.ops import gmres_basis as gb
    from basic_iterative_solvers_tpu_torch.solvers import make_method
    so = bt.stencil_op
    S, P = bt.SolverType, bt.PrecondType
    launches = {}
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
        if split:
            n_acc = sum(1 for B in (L, U) for lv in B.levels if lv[1])
            ok = ok and counts["super_level_table"] == 0 and (
                counts["super_acc"], counts["super_parity"]) == (
                n_acc * applies, 2 * L.S * L.sx * applies)
        else:
            ok = ok and counts["super_level_table"] == 2 * L.S * applies and (
                counts["super_acc"] == counts["super_parity"] == 0)
        if not ok:
            raise RuntimeError(f"slice-4 {name} run failed its checks")
        launches[name] = {k: counts[k] for k in
                          ("super_level_table", "super_acc", "super_parity")}
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
    """The launch counts of the slice-5 kernels (`reset`: set to 0
    first)."""
    from basic_iterative_solvers_tpu_torch.ops import block_trisolve as bk
    from basic_iterative_solvers_tpu_torch.ops import dia_spmv, lane_ell
    fns = {"dia_spmv": dia_spmv.dia_spmv,
           "lane_ell_spmv": lane_ell.lane_ell_spmv,
           "rank_level": bk.rank_level,
           "stencil_spmv": bt.stencil_op.stencil_spmv}
    if reset:
        for fn in fns.values():
            fn.launches = 0
    return {name: fn.launches for name, fn in fns.items()}


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


def phase_lane_ell_vs_plain(torch, bt):
    """Kernel #5 against its plain version, bit for bit, on the lane-ELL
    planes of sband:500000,8,400 (f32, f64), with the library's CSR SpMV
    of the same matrix.  Returns the f32 record and the host matrix."""
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
        x = torch.randn(A.n_rows, dtype=dt, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(7))
        label = (f"{SBAND} {str(dt)[6:]} (nnz {A.nnz}, K={M.K}, S={M.S}, "
                 f"R={M.R}; host CSR {gen_s:.2f} s, planes {build_s:.2f} s)")
        err, ms, plain_ms = _kernel_vs_plain(
            torch, "lane-ell", label, lambda v: le.lane_ell_spmv(M, v),
            lambda v: le.lane_ell_spmv_plain(M, v), le.lane_ell_spmv, x)
        n, item = A.n_rows, x.element_size()
        nbytes = M.K * n * (item + 4) + 2 * n * item
        bound = _bound(nbytes, 2 * M.K * n)
        csr_bytes = A.nnz * (item + 4) + 2 * n * item
        print(f"[lane-ell] {SBAND} {str(dt)[6:]} bound_ms="
              f"{bound['bound_ms']:.4f} ({bound['bound_by']}: {M.K} slots x "
              f"{n} rows x {item + 4} B + x + y = {nbytes / 1e6:.1f} MB; the "
              f"CSR itself {csr_bytes / 1e6:.1f} MB, padding "
              f"{nbytes / csr_bytes:.2f}x) kernel_GB/s="
              f"{nbytes / (ms * 1e6):.0f}")
        if dt == torch.float32:
            C = _csr_on_card(torch, A, dt)
            lib_ms = _median_ms(lambda: C @ x, torch)
            y = le.lane_ell_spmv(M, x)
            lib_rel = float((C @ x - y).abs().max() / y.abs().max())
            print(f"[library] {SBAND} f32 torch.sparse_csr_tensor @ x: "
                  f"ms={lib_ms:.4f} max_rel_err={lib_rel:.3e}")
            if not lib_rel <= TOL["float32"]:
                raise RuntimeError("the library SpMV disagrees")
            record = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "library_ms": lib_ms, **bound}
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
        ms, plain_ms, worst, works = [], [], 0.0, []
        for B in (L, U):
            for li, (c, groups) in enumerate(B.levels):
                if not groups:
                    continue
                label = (f"{BAND} {str(dt)[6:]} {'U' if B is U else 'L'} "
                         f"level {li} (colour {c}, {len(groups)} groups; "
                         f"host CSR {gen_s:.2f} s, pair {build_s:.2f} s)")
                e, k, p = _kernel_vs_plain(
                    torch, "rankspace", label,
                    lambda v: bk.rank_level(B, li, Y, v.clone()),
                    lambda v: bk.rank_level_plain(B, li, Y, v.clone()),
                    bk.rank_level, X, plain_reps=6)
                worst, ms, plain_ms = max(worst, e), ms + [k], plain_ms + [p]
                works.append(_rank_level_work(B, li, X.element_size()))
        y = torch.randn(A.n_rows, dtype=dt, device="cuda", generator=g)
        before = bk.rank_level.launches
        zk = bk.blocked_sgs(L, U, y)
        launches = bk.rank_level.launches - before
        Lc, Uc = (dataclasses.replace(B, vals=B.vals.cpu(), dinv=B.dinv.cpu(),
                                      d=None if B.d is None else B.d.cpu(),
                                      _tables={}) for B in (L, U))
        zp = bk.blocked_sgs(Lc, Uc, y.cpu()).cuda()
        apply_ms = _median_ms(lambda: bk.blocked_sgs(L, U, y), torch)
        print(f"[rankspace] {BAND} {str(dt)[6:]} blocked_sgs ({launches} "
              f"level launches) against the CPU's plain solve: "
              f"bit_equal={torch.equal(zk, zp)} ms={apply_ms:.4f}")
        if not torch.equal(zk, zp) or launches != 4:
            raise RuntimeError(f"{BAND} {dt}: blocked_sgs disagrees or took "
                               f"{launches} level launches, not 4")
        if dt == torch.float32:
            record = {"max_abs_err": worst, "ms": statistics.mean(ms),
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
          f"setup_s={setup_s:.3f} r0={res.residual_norms[0]:.6e} "
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
                c["lane_ell_spmv"] >= iters if fmt == "lane_ell"
                else c["lane_ell_spmv"] == 0)))
        if fmt == "lane_ell":
            launches["lane_ell_spmv"] = counts["lane_ell_spmv"]
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
                      and c["dia_spmv"] >= 2 * 800))
    launches["rank_level"] = counts["rank_level"]
    del setup
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
              f"cpu={cs:.2f} card={gs:.2f}")
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
          f"preprocessing {setup_s:.3f} s")
    if not (L.is_plane and type(L).__name__ == "SuperBlockTriSolve"):
        raise RuntimeError(f"{FDM_5B} ILU(0) did not build a plane pair")
    return setup, gen_s, setup_s


def phase_plane_level_vs_plain(torch, bt, setup):
    """K1 (plane mode of #9) and the per-row D of const mode against their
    plain versions on every level of the fdm:2048 ILU(0) pair's L and U, f32
    and (the pair widened) f64, bit for bit; whole applies; the split
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
        res = {}
        for B in (L, U):
            res[B.upper] = _check_levels(torch, bk, label, B, y, x,
                                         range(len(B.levels)),
                                         tag="plane-level")
        zk = bk.blocked_ilu0(L, U, y)
        zp = _plain_ilu0(bk, L, U, y)
        torch.cuda.synchronize()
        apply_ms = _median_ms(lambda: bk.blocked_ilu0(L, U, y), torch)
        works = [_plane_level_work(B, li, x.element_size()) for B in (L, U)
                 for li in range(len(B.levels))]
        bound = _bound(sum(b for b, _o in works), sum(o for _b, o in works))
        print(f"[plane-level] {label} blocked_ilu0 (2x{L.S} levels) against "
              f"the plain levels: bit_equal={torch.equal(zk, zp)} "
              f"ms={apply_ms:.4f} bound_ms={bound['bound_ms']:.4f} "
              f"({bound['bound_by']}, at the float32 rate)")
        if not torch.equal(zk, zp):
            raise RuntimeError(f"{label}: whole ILU(0) apply disagrees")
        if dt == torch.float32:
            ms, plain_ms, worst = res[False]
            record = {"max_abs_err": worst, "ms": statistics.mean(ms),
                      "plain_ms": statistics.mean(plain_ms),
                      "library_ms": None,
                      **_mean_bound([_plane_level_work(L, li, 4)
                                     for li in range(len(L.levels))])}
        del zk, zp, x, y
    split_records, whole = _plane_split(torch, bk, L32, U32)
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


def _plane_split(torch, bk, L32, U32):
    """The split route's kernels in plane mode against plain on every level
    of the pair in plane form, bit for bit, each timed; then whole applies
    on the fused and the split route in turns (fused, split, split,
    fused), equal bit for bit."""
    Ls, Us = _as_planes(L32, torch), _as_planes(U32, torch)
    n, m = L32.n_rows, L32.m
    g = torch.Generator(device="cuda").manual_seed(13)
    y = torch.randn(n, device="cuda", generator=g)
    x = torch.randn(n, device="cuda", generator=g)
    acc_k, acc_p = (torch.empty(m, device="cuda") for _ in range(2))
    t = {"acc": [], "acc_plain": [], "par": [], "par_plain": []}
    work = {"acc": [], "par": []}
    for B in (Ls, Us):
        for li, (_sb, cross, _s) in enumerate(B.levels):
            if cross:
                before = bk.super_acc.launches
                bk.super_acc(B, li, y, x, acc_k)
                bk.super_acc_plain(B, li, y, x, acc_p)
                torch.cuda.synchronize()
                if (bk.super_acc.launches != before + 1
                        or not torch.equal(acc_k, acc_p)):
                    raise RuntimeError(f"plane super_acc disagrees or was "
                                       f"not counted on level {li}")
                t["acc"].append(_median_ms(
                    lambda: bk.super_acc(B, li, y, x, acc_k), torch))
                t["acc_plain"].append(_median_ms(
                    lambda: bk.super_acc_plain(B, li, y, x, acc_p), torch,
                    reps=3, batch=3))
                work["acc"].append(_plane_level_work(B, li, 4, "acc"))
            a = acc_k if cross else None
            for p in bk._parity_order(B):
                xk, xp = x.clone(), x.clone()
                before = bk.super_parity.launches
                bk.super_parity(B, li, p, y, a, xk)
                bk.super_parity_plain(B, li, p, y, a, xp)
                torch.cuda.synchronize()
                if (bk.super_parity.launches != before + 1
                        or not torch.equal(xk, xp)):
                    raise RuntimeError(f"plane super_parity disagrees or was "
                                       f"not counted: level {li} parity {p}")
                t["par"].append(_median_ms(
                    lambda: bk.super_parity(B, li, p, y, a, xk), torch))
                t["par_plain"].append(_median_ms(
                    lambda: bk.super_parity_plain(B, li, p, y, a, xp), torch,
                    reps=3, batch=3))
                work["par"].append(_plane_level_work(B, li, 4, "parity"))
            print(f"[plane-split] {FDM_5B} f32 {'U' if B.upper else 'L'} "
                  f"level {li}: plane super_acc and super_parity "
                  f"bit_equal=True acc_ms="
                  f"{t['acc'][-1] if cross else 0:.4f} parity_ms="
                  f"{t['par'][-2]:.4f},{t['par'][-1]:.4f}")
    ab = {"fused": [], "split": []}
    out = {}
    for route in ("fused", "split", "split", "fused"):
        pair = (L32, U32) if route == "fused" else (Ls, Us)
        out[route] = bk.blocked_ilu0(*pair, y)
        ab[route].append(_median_ms(lambda: bk.blocked_ilu0(*pair, y), torch))
    equal = torch.equal(out["fused"], out["split"])
    print(f"[plane-split] {FDM_5B} f32 whole apply A/B in turns: fused_ms="
          f"{ab['fused']} split_ms={ab['split']} bit_equal={equal}")
    if not equal:
        raise RuntimeError("split and fused fdm:2048 applies differ")
    records = {name: {"max_abs_err": 0.0, "ms": statistics.mean(t[key]),
                      "plain_ms": statistics.mean(t[key + "_plain"]),
                      "library_ms": None, **_mean_bound(work[key])}
               for name, key in (("super_acc", "acc"),
                                 ("super_parity", "par"))}
    print(f"[plane-split] {FDM_5B} f32 plane mode, means over the levels: "
          + "; ".join(f"{name} ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
                      f"bound_ms={r['bound_ms']:.5f} ({r['bound_by']})"
                      for name, r in records.items()))
    del Ls, Us, x, y, acc_k, acc_p, out
    torch.cuda.empty_cache()
    return records, {"fused_ms": ab["fused"], "split_ms": ab["split"]}


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


def phase_mega_vs_per_level(torch, bt):
    """K2 (#12, the one-launch const solve) against the per-level route and
    the plain per-level loop on the const SGS pair of HPCG 128^3, f32 and
    f64, bit for bit: the L solve, the U solve and the U solve in place;
    each route timed; and the f32 L solve through torch.triangular_solve on
    the colour-sorted sparse triangle, the library's nearest call.  Returns
    the f32 record (ms: one whole L solve)."""
    from basic_iterative_solvers_tpu_torch.coloring import spec_for_device
    from basic_iterative_solvers_tpu_torch.ops import block_trisolve as bk
    record = None
    for dt in (torch.float32, torch.float64):
        A = bt.stencil_op.from_source_operator(MAIN_SPEC, dt, device="cuda")
        L, U = bk.build_superblock_gs_pair_stencil(A, spec_for_device(A),
                                                   dtype=dt, need_d=True)
        g = torch.Generator(device="cuda").manual_seed(15)
        y = torch.randn(A.n_rows, dtype=dt, device="cuda", generator=g)
        label = f"{MAIN_SPEC} {str(dt)[6:]}"

        def per_level(B, yy, xx):
            for li in range(len(B.levels)):
                bk.super_level(B, li, yy, xx)
            return xx

        for B in (L, U):
            before = bk.super_solve_mega.launches
            xk = bk.super_solve_mega(B, y, torch.empty_like(y))
            xl = per_level(B, y, torch.empty_like(y))
            xp = bk.super_solve_mega_plain(B, y, torch.empty_like(y))
            tk, tl = y.clone(), y.clone()
            bk.super_solve_mega(B, tk, tk)
            per_level(B, tl, tl)
            torch.cuda.synchronize()
            if bk.super_solve_mega.launches != before + 2:
                raise RuntimeError("the one-launch count did not grow by 2")
            equal = (torch.equal(xk, xl) and torch.equal(xk, xp)
                     and torch.equal(tk, tl))
            out = torch.empty_like(y)
            ms = _median_ms(lambda: bk.super_solve_mega(B, y, out), torch)
            lvl_ms = _median_ms(lambda: per_level(B, y, out), torch)
            plain_ms = _median_ms(
                lambda: bk.super_solve_mega_plain(B, y, out), torch, reps=5,
                batch=2)
            works = [_level_work(B, li, y.element_size())
                     for li in range(len(B.levels))]
            bound = _bound(sum(b for b, _o in works),
                           sum(o for _b, o in works))
            print(f"[mega] {label} {'U' if B.upper else 'L'} solve "
                  f"({len(B.levels)} const levels, grid "
                  f"{bk.mega_grid(B, 'cuda')} blocks): bit_equal={equal} "
                  f"(per-level route, plain, in place) one_launch_ms={ms:.4f} "
                  f"per_level_ms={lvl_ms:.4f} plain_ms={plain_ms:.4f} "
                  f"bound_ms={bound['bound_ms']:.4f} ({bound['bound_by']})")
            if not equal:
                raise RuntimeError(f"{label}: the one-launch solve disagrees")
            if dt == torch.float32 and not B.upper:
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
                del M, yp, sol, ref
                record = {"max_abs_err": float((xk - xl).abs().max()),
                          "ms": ms, "plain_ms": plain_ms,
                          "per_level_ms": lvl_ms, "library_ms": lib_ms,
                          **bound}
        del A, L, U, y
        torch.cuda.empty_cache()
    return record


def phase_mega_rows(torch, bt):
    """The bench's sgs and pcg rows on HPCG 128^3 (1200 iterations, f32,
    tolerance 0) with MEGA on and off in turns (on, off, off, on), each
    after a warm-up solve with every counter set to 0 just before the timed
    solve and read just after: 2 one-launch solves an apply with MEGA, 8
    level launches without.  Returns the one-launch solve's launches over
    the MEGA runs."""
    import math
    from basic_iterative_solvers_tpu_torch.ops import block_trisolve as bk
    from basic_iterative_solvers_tpu_torch.ops import gmres_basis as gb
    from basic_iterative_solvers_tpu_torch.solvers import make_method
    so = bt.stencil_op
    S, P = bt.SolverType, bt.PrecondType
    mega_launches = 0
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
                if not (res.iter_count == iters
                        and math.isfinite(res.final_residual_norm)):
                    raise RuntimeError(f"{name} MEGA={mega} run failed")
        finally:
            bk.MEGA = False
        on, off = counts[True], counts[False]
        per = {k: {key: round(c[key] / iters, 3) for key in
                   ("super_level", "super_solve_mega")}
               for k, c in (("on", on), ("off", off))}
        print(f"[mega] {MAIN_SPEC} f32 {name} fused, MEGA in turns (on, "
              f"off, off, on): ms/iter on={[f'{v:.5f}' for v in ms[True]]} "
              f"off={[f'{v:.5f}' for v in ms[False]]} launches/iter={per}")
        if not (on["super_level"] == 0 and off["super_solve_mega"] == 0
                and on["super_solve_mega"] > 0
                and off["super_level"] == 4 * on["super_solve_mega"]):
            raise RuntimeError(f"{name}: the routes' launch counts do not "
                               f"match: {per}")
    return mega_launches


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
              f"CSR {gen_s:.3f} s, preprocessing {s_s:.3f} s")
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
        bt.solve(st, method=solver)                       # warm-up solve
        _row_counts(bt, reset=True)
        res = bt.solve(st, method=solver)
        counts = _row_counts(bt)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        ms = 1e3 * res.solve_seconds / max(1, res.iter_count)
        per_iter = {k: round(v / res.iter_count, 3)
                    for k, v in counts.items() if v}
        print(f"[slice5b] {spec} f32 {name} fused: iters={res.iter_count} "
              f"ms/iter={ms:.5f} setup_s={s_s:.3f} peak_GB={peak_gb:.3f} "
              f"r0={res.residual_norms[0]:.6e} "
              f"final_explicit_f64={res.final_residual_norm:.6e} "
              f"launches={ {k: v for k, v in counts.items() if v} } "
              f"launches/iter={per_iter}")
        if not (res.iter_count == iters
                and math.isfinite(res.final_residual_norm)
                and bool(torch.isfinite(res.x_star).all())
                and all(counts[k] == v for k, v in want.items())
                and counts["super_solve_mega"] == 0):
            raise RuntimeError(f"slice-5b {name} failed its checks: "
                               f"{counts} against {want}")
        out[name] = counts
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
          f"cpu={cs:.2f} card={gs:.2f}")
    if (c.iter_count != g.iter_count or not (c.converged and g.converged)
            or g.final_residual_norm > 10 * 1e-8 * r0):
        raise RuntimeError("fdm:256 coloured CG + ILU(0): CPU and card "
                           "differ or did not converge")
    _check_history(g, c)
    return out["pcg_ilu0@fdm2048"]["super_level_plane"]


def main():
    import torch
    name = phase_device(torch)
    import basic_iterative_solvers_tpu_torch as bt
    phase_build()
    from basic_iterative_solvers_tpu_torch.ops import gmres_basis
    record = phase_kernel_vs_plain(torch, bt.stencil_op)
    basis_records = phase_basis_vs_plain(torch, gmres_basis)
    phase_cpu_vs_card(torch, bt)
    phase_cpu_vs_card_slice2(torch, bt)
    launches, _ = phase_main_path(torch, bt)
    slice2_launches = phase_slice_path(torch, bt)
    phase_capacity(torch, bt)
    gs_record = phase_gs_step_vs_plain(torch, bt)
    level_record = phase_super_level_vs_plain(torch, bt)
    phase_cpu_vs_card_slice3(torch, bt)
    super_launches, gs_launches = phase_slice3_path(torch, bt)
    table_record, whole_l = phase_ilu0_level_vs_plain(torch, bt)
    split_records, ab = phase_split_vs_plain(torch, bt)
    phase_cpu_vs_card_ilu0(torch, bt)
    slice4_launches = phase_slice4_path(torch, bt)
    dia_record = phase_dia_vs_plain(torch, bt)
    lane_record, sband = phase_lane_ell_vs_plain(torch, bt)
    rank_record, band = phase_rankspace_vs_plain(torch, bt)
    phase_cpu_vs_card_slice5(torch, bt)
    slice5_launches = phase_slice5_path(torch, bt, sband, band)
    del sband, band
    setup5b, _gen5b, setup5b_s = phase_slice5b_build(torch, bt)
    plane_launches = phase_slice5b_rows(torch, bt, setup5b, setup5b_s)
    plane_record, _split5b, whole5b = phase_plane_level_vs_plain(
        torch, bt, setup5b)
    del setup5b
    torch.cuda.empty_cache()
    mega_record = phase_mega_vs_per_level(torch, bt)
    mega_launches = phase_mega_rows(torch, bt)
    print(f"[summary] {FDM_5B} f32 ILU(0): whole L solve "
          f"torch.triangular_solve {whole5b['library_ms']:.4f} ms, "
          f"blocked_trisolve {whole5b['blocked_trisolve_ms']:.4f} ms; "
          f"apply fused {whole5b['fused_ms']} ms, split "
          f"{whole5b['split_ms']} ms (in turns); {MAIN_SPEC} f32 const L "
          f"solve: one launch {mega_record['ms']:.4f} ms, per level "
          f"{mega_record['per_level_ms']:.4f} ms")
    print(f"[summary] whole L solve at {MAIN_SPEC} f32: "
          f"torch.triangular_solve {whole_l['library_ms']:.4f} ms, "
          f"blocked_trisolve {whole_l['blocked_trisolve_ms']:.4f} ms; "
          f"{ILU_384} f32 ILU(0) apply: fused {ab['fused']} ms, split "
          f"{ab['split']} ms (in turns)")
    src = "basic_iterative_solvers_tpu_torch/csrc/"
    kernels = [{"name": "stencil_spmv", "route": "cuda",
                "source": src + "stencil_spmv.cu",
                "replaces": "basic_iterative_solvers_tpu/stencil_op.py:538",
                "launches": launches, **record}]
    for kernel, line in (("project_gram", 135), ("correct_write", 203)):
        kernels.append({
            "name": kernel, "route": "cuda", "source": src + "gmres_basis.cu",
            "replaces": ("basic_iterative_solvers_tpu/ops/gmres_basis.py:"
                         f"{line}"),
            "launches": slice2_launches[kernel], **basis_records[kernel]})
    kernels.append({
        "name": "stencil_gs_color_step", "route": "cuda",
        "source": src + "stencil_spmv.cu",
        "replaces": "basic_iterative_solvers_tpu/stencil_op.py:660",
        "launches": gs_launches, **gs_record})
    kernels.append({
        "name": "super_level", "route": "cuda",
        "source": src + "block_trisolve.cu",
        "replaces": "basic_iterative_solvers_tpu/ops/block_trisolve.py:1611",
        "launches": super_launches, **level_record})
    # slice 4's kernels: `launches` is the count of the row that is the
    # kernel's main path (pcg_ilu0 at 128^3; the split 384^3 row for the
    # split pair), and `launches_by_row` each row's own count
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
            "launches": slice5_launches[kernel], **record})
    for kernel, line, launched, record in (
            ("super_level_plane", 1611, plane_launches, plane_record),
            ("super_solve_mega", 2171, mega_launches, mega_record)):
        kernels.append({
            "name": kernel, "route": "cuda",
            "source": src + "block_trisolve.cu",
            "replaces": ("basic_iterative_solvers_tpu/ops/block_trisolve.py:"
                         f"{line}"),
            "launches": launched, **record})
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for k in kernels:
        if not set(keys) <= set(k) or not k["launches"]:
            raise RuntimeError(f"kernel record incomplete or never launched "
                               f"on a main path: {k}")
    print(json.dumps({"kernels": [
        {key: k[key] for key in keys + ("launches_by_row",) if key in k}
        for k in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
