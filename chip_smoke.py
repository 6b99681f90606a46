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
     fdm:2048 through the GS colour-step kernel.
The second-to-last line is a JSON object describing each kernel; the last
is {"ok": true, "device": {...}}.
"""
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
    return record


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
                    records["project_gram"] = {
                        "max_abs_err": pg_abs, "ms": t["pg"],
                        "plain_ms": t["pg_plain"]}
                    records["correct_write"] = {
                        "max_abs_err": float((vk - vp).abs().max()),
                        "ms": t["cw"], "plain_ms": t["cw_plain"]}
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
                record = {"max_abs_err": worst_abs, "ms": ms,
                          "plain_ms": plain_ms}
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
                      "plain_ms": statistics.mean(plain_ms)}
    return record


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
    kernels = {"stencil_spmv": so.stencil_spmv,
               "stencil_gs_color_step": so.stencil_gs_color_step,
               "project_gram": gb.project_gram,
               "correct_write": gb.correct_write,
               "super_level": bk.super_level}
    if reset:
        for fn in kernels.values():
            fn.launches = 0
    return {name: fn.launches for name, fn in kernels.items()}


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
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
