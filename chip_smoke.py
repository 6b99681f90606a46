"""Drive the PyTorch/CUDA port (basic_iterative_solvers_tpu_torch) on one
NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the script
exits non-zero:
  1. device: the card's name and power limit;
  2. build: compile the CUDA kernels from this checkout;
  3. kernel against its plain PyTorch version on the card, at the main
     path's shapes, both timed;
  4. the same CG solve on the CPU (plain path) and on the card (kernel);
  5. the main path: CG on HPCG 128^3 in float32 through the public entry
     points, 2500 iterations, counting the kernel's launches; then a
     float64 solve of the same operator to convergence;
  6. capacity: CG on HPCG 384^3 in float32.
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
    print(f"[build] stencil_spmv.cu built and loaded in "
          f"{time.perf_counter() - t0:.2f} s")


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


def _hpcg_cg(torch, bt, spec, dtype, **cfg_kw):
    A = bt.stencil_op.from_source_operator(spec, dtype, device="cuda")
    n = A.n_rows
    cfg = bt.SolverConfig(method=bt.SolverType.CONJUGATE_GRADIENT,
                          preconditioner=bt.PrecondType.NONE, dtype=dtype,
                          harness="fused", **cfg_kw)
    # the bench's reference setup: b = 2, x0 = 1
    return bt.preprocessing_device(
        A, cfg, b=torch.full((n,), 2.0, dtype=dtype, device="cuda"),
        x0=torch.full((n,), 1.0, dtype=dtype, device="cuda"))


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


def main():
    import torch
    name = phase_device(torch)
    import basic_iterative_solvers_tpu_torch as bt
    phase_build()
    record = phase_kernel_vs_plain(torch, bt.stencil_op)
    phase_cpu_vs_card(torch, bt)
    launches, _ = phase_main_path(torch, bt)
    phase_capacity(torch, bt)
    kernel = {"name": "stencil_spmv", "route": "cuda",
              "source": ("basic_iterative_solvers_tpu_torch/csrc/"
                         "stencil_spmv.cu"),
              "replaces": "basic_iterative_solvers_tpu/stencil_op.py:538",
              "launches": launches, **record}
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
