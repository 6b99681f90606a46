"""The command line.

The reference's command line (utilities/utilities.hpp:12-108, main.cpp:
17-100) with the JAX package's flags, messages, exit codes and routing
(basic_iterative_solvers_tpu/cli.py):

    python -m basic_iterative_solvers_tpu_torch <matrix> <method-flag> [options]

    <matrix>        .mtx path or generator spec (hpcg:NxNxN, fdm:N,
                    scamac:Anderson,Lx=..,..., band:N,B, sband:N,K,S)
    method flags    -j | -gs | -sgs | -cg | -gm | -bi
    -p <type>       preconditioner: j gs bgs sgs 2st s2st ilu0 cheby mg
                    (--cheby-degree K --cheby-ratio R; --mg-levels L
                    --mg-smooth K --mg-coarse K --mg-transfer
                    linear|injection --mg-coarse-op galerkin|rediscretize)
    -rl <int>       GMRES restart length (default 10)
    -scale <0|1>    symmetric diagonal equilibration
    -perm <mode>    matrix reordering: none|bfs|rcm|color|color_bal
    --gs-mode m     exact GS sweeps: auto|levels|colored
    --kernel-timers per-kernel times: the host harness's synchronized
                    stopwatch table, or under the fused harness the device
                    phase table from a profiled re-run (utils/profile.py)

Options beyond the reference:
    --platform cpu|cuda       where to run; the card unless cpu is asked for
    --dtype float32|float64   (default: float32 on a card, float64 on the CPU)
    --matrix-dtype bfloat16   matrix-data storage dtype (default: --dtype)
    --harness host|fused      (default: fused on a card, host on the CPU)
    --format auto|dia|lane_ell|ell|stencil
    --orthog mgs|cgs2|lowsync|fused   GMRES orthogonalization
    --cg-flavor classic|pipelined  --cg-rr N  --cg-rr-theta T
    --refine K  --refine-inner-tol T   float64 iterative refinement
    --gmres-basis DT          GMRES basis storage dtype (e.g. bfloat16)
    --iter-times              per-iteration device walls of the fused loop
                              from a profiled re-run
    --profile DIR             a torch.profiler trace of the solve in DIR
    --dump-matrix PATH        the solve-ordering matrix as .mtx
    --debug-checks            the reference's SanityChecker checks
    --max-iters N --tol T --inner K --outer K
"""
from __future__ import annotations

import sys

import numpy as np

from .types import PRECOND_CLI_NAMES, SOLVER_CLI_FLAGS, PrecondType

_USAGE = ("ERROR: parse_cli: Not enough arguments given. A call should "
          "contain:\n  python -m basic_iterative_solvers_tpu_torch "
          "<matrix> <method> [extra_features]")

#: value-taking options → (destination, converter, into opts or extras)
_VALUE_OPTS = {
    "-rl": ("restart_length", int, "opts"),
    "-scale": ("num_scale", lambda v: bool(int(v)), "opts"),
    "-perm": ("perm_mode", str, "opts"),
    "--gs-mode": ("gs_mode", str, "extras"),
    "--orthog": ("orthog_mode", str, "extras"),
    "--cg-flavor": ("cg_flavor", str, "extras"),
    "--cg-rr": ("cg_rr_period", int, "extras"),
    "--cg-rr-theta": ("cg_rr_theta", float, "extras"),
    "--cheby-degree": ("cheby_degree", int, "extras"),
    "--cheby-ratio": ("cheby_eig_ratio", float, "extras"),
    "--mg-levels": ("mg_levels", int, "extras"),
    "--mg-smooth": ("mg_smooth_degree", int, "extras"),
    "--mg-coarse": ("mg_coarse_degree", int, "extras"),
    "--mg-transfer": ("mg_transfer", str, "extras"),
    "--mg-coarse-op": ("mg_coarse_op", str, "extras"),
    "--refine": ("refine_outer", int, "extras"),
    "--refine-inner-tol": ("refine_inner_tol", float, "extras"),
    "--gmres-basis": ("gmres_basis_dtype", str, "extras"),
    "--dtype": ("dtype", np.dtype, "extras"),
    "--matrix-dtype": ("matrix_dtype", str, "extras"),
    "--harness": ("harness", str, "extras"),
    "--format": ("matrix_format", str, "extras"),
    "--max-iters": ("max_iters", int, "extras"),
    "--tol": ("tolerance", float, "extras"),
    "--inner": ("precond_inner_iters", int, "extras"),
    "--outer": ("precond_outer_iters", int, "extras"),
    "--platform": ("platform", str, "extras"),
    "--profile": ("profile_dir", str, "extras"),
    "--dump-matrix": ("dump_matrix", str, "extras"),
}

#: switches → their extras key
_SWITCHES = {"--debug-checks": "debug_checks",
             "--kernel-timers": "kernel_timers",
             "--iter-times": "iter_times"}


def parse_cli(argv, bench_mode: bool = False) -> tuple:
    """(matrix_source, opts, extras) from argv; SystemExit(2) on too few
    arguments, an unknown method flag or preconditioner, or an option
    missing its value.  An unknown option warns and is skipped, as the
    reference does (utilities.hpp:103-106).  `bench_mode` is the
    reference parser's benchmark-harness variant: the method flag is not
    read (argv is `<matrix> [options...]`)."""
    if len(argv) < (1 if bench_mode else 2):
        print(_USAGE, file=sys.stderr)
        raise SystemExit(2)
    matrix_source = argv[0]
    opts = dict(preconditioner=PrecondType.NONE)
    extras = {}
    if bench_mode:
        args = list(argv[1:])
    else:
        method_flag = argv[1]
        if method_flag not in SOLVER_CLI_FLAGS:
            print("ERROR: parse_cli: Please choose an available solver:"
                  "\n-j (Jacobi)\n-gs (Gauss-Seidel)"
                  "\n-sgs (Symmetric Gauss-Seidel)"
                  "\n-gm ([Preconditioned] GMRES)"
                  "\n-cg ([Preconditioned] Conjugate Gradient)"
                  "\n-bi ([Preconditioned] BiCGSTAB)", file=sys.stderr)
            raise SystemExit(2)
        opts = dict(method=SOLVER_CLI_FLAGS[method_flag],
                    preconditioner=PrecondType.NONE)
        args = list(argv[2:])
    idx = 0
    while idx < len(args):
        arg = args[idx]
        if arg == "-p" or arg in _VALUE_OPTS:
            if idx + 1 >= len(args):
                print(f"ERROR: parse_cli: option {arg} needs a value",
                      file=sys.stderr)
                raise SystemExit(2)
            idx += 1
            val = args[idx]
            if arg == "-p":
                if val not in PRECOND_CLI_NAMES:
                    print("ERROR: assign_cli_inputs: Please choose an "
                          "available preconditioner type:\n-p j (Jacobi)"
                          "\n-p gs (Gauss-Seidel)\n-p bgs (Backwards "
                          "Gauss-Seidel)\n-p sgs (Symmetric Gauss-Seidel)"
                          "\n-p 2st (2 Stage Gauss-Seidel)"
                          "\n-p s2st (Symmetric 2 Stage Gauss-Seidel)"
                          "\n-p ilu0 (Incomplete LU with 0 fill-in)"
                          "\n-p cheby (Chebyshev polynomial)"
                          "\n-p mg (Geometric multigrid V-cycle)",
                          file=sys.stderr)
                    raise SystemExit(2)
                opts["preconditioner"] = PRECOND_CLI_NAMES[val]
            else:
                key, conv, where = _VALUE_OPTS[arg]
                (opts if where == "opts" else extras)[key] = conv(val)
        elif arg in _SWITCHES:
            extras[_SWITCHES[arg]] = True
        else:
            print(f'ERROR: assign_cli_inputs: Argument "{arg}" not '
                  "recognized.", file=sys.stderr)
        idx += 1
    return matrix_source, opts, extras


def _resolve_platform(platform) -> "torch.device":
    """The device --platform names: the card unless "cpu" is asked for;
    with no card a run that asked for none raises, naming the device."""
    import torch
    device = torch.device("cuda" if platform in (None, "cuda", "gpu")
                          else platform)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was asked for (the default), but no "
            "CUDA device is available; pass --platform cpu to run on the "
            "CPU")
    return device


def run(argv=None) -> int:
    """parse → read or generate → preprocess → solve → postprocess (the
    reference's main.cpp:17-100); returns the exit code."""
    import dataclasses

    import torch

    from . import device_path, generators
    from .config import SolverConfig
    from .dia import from_source_device
    from .solvers import make_method, preprocessing, preprocessing_device
    from .solvers import solve
    from .utils.report import roofline_report, summary_output
    from .utils.timers import Timers

    argv = sys.argv[1:] if argv is None else argv
    matrix_source, opts, extras = parse_cli(argv)
    device = _resolve_platform(extras.pop("platform", None))
    on_card = device.type == "cuda"
    if "dtype" not in extras:
        extras["dtype"] = np.dtype(np.float32 if on_card else np.float64)
    if "harness" not in extras:
        extras["harness"] = "fused" if on_card else "host"
    profile_dir = extras.pop("profile_dir", None)
    iter_times = extras.pop("iter_times", False)
    dump_matrix = extras.pop("dump_matrix", None)
    config = SolverConfig(**opts, **extras)
    # the route solve_system takes (the JAX CLI's); it also sets the
    # source's structural colour spec for the blocked multicolour solves
    on_device = device_path(matrix_source, config, device)
    if config.matrix_format == "stencil" and not on_device:
        print("NOTE: --format stencil requires a generator source and a "
              "device-native method/preconditioner; falling back to DIA.",
              file=sys.stderr)
        config = dataclasses.replace(config, matrix_format="auto")

    timers = Timers()
    with timers.time("total"):
        if on_device:
            with timers.time("read_matrix"):
                if config.matrix_format == "stencil":
                    from .stencil_op import from_source_operator
                    A_dev = from_source_operator(
                        matrix_source, dtype=config.mat_dtype(),
                        device=device)
                else:
                    A_dev = from_source_device(
                        matrix_source, dtype=config.mat_dtype(),
                        device=device)
            with timers.time("preprocessing"):
                setup = preprocessing_device(A_dev, config, timers=timers)
        else:
            with timers.time("read_matrix"):
                A = generators.from_source(matrix_source)
            with timers.time("preprocessing"):
                setup = preprocessing(A, config, timers=timers,
                                      device=device)
        if dump_matrix:
            # the reference's OUTPUT_SPARSITY toggle (CMakeLists.txt:33):
            # the solve-ordering matrix, or the generator's for operators
            # built on the device
            from .io.mmio import write_mtx
            if setup.A_host is not None:
                write_mtx(dump_matrix, setup.A_host,
                          comment=f"solve-ordering matrix for "
                                  f"{matrix_source}")
            else:
                write_mtx(dump_matrix, generators.from_source(matrix_source),
                          comment=f"generator matrix {matrix_source} "
                                  "(natural ordering)")
            print(f"wrote {dump_matrix}", file=sys.stderr)

        def milestone(iter_count, residual_norm):
            # relative residuals 1e-3 and 1e-6 (host harness; the
            # reference's solver_harness.hpp:27-37)
            print(f"[milestone] iter {iter_count}: ||r|| = "
                  f"{residual_norm:.6e}", file=sys.stderr)
            print(timers.report(), file=sys.stderr)

        method = make_method(setup)
        with timers.time("solve"):
            if profile_dir:
                result = _profiled_solve(setup, method, timers, milestone,
                                         profile_dir)
            else:
                result = solve(setup, method=method, timers=timers,
                               progress=milestone)
        roofline_secs = None
        if iter_times:
            if config.harness == "fused":
                from .utils.profile import attach_iteration_times
                why = []
                if attach_iteration_times(result, method, why):
                    print("[iter-times] measured device walls attached",
                          file=sys.stderr)
                    walls = np.asarray(result.time_per_iteration)
                    walls = walls[walls > 0]
                    if walls.size:
                        roofline_secs = float(np.median(walls))
                else:
                    print(f"[iter-times] no per-iteration device walls "
                          f"({'; '.join(why)}); times unchanged",
                          file=sys.stderr)
            else:
                print("[iter-times] host harness already records wall "
                      "times per iteration", file=sys.stderr)
        with timers.time("postprocessing"):
            summary_output(result)
            roofline_report(setup, result, secs_per_iter=roofline_secs)
    if config.kernel_timers:
        if config.harness == "fused":
            from .utils.profile import measure_phase_table, print_phase_table
            got = measure_phase_table(method, result.iter_count,
                                      result.gmres_restart_count)
            if got is None:
                print("[kernel-timers] no device trace on this device; use "
                      "--harness host for stopwatch attribution",
                      file=sys.stderr)
            else:
                print_phase_table(*got, n_iters=result.iter_count or None)
        else:
            from .utils.report import print_kernel_report
            print_kernel_report(timers, result)
    else:
        print(timers.report(), file=sys.stderr)
    if on_card:
        torch.cuda.synchronize(device)
    return 0


def _profiled_solve(setup, method, timers, progress, profile_dir):
    """The solve under torch.profiler (CPU activities, and CUDA on a card),
    its chrome trace written to profile_dir/trace.json: the counterpart of
    the reference's LIKWID markers and the JAX package's xprof trace."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    from .solvers import solve
    activities = [ProfilerActivity.CPU]
    if setup.b.is_cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        result = solve(setup, method=method, timers=timers,
                       progress=progress)
        if setup.b.is_cuda:
            torch.cuda.synchronize(setup.b.device)
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"[profile] trace written to {path}", file=sys.stderr)
    return result


if __name__ == "__main__":
    raise SystemExit(run())
