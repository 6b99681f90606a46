"""Port boundaries: no JAX in the port, no kernel launch on CPU tensors,
state carried across from the JAX package, and the kernel's launch table
(the part of the CUDA path that runs in Python)."""
import subprocess
import sys
import pathlib

import numpy as np
import pytest
import torch

from basic_iterative_solvers_tpu import stencil_op as jso

import basic_iterative_solvers_tpu_torch as bt
from basic_iterative_solvers_tpu_torch import convert
from basic_iterative_solvers_tpu_torch import stencil_op as tso

#: the port's entry points run on the card unless asked; these tests
#: run on the CPU
CPU = "cpu"

REPO = pathlib.Path(__file__).resolve().parent.parent
ANDERSON = "anderson:Lx=4,Ly=5,Lz=3,t=1.2,ranpot=4.0,seed=6"


def test_import_loads_no_jax():
    """Importing every module of the port loads no jax module and nothing
    of the JAX package."""
    code = ("import pkgutil, sys, importlib\n"
            "import basic_iterative_solvers_tpu_torch as pkg\n"
            "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
            "pkg.__name__ + '.')]\n"
            "for name in names:\n"
            "    importlib.import_module(name)\n"
            "need = {'matrix', 'permute', 'factor', 'ops.block_trisolve', "
            "'_build', 'device_matrix', 'dia', 'io.mmio', 'ops.dia_spmv', "
            "'ops.lane_ell', 'ops.trisolve', 'generators', 'convert', 'mg', "
            "'parallel', 'parallel.sharded', 'parallel.mesh_ops'}\n"
            "assert {pkg.__name__ + '.' + n for n in need} <= set(names)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'basic_iterative_solvers_tpu' or "
            "m.startswith('basic_iterative_solvers_tpu.')]\n"
            "assert not bad, bad\n"
            "print(len(names))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout) >= 31


def test_cpu_tensors_launch_no_kernel():
    from basic_iterative_solvers_tpu_torch.ops import (block_trisolve,
                                                       dia_spmv, lane_ell)
    counters = (tso.stencil_spmv, dia_spmv.dia_spmv, lane_ell.lane_ell_spmv,
                block_trisolve.rank_level)
    for fn in counters:
        fn.launches = 0
    res = bt.solve_system("hpcg:8x6x4", tolerance=1e-8,
                          matrix_format="stencil", device=CPU)
    assert res.converged
    for source, kw in (("hpcg:8x6x4", {}), ("sband:1500,6,260", {}),
                       ("band:61,2", dict(preconditioner="sgs",
                                          gs_mode="colored"))):
        assert bt.solve_system(source, tolerance=1e-8, device=CPU,
                               **kw).converged
    assert all(fn.launches == 0 for fn in counters)


def test_planar_diag_decode_matches_jax():
    """The planar halo layout decoded in numpy equals the JAX package's
    from_planar_vec, and the carried operator equals one built directly."""
    Ap = jso.to_planar_matrix(jso.from_source_operator(ANDERSON,
                                                       dtype=np.float64))
    planar = np.asarray(Ap.diag)
    assert planar.ndim == 2
    At = convert.stencil_from_numpy(Ap.legs, Ap.coeff_values, Ap.dims,
                                    planar, dtype=torch.float64,
                                    device="cpu")
    np.testing.assert_array_equal(At.diag.numpy(),
                                  np.asarray(jso.from_planar_vec(Ap, Ap.diag)))
    direct = tso.from_source_operator(ANDERSON, torch.float64, device=CPU)
    assert At.legs == direct.legs and At.coeff_values == direct.coeff_values
    assert torch.equal(At.diag, direct.diag)


def test_vector_from_numpy_flat_padded_and_planar(rng):
    Aj = jso.from_source_operator("hpcg:16x16x16", dtype=np.float64)
    At = tso.from_source_operator("hpcg:16x16x16", torch.float64, device=CPU)
    v = rng.standard_normal(Aj.n_rows)
    planar = np.asarray(jso.to_planar_vec(jso.to_planar_matrix(Aj), v))
    padded = np.concatenate([v, np.zeros(7)])
    for form in (v, padded, planar):
        np.testing.assert_array_equal(
            convert.vector_from_numpy(form, At).numpy(), v)
    with pytest.raises(ValueError):
        convert.vector_from_numpy(planar[:-8], At)


def _emulate_kernel(args, x, diag):
    """The CUDA kernel's arithmetic, from its launch table, in numpy."""
    nx, ny, nz = args.nx, args.ny, args.nz
    gz, gy, gx = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx),
                             indexing="ij")
    gx, gy, gz = gx.ravel(), gy.ravel(), gz.ravel()
    i = np.arange(x.size)
    y = np.zeros_like(x)
    for g in range(args.n_groups):
        s = np.zeros_like(x)
        for l in range(args.group_begin[g], args.group_begin[g + 1]):
            px, py, pz = gx + args.dx[l], gy + args.dy[l], gz + args.dz[l]
            ok = ((px >= 0) & (px < nx) & (py >= 0) & (py < ny)
                  & (pz >= 0) & (pz < nz))
            s[ok] += x[i[ok] + args.off[l]]
        y += args.group_coeff[g] * s
    if diag is not None:
        y += diag * x
    return y


@pytest.mark.parametrize("spec,groups", [("hpcg:8x6x4", 2), ("fdm:16", 2),
                                         (ANDERSON, 1)])
def test_launch_table_reproduces_plain_spmv(spec, groups, rng):
    """Legs grouped by coefficient (HPCG: 26 × −1 and 1 × 26; Anderson's
    (0,0,0) leg left to the dense diagonal); the kernel's arithmetic on
    that table equals the plain version to float64 rounding (rtol 1e-12)."""
    A = tso.from_source_operator(spec, torch.float64, device=CPU)
    use_diag = A.diag is not None
    args, n_blocks = tso._launch_table(A.legs, A.coeff_values, A.dims,
                                       use_diag, ("x", "aux"))
    assert args.n_groups == groups
    assert args.group_begin[groups] == len(A.legs) - use_diag
    assert args.block_x * args.block_y == 256
    assert n_blocks == args.grid_x * args.grid_y
    assert args.grid_x * args.block_y >= A.dims[1]
    assert list(args.dot_kind[:args.n_dots]) == [0, 2]
    x = rng.standard_normal(A.n_rows)
    y = _emulate_kernel(args, x, None if not use_diag else A.diag.numpy())
    ref = tso.stencil_spmv_plain(A, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, ref, rtol=1e-12,
                               atol=1e-12 * np.abs(ref).max())


@pytest.mark.parametrize("case", ["dtype", "shape", "aux", "kind",
                                  "operator", "noncontig"])
def test_spmv_rejects_bad_operands(case):
    A = tso.from_source_operator("hpcg:8x6x4", torch.float64, device=CPU)
    x = torch.ones(A.n_rows, dtype=torch.float64)
    call, err = {
        "dtype": (lambda: tso.stencil_spmv(A, x.float()), TypeError),
        "shape": (lambda: tso.stencil_spmv(A, x[:-1]), ValueError),
        "aux": (lambda: tso.stencil_spmv(A, x, dots=("aux",)), ValueError),
        "kind": (lambda: tso.stencil_spmv(A, x, dots=("y",)), ValueError),
        "operator": (lambda: bt.ops.spmv(object(), x), TypeError),
        "noncontig": (lambda: tso.stencil_spmv(
            A, torch.ones(2 * A.n_rows, dtype=torch.float64)[::2]),
            ValueError),
    }[case]
    with pytest.raises(err):
        call()


@pytest.mark.parametrize("kwargs", [
    {"method": bt.SolverType.JACOBI, "kernel_timers": True},
    {"dtype": torch.float32, "matrix_dtype": "bfloat16"},
], ids=["jacobi", "matrix_dtype"])
def test_unported_features_name_their_slice(kwargs):
    """The two features that once named the slice porting them now run:
    per-kernel timers in the host harness (slice 7) fill the timer
    registry, and bfloat16 matrix storage (slice 6b) stores the stencil's
    coefficients in bf16 beside float32 vectors."""
    from basic_iterative_solvers_tpu_torch.utils.timers import Timers
    A = tso.from_source_operator("hpcg:8x6x4", torch.float64, device=CPU)
    cfg = bt.SolverConfig(max_iters=20, **kwargs)
    setup = bt.preprocessing_device(A, cfg)
    timers = Timers()
    res = bt.solve(setup, timers=timers)
    assert res.iter_count == 20 and np.isfinite(res.final_residual_norm)
    if "kernel_timers" in kwargs:
        assert {"spmv", "sum", "norm"} <= set(timers.names())
        assert timers["spmv"].check() > 0
    else:
        assert setup.A.coeffs.dtype == torch.bfloat16
        assert setup.b.dtype == setup.A_D.dtype == torch.float32
        assert not timers.names()


@pytest.mark.parametrize("entry", [
    bt.solve_system, tso.make_stencil, tso.stencil_27pt_operator,
    tso.fdm_2d_operator, tso.anderson_operator, tso.from_source_operator],
    ids=lambda f: f.__name__)
def test_entry_points_default_to_the_card(entry, monkeypatch):
    """The entry points put the operator on the card unless the caller
    asks for the CPU; with no card a call that names no device raises,
    naming the device, and builds nothing on the CPU."""
    import inspect
    assert inspect.signature(entry).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = {"solve_system": ("hpcg:4x4x4",),
            "make_stencil": ([((0, 0, 0), 2.0)], 4, 4, 4),
            "from_source_operator": ("hpcg:4x4x4",)}.get(entry.__name__,
                                                         (4,))
    with pytest.raises(RuntimeError, match="'cuda'.*device='cpu'"):
        entry(*args)
    assert entry(*args, device=CPU) is not None


def test_spmv_entry_points_match_plain(rng):
    """spmv_dots returns (y, y·aux, y·y) in that order, and
    compute_residual is b − A·x, all from the one SpMV call."""
    from basic_iterative_solvers_tpu_torch.ops.spmv import (
        compute_residual, spmv_dot, spmv_dots)
    A = tso.from_source_operator(ANDERSON, torch.float64, device=CPU)
    x, aux, b = (torch.from_numpy(rng.standard_normal(A.n_rows))
                 for _ in range(3))
    y = tso.stencil_spmv_plain(A, x)
    got = spmv_dots(A, x, aux=aux, with_self=True)
    assert len(got) == 3 and torch.equal(got[0], y)
    torch.testing.assert_close(got[1], torch.dot(y, aux))
    torch.testing.assert_close(got[2], torch.dot(y, y))
    assert len(spmv_dots(A, x)) == 1
    torch.testing.assert_close(spmv_dot(A, x)[1], torch.dot(y, x))
    assert torch.equal(compute_residual(A, x, b), b - y)
