"""One rank of the PyTorch port's GSPMD-mode tests (test_torch_gspmd.py,
test_torch_census.py): a process of a gloo group on the CPU that runs
every case of a suite on `make_device_mesh()` and writes its results,
NumPy values only, for the test to hold against the JAX package.

    python tests/torch_gspmd_ranks.py SUITE CASES RANK WORLD STORE OUT

CASES is a comma-separated list of the suite's cases ("all": every one);
a solve case "name:mode" runs `shard_setup(..., mode=mode)`.  STORE is the
path of the group's FileStore (one per run, so concurrent runs never share
an address); OUT the directory the rank writes `rank{RANK}.pkl` to.  The
rank imports torch and the port, never jax, and records whether jax got
loaded.  A case that raises records its traceback; the others still run.
The fused loops read their condition every 8 steps here, not 64
(`solvers/fused.CHECK_EVERY`): fewer gated no-op steps past a stop, the
same results.
"""
import datetime
import os
import pickle
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import basic_iterative_solvers_tpu_torch as bt  # noqa: E402
from basic_iterative_solvers_tpu_torch.ops.blas1 import (  # noqa: E402
    dot, full_value)
from basic_iterative_solvers_tpu_torch.parallel import (  # noqa: E402
    collective_census, fused_collective_census, make_device_mesh,
    shard_setup)

CPU = "cpu"
MODES = ("gspmd", "auto")


def cfg(method="CONJUGATE_GRADIENT", precond="NONE", **kw):
    kw.setdefault("dtype", torch.float64)
    kw.setdefault("tolerance", 1e-11)
    kw.setdefault("harness", "fused")
    return bt.SolverConfig(method=bt.SolverType[method],
                           preconditioner=bt.PrecondType[precond], **kw)


def result(res) -> dict:
    return {"converged": bool(res.converged), "iter_count": res.iter_count,
            "x": full_value(res.x_star).detach().cpu().numpy(),
            "restarts": res.gmres_restart_count,
            "outers": res.refine_outer_count,
            "final": res.final_residual_norm,
            "stop": res.stopping_criteria,
            "norms": np.asarray(res.residual_norms)}


def solves(name, make_setup) -> dict:
    """The solve case `name` in each mode ("name:gspmd", "name:auto"),
    from a fresh set-up each time."""
    return {f"{name}:{mode}": (lambda mesh, mode=mode: result(bt.solve(
        shard_setup(make_setup(), mesh, mode=mode)))) for mode in MODES}


def dia_setup(method, precond, **kw):
    return lambda: bt.preprocessing_device(bt.dia.stencil_27pt_device(
        8, 8, 8, dtype=torch.float64, device=CPU),
        cfg(method, precond, precond_inner_iters=1, **kw))


def stencil_setup(spec, method, precond, **kw):
    return lambda: bt.preprocessing_device(bt.stencil_op.from_source_operator(
        spec, torch.float64, device=CPU), cfg(method, precond, **kw))


def host_setup(spec, c, **kw):
    return lambda: bt.preprocessing(bt.generators.from_source(spec), c,
                                    device=CPU, **kw)


# ---------------------------------------------------------------------------
# The gspmd suite
# ---------------------------------------------------------------------------

PAIRS = {"cg_none": ("CONJUGATE_GRADIENT", "NONE"),
         "cg_j": ("CONJUGATE_GRADIENT", "JACOBI"),
         "bi_s2st": ("BICGSTAB", "SYMMETRIC_TWO_STAGE_GS"),
         "gm_2st": ("GMRES", "TWO_STAGE_GS"),
         "jacobi": ("JACOBI", "NONE")}


def case_sharding(mesh):
    s = shard_setup(dia_setup("CONJUGATE_GRADIENT", "JACOBI")(), mesh)
    return {"A": type(s.A).__name__, "data_local": tuple(s.A.data_local.shape),
            "data": tuple(s.A.inner.data.shape),
            "placements": [str(p) for v in (s.b, s.x0, s.M.A_D)
                           for p in v.placements],
            "b_local": tuple(s.b.to_local().shape),
            "rank": mesh.get_local_rank()}


def case_refusals(mesh):
    out = {}
    tries = {
        "indivisible": lambda: shard_setup(bt.preprocessing_device(
            bt.dia.banded_device(102, bandwidth=1, dtype=torch.float64,
                                 device=CPU), cfg()), mesh),
        "lines": lambda: shard_setup(stencil_setup(
            "fdm:10", "CONJUGATE_GRADIENT", "NONE")(), mesh),
        "shard_map": lambda: shard_setup(dia_setup(
            "CONJUGATE_GRADIENT", "NONE")(), mesh, mode="shard_map"),
        "format": lambda: shard_setup(host_setup("fdm:8", cfg(
            matrix_format="ell"))(), mesh, mode="gspmd"),
    }
    for name, f in tries.items():
        try:
            f()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def case_lane_ell(mesh):
    out = {}
    for spec in ("sband:1024,6,40", "sband:1000,6,40"):
        c = cfg(matrix_format="lane_ell")
        s = shard_setup(host_setup(spec, c)(), mesh)
        out[spec] = dict(result(bt.solve(s)),
                         op=type(s.A).__name__, gather=s.A.gather)
    return out


def refine_setup():
    c = cfg(precond="JACOBI", dtype=torch.float32, tolerance=1e-12,
            refine_outer=5)
    return bt.preprocessing_device(bt.dia.stencil_27pt_device(
        8, 16, 8, dtype=torch.float32, device=CPU), c)


def case_gmres_fused(mesh):
    """f32 fused-mode GMRES: #6 and #7 on each rank's columns of V, held
    against the port's single-device solve."""
    c = cfg("GMRES", "JACOBI", dtype=torch.float32, tolerance=1e-5,
            orthog_mode="fused", restart_length=12)
    make = lambda: bt.preprocessing_device(  # noqa: E731
        bt.dia.stencil_27pt_device(8, 8, 8, dtype=torch.float32, device=CPU),
        c)
    return {"one": result(bt.solve(make())),
            "gspmd": result(bt.solve(shard_setup(make(), mesh)))}


def case_host_harness(mesh):
    make = dia_setup("CONJUGATE_GRADIENT", "JACOBI", harness="host")
    return {"one": result(bt.solve(make())),
            "gspmd": result(bt.solve(shard_setup(make(), mesh)))}


def case_item_trap(mesh):
    """A dot's local partial against the host helper's read."""
    s = shard_setup(dia_setup("CONJUGATE_GRADIENT", "NONE")(), mesh)
    v = torch.arange(s.b.shape[0], dtype=torch.float64)
    x = bt.parallel.gspmd.shard_rows(v, mesh)
    d = torch.dot(x, x)
    return {"partial_item": d.item(), "full": float(full_value(d)),
            "dot": float(full_value(dot(x, x))),
            "dot_placements": [str(p) for p in dot(x, x).placements],
            "global": float(v @ v)}


def case_counts(mesh):
    """The halo exchanges of one stencil SpMV, and which entry points the
    DTensor operators call: each halo-form kernel's wrapper, counted here
    by a stand-in around it (on the CPU they run their plain versions)."""
    from basic_iterative_solvers_tpu_torch.parallel import mesh_ops
    from basic_iterative_solvers_tpu_torch.parallel.gspmd import HALO_COUNTS
    names = ("stencil_spmv_halo", "stencil_gs_color_step_halo",
             "dia_spmv_halo", "lane_ell_spmv_halo")
    calls = dict.fromkeys(names, 0)
    saved = {k: getattr(mesh_ops, k) for k in names}

    def counted(k):
        def run(*a, **kw):
            calls[k] += 1
            return saved[k](*a, **kw)
        return run

    for k in names:
        setattr(mesh_ops, k, counted(k))
    try:
        before = dict(HALO_COUNTS)
        s = shard_setup(stencil_setup("hpcg:8x8x8", "CONJUGATE_GRADIENT",
                                      "NONE")(), mesh)
        y = bt.ops.spmv(s.A, s.b)
        out = {"permutes": HALO_COUNTS["collective-permute"]
               - before["collective-permute"],
               "bytes": HALO_COUNTS["bytes"] - before["bytes"],
               "y": full_value(y).numpy(), "op": type(s.A).__name__}
        g = shard_setup(stencil_setup(
            "hpcg:8x8x8", "CONJUGATE_GRADIENT", "SYMMETRIC_GAUSS_SEIDEL",
            planar_vectors="on")(), mesh)
        bt.apply_preconditioner(g.M, g.b)
        d = shard_setup(dia_setup("CONJUGATE_GRADIENT", "NONE")(), mesh)
        bt.ops.spmv(d.A, d.b)
        e = shard_setup(host_setup("sband:1024,6,40", cfg(
            matrix_format="lane_ell"))(), mesh)
        bt.ops.spmv(e.A, e.b)
    finally:
        for k in names:
            setattr(mesh_ops, k, saved[k])
    out["calls"] = calls
    return out


GSPMD = {}
for _k, (_m, _p) in PAIRS.items():
    GSPMD.update(solves(f"pair_{_k}", dia_setup(_m, _p)))
GSPMD.update(sharding=case_sharding, refusals=case_refusals,
             lane_ell=case_lane_ell, gmres_fused=case_gmres_fused,
             host_harness=case_host_harness, item_trap=case_item_trap,
             counts=case_counts)
GSPMD.update(solves("planar", stencil_setup(
    "hpcg:8x8x8", "CONJUGATE_GRADIENT", "JACOBI", planar_vectors="on")))
GSPMD.update(solves("refine", refine_setup))
GSPMD["refine_one"] = lambda mesh: result(bt.solve(refine_setup()))
GSPMD.update(solves("mg", stencil_setup(
    "hpcg:8x8x8", "CONJUGATE_GRADIENT", "MULTIGRID", planar_vectors="on")))
GSPMD.update(solves("colored_sgs", dia_setup(
    "CONJUGATE_GRADIENT", "SYMMETRIC_GAUSS_SEIDEL")))
GSPMD.update(solves("colored_gs_solver", lambda: bt.preprocessing_device(
    bt.dia.fdm_2d_device(16, dtype=torch.float64, device=CPU),
    cfg("SYMMETRIC_GAUSS_SEIDEL", tolerance=1e-7, max_iters=2000))))
GSPMD.update(solves("ilu0", host_setup("hpcg:8x8x8", cfg(
    precond="ILU0", gs_mode="colored", tolerance=1e-10,
    color_spec=bt.generators.color_spec_for_source("hpcg:8x8x8")))))
GSPMD.update(solves("wide_halo", stencil_setup(
    "hpcg:8x8x4", "CONJUGATE_GRADIENT", "JACOBI")))
GSPMD.update(solves("wide_halo_gs", stencil_setup(
    "hpcg:8x8x4", "CONJUGATE_GRADIENT", "SYMMETRIC_GAUSS_SEIDEL",
    planar_vectors="on")))


# ---------------------------------------------------------------------------
# The census suite
# ---------------------------------------------------------------------------

def census_dia(method, precond):
    def run(mesh):
        c = cfg(method, precond, precond_inner_iters=1)
        s = shard_setup(bt.preprocessing_device(bt.dia.stencil_27pt_device(
            16, 16, 16, dtype=torch.float64, device=CPU), c), mesh,
            mode="gspmd")
        return fused_collective_census(s)
    return run


def census_replicated(mesh):
    """A replicated preconditioner (multigrid): its apply gathers the
    vector whole once an iteration."""
    s = shard_setup(stencil_setup("hpcg:16x16x16", "CONJUGATE_GRADIENT",
                                  "MULTIGRID")(), mesh)
    return fused_collective_census(s)


def census_negative(mesh):
    """The pad-and-slice SpMV on a row-sharded DTensor: DTensor gathers x
    whole to partition the slices."""
    from basic_iterative_solvers_tpu_torch.parallel.gspmd import shard_rows
    n = 1024
    x = shard_rows(torch.ones(n, dtype=torch.float64), mesh)

    def body():
        xp = torch.nn.functional.pad(x, (1, 1))
        return xp[0:n] + xp[2:n + 2]
    return collective_census(body, full_vector_len=n)


CENSUS = {"cg_j": census_dia("CONJUGATE_GRADIENT", "JACOBI"),
          "gm_2st": census_dia("GMRES", "TWO_STAGE_GS"),
          "bi_s2st": census_dia("BICGSTAB", "SYMMETRIC_TWO_STAGE_GS"),
          "mg": census_replicated,
          "negative_gloo": census_negative}

SUITES = {"gspmd": GSPMD, "census": CENSUS}


class RankGroups:
    """Groups of `world` rank processes, each group one gloo process group
    running its share of a suite's cases, all groups at once (the cases
    wait on gloo's latency, not on the CPU); started by a test module's
    fixture.  A case's result waits only for its own group."""

    def __init__(self, suite: str, groups, tmp, world: int = 4,
                 timeout: float = 400.0):
        import subprocess
        self.world, self.timeout = world, timeout
        self.group_of = {c: g for g, cases in enumerate(groups)
                         for c in cases}
        self.procs, self.dirs, self.done = [], [], {}
        env = dict(os.environ, OMP_NUM_THREADS="1")
        for g, cases in enumerate(groups):
            d = os.path.join(str(tmp), f"group{g}")
            os.makedirs(d)
            self.dirs.append(d)
            self.procs.append([subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), suite,
                 ",".join(cases), str(r), str(world),
                 os.path.join(d, "store"), d],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True) for r in range(world)])

    def group(self, g: int):
        """Group g's results, one dict a rank (waits for the group)."""
        if g not in self.done:
            for p in self.procs[g]:
                log = p.communicate(timeout=self.timeout)[0]
                assert p.returncode == 0, log[-4000:]
            out = []
            for r in range(self.world):
                with open(os.path.join(self.dirs[g], f"rank{r}.pkl"),
                          "rb") as f:
                    out.append(pickle.load(f))
            self.done[g] = out
        return self.done[g]

    def case(self, name):
        """A case's result on every rank; fails with a rank's traceback."""
        out = [res[name] for res in self.group(self.group_of[name])]
        for o in out:
            assert not (isinstance(o, dict) and "error" in o), o["error"]
        return out

    def results(self):
        """Every group's results: a list of per-rank dicts each."""
        return [self.group(g) for g in range(len(self.procs))]

    def close(self):
        for group in self.procs:
            for p in group:
                if p.poll() is None:
                    p.kill()
                    p.wait()


def main(argv):
    suite, cases, rank, world, store, out = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    bt.solvers.fused.CHECK_EVERY = 8
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=300))
    mesh = make_device_mesh()
    results = {}
    try:
        todo = SUITES[suite]
        names = list(todo) if cases == "all" else cases.split(",")
        for name in names:
            fn = todo[name]
            t0 = time.perf_counter()
            try:
                results[name] = fn(mesh)
            except Exception:                           # noqa: BLE001
                results[name] = {"error": traceback.format_exc()}
            results.setdefault("_seconds", {})[name] = (
                time.perf_counter() - t0)
    finally:
        results["_jax_loaded"] = "jax" in sys.modules
        with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
