"""Rounding on the mesh: BiCGSTAB + SGS with the superblock solves cut
into the shards departs from the single-device solve in the port as in
the JAX package (its shard_map solve on 8 virtual devices, interpret
mode), on a spec where BiCGSTAB amplifies rounding too fast for count
parity between any two groupings of its dots.
"""
import dataclasses

import numpy as np
import torch

import basic_iterative_solvers_tpu as bis
from basic_iterative_solvers_tpu.parallel import make_mesh as jmake_mesh
from basic_iterative_solvers_tpu.parallel import shard_setup as jshard_setup

import basic_iterative_solvers_tpu_torch as bt
from basic_iterative_solvers_tpu_torch.parallel import make_mesh, shard_setup
from tests.test_torch_mesh_superblock import _cfgs, interpret  # noqa: F401
from tests.test_torch_mesh_superblock_solve import _colored

CPU = "cpu"
#: weakly dominant (t = 0.2, W = 8): the Anderson spec the mesh solve
#: test could not hold to count parity
ANDERSON_WEAK = "anderson:Lx=8,Ly=8,Lz=4,t=0.2,ranpot=8.0,seed=1"


def test_bicgstab_mesh_departs_as_the_jax_mesh(interpret):
    """BiCGSTAB + SGS (per-row D, the stencil injected) on ANDERSON_WEAK,
    eight f64 steps: the JAX package's own shard_map solve (interpret
    mode, 8 virtual devices) departs from its single-device solve, and the
    port's 8-shard mesh from the port's single device, by the same
    rounding growth.  Held: r0 and the first two steps within rtol 1e-10
    in both packages, and at every step the port's largest departure so
    far within 100 times the JAX package's (or 1e-14)."""
    spec = ANDERSON_WEAK
    cj, ct = _cfgs("BICGSTAB", "SYMMETRIC_GAUSS_SEIDEL", tolerance=0.0,
                   max_iters=8)
    cj = dataclasses.replace(cj, **_colored(bis.SolverConfig, spec))
    ct = dataclasses.replace(ct, **_colored(bt.SolverConfig, spec))

    def jax_setup():
        return bis.preprocessing(
            bis.generators.from_source(spec), cj,
            A_dev=bis.stencil_op.from_source_operator(spec, np.float64))

    j1 = bis.solve(jax_setup())
    j8 = bis.solve(jshard_setup(jax_setup(), jmake_mesh(8),
                                mode="shard_map"))
    s1 = bt.preprocessing(
        bt.generators.from_source(spec), ct, device=CPU,
        A_dev=bt.stencil_op.from_source_operator(spec, torch.float64,
                                                 device=CPU))
    p1 = bt.solve(s1)
    p8 = bt.solve(shard_setup(s1, make_mesh(8, device=CPU),
                              mode="shard_map"))

    def departure(a, b):
        a, b = np.asarray(a.residual_norms), np.asarray(b.residual_norms)
        assert a.shape == b.shape and a.size >= 9
        return np.maximum.accumulate(np.abs(a[:9] - b[:9]) / b[:9])

    dj, dp = departure(j8, j1), departure(p8, p1)
    print("max rel departure so far, step by step:\n  JAX mesh vs JAX:  "
          + np.array2string(dj, precision=2) + "\n  port mesh vs port: "
          + np.array2string(dp, precision=2))
    assert dj[2] <= 1e-10 and dp[2] <= 1e-10
    assert np.all(dp <= 100 * np.maximum(dj, 1e-14))
