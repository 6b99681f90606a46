"""The one-launch const-mode solve (kernel #12's port, `super_solve_mega`)
and its routing: on the CPU the wrapper runs the per-level plain loop, so
with the module switch MEGA on a solve equals the per-level route bit for
bit; against the JAX package's _super_solve_pallas_mega in interpret mode
(its BIS_SB_MEGA=1 route) within the float32 tolerance of the other
superblock kernels (rtol 1e-5, atol 1e-6); and the switch sends only fused
const-mode solves there.  The launch tables the kernel reads from device
memory are checked field for field.
"""
import ctypes

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from basic_iterative_solvers_tpu import coloring as jcol
from basic_iterative_solvers_tpu import stencil_op as jso
from basic_iterative_solvers_tpu.ops import block_trisolve as jbt
from basic_iterative_solvers_tpu.ops import pallas_env

from basic_iterative_solvers_tpu_torch import _build
from basic_iterative_solvers_tpu_torch import coloring as tcol
from basic_iterative_solvers_tpu_torch import stencil_op as tso
from basic_iterative_solvers_tpu_torch.ops import block_trisolve as tbt
from tests.test_torch_ilu0_factor import numpy_branch  # noqa: F401
from tests.test_torch_superblock_csr import ANDERSON, _pairs

CPU = "cpu"


@pytest.fixture
def interpret():
    pallas_env.INTERPRET = True
    try:
        yield
    finally:
        pallas_env.INTERPRET = False


def _stencil_pair(spec, t_dt, np_dt):
    At = tso.from_source_operator(spec, t_dt, device=CPU)
    Aj = jso.from_source_operator(spec, dtype=np_dt)
    return (tbt.build_superblock_gs_pair_stencil(
                At, tcol.spec_for_device(At), dtype=t_dt, need_d=True),
            jbt.build_superblock_gs_pair_stencil(
                Aj, jcol.spec_for_device(Aj), dtype=np_dt, need_d=True))


def _calls(monkeypatch):
    """Count the calls into super_solve_mega (the plain loop runs on the
    CPU, so its launch counter stays 0)."""
    seen = []
    orig = tbt.super_solve_mega
    monkeypatch.setattr(tbt, "super_solve_mega",
                        lambda B, y, x: (seen.append(B), orig(B, y, x))[1])
    return seen


@pytest.mark.parametrize("source", ["hpcg:16x16x16", ANDERSON])
def test_mega_equals_per_level_route(source, rng, monkeypatch,
                                     numpy_branch):  # noqa: F811
    """blocked_trisolve of L and U and blocked_sgs with MEGA on equal the
    per-level route bit for bit, through super_solve_mega (analytic pair
    with the scalar D; pair from CSR, const mode with a per-row D)."""
    if source == ANDERSON:
        (L, U), _j = _pairs(source, "sgs", torch.float64, np.float64)
        assert L.dinv_rows is not None and L.is_const
    else:
        (L, U), _j = _stencil_pair(source, torch.float64, np.float64)
    y = torch.from_numpy(rng.standard_normal(L.n_rows))
    off = [tbt.blocked_trisolve(L, y), tbt.blocked_trisolve(U, y),
           tbt.blocked_sgs(L, U, y)]
    seen = _calls(monkeypatch)
    monkeypatch.setattr(tbt, "MEGA", True)
    tbt.super_solve_mega.launches = 0
    on = [tbt.blocked_trisolve(L, y), tbt.blocked_trisolve(U, y),
          tbt.blocked_sgs(L, U, y)]
    assert len(seen) == 4 and tbt.super_solve_mega.launches == 0
    for a, b in zip(on, off):
        assert torch.equal(a, b)
    x = torch.full_like(y, 3.0)
    assert tbt.super_solve_mega_plain(U, y, x) is x
    assert torch.equal(x, off[1])


@pytest.mark.parametrize("spec", ["hpcg:16x16x16", "hpcg:16x12x8"])
def test_mega_matches_pallas_mega_interpret(spec, rng, interpret,
                                            monkeypatch):
    """The port's one-launch route against the JAX package's
    _super_solve_pallas_mega in interpret mode, MEGA on in both, float32:
    L, U and the symmetric apply, rtol 1e-5, atol 1e-6."""
    (L, U), (Lj, Uj) = _stencil_pair(spec, torch.float32, np.float32)
    monkeypatch.setattr(tbt, "MEGA", True)
    monkeypatch.setattr(jbt, "MEGA", True)
    assert jbt._mega_eligible(Lj, np.float32)
    mega = []
    orig = jbt._super_solve_pallas_mega
    monkeypatch.setattr(jbt, "_super_solve_pallas_mega",
                        lambda B, ys: (mega.append(B), orig(B, ys))[1])
    y = rng.standard_normal(L.n_rows).astype(np.float32)
    yt, yj = torch.from_numpy(y), jnp.asarray(y)
    got = [tbt.blocked_trisolve(L, yt), tbt.blocked_trisolve(U, yt),
           tbt.blocked_sgs(L, U, yt)]
    ref = [jbt.blocked_trisolve(Lj, yj), jbt.blocked_trisolve(Uj, yj),
           jbt.blocked_sgs(Lj, Uj, yj)]
    assert len(mega) == 4
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("mega", [False, True])
def test_switch_takes_only_fused_const_solves(mega, rng, monkeypatch,
                                              numpy_branch):  # noqa: F811
    """With MEGA off no solve goes through super_solve_mega; with it on,
    only fused const-mode ones: plane, factor-table and split solves keep
    the per-level route, and super_solve_mega refuses them."""
    monkeypatch.setattr(tbt, "MEGA", mega)
    seen = _calls(monkeypatch)
    (Lp, Up), _j = _pairs("fdm:16", "ilu0", torch.float64, np.float64)
    assert Lp.is_plane and Up.is_const
    At = tso.from_source_operator("hpcg:8x8x8", torch.float64, device=CPU)
    Lt, Ut = tbt.build_superblock_ilu0_pair_stencil(
        At, tcol.spec_for_device(At), dtype=torch.float64)
    (Lc, Uc), _j = _stencil_pair("hpcg:8x8x8", torch.float64, np.float64)
    y8 = torch.from_numpy(rng.standard_normal(512))
    y16 = torch.from_numpy(rng.standard_normal(256))
    tbt.blocked_ilu0(Lp, Up, y16)
    tbt.blocked_ilu0(Lt, Ut, y8)
    assert [B.is_const for B in seen] == ([True] if mega else [])
    seen.clear()
    tbt.blocked_sgs(Lc, Uc, y8)
    assert len(seen) == (2 if mega else 0)
    for B in (Lp, Lt):
        with pytest.raises(ValueError, match="const-mode"):
            tbt.super_solve_mega(B, y16 if B is Lp else y8,
                                 torch.empty_like(y16 if B is Lp else y8))


def test_launch_tables_in_device_memory():
    """_mega_levels packs every level's BisSuperLevelArgs, in solve order,
    as the kernel reads them: one ctypes struct per level, field for
    field."""
    (L, U), _j = _stencil_pair("hpcg:16x12x8", torch.float64, np.float64)
    for B in (L, U):
        buf = tbt._mega_levels(B, CPU)
        size = ctypes.sizeof(_build.SuperLevelArgs)
        assert buf.dtype == torch.uint8
        assert buf.numel() == size * len(B.levels)
        for li in range(len(B.levels)):
            a = _build.SuperLevelArgs.from_buffer_copy(
                bytes(buf[li * size:(li + 1) * size].tolist()))
            want = tbt._level_args(B, li)
            assert bytes(a) == bytes(want)
            assert (a.mode, a.n_cross, a.py, a.pz, a.upper) == (
                0, len(B.levels[li][1]), B.levels[li][0] % 2,
                B.levels[li][0] // 2, int(B.upper))
        assert tbt._mega_levels(B, CPU) is buf
