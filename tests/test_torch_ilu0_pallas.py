"""The port's factor-table superblock solves (plain versions of kernel #9
in factor-table mode and of the split pair #10/#11) against the JAX
package's Pallas kernels in interpret mode, float32: plane mode, packed
mode through the flat-IO apply, and the split-parity kernels.

The Pallas kernels contract each product and difference into a fused
multiply-add where the plain versions round both, so the tolerance is
rtol 1e-5, atol 1e-6.  Inputs come from `numpy.random.default_rng`.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from basic_iterative_solvers_tpu.ops import block_trisolve as jbt
from basic_iterative_solvers_tpu.ops import pallas_env

from basic_iterative_solvers_tpu_torch.ops import block_trisolve as tbt
from tests.test_torch_ilu0_apply import _pairs, _y


@pytest.fixture
def interpret():
    pallas_env.INTERPRET = True
    try:
        yield
    finally:
        pallas_env.INTERPRET = False


def test_plain_apply_f32_matches_plane_kernel(interpret):
    """Against _super_level_pallas in plane mode (interpret), which
    contracts each product and difference into a fused multiply-add where
    the plain version rounds both: rtol 1e-5, atol 1e-6."""
    pj, pt, At = _pairs("hpcg:16x16x16", np.float32, torch.float32)
    assert not pj[0].is_packed
    y = _y(At.n_rows, 8, np.float32)
    ref = np.asarray(jbt.blocked_ilu0(*pj, jnp.asarray(y)))
    got = tbt.blocked_ilu0(*pt, torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_plain_apply_f32_matches_packed_flat_io_kernel(interpret,
                                                       monkeypatch):
    """Against the packed-table kernel through the flat-IO apply
    (interpret), PACK_MIN_ROWS lowered to 0 as
    tests/test_pallas_interpret.py lowers it; hpcg:128×16×16 is the
    smallest HPCG grid with nx = 128 whose tiles are whole z slabs, which
    the flat-IO apply needs.  FMA contraction: rtol 1e-5, atol 1e-6."""
    monkeypatch.setattr(jbt, "PACK_MIN_ROWS", 0)
    pj, pt, At = _pairs("hpcg:128x16x16", np.float32, torch.float32)
    assert pj[0].is_packed and pj[1].is_packed
    y = _y(At.n_rows, 9, np.float32)
    assert jbt._flat_io_eligible(pj[0], True, jnp.asarray(y))
    ref = np.asarray(jbt.blocked_ilu0(*pj, jnp.asarray(y)))
    got = tbt.blocked_ilu0(*pt, torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_split_route_f32_matches_split_kernels(interpret, monkeypatch):
    """BIS_SB_ALIGNED=0 on both packages (NO_ALIGNED, read at import):
    hpcg:12×8×6 (128 % 12 ≠ 0) takes the split route, the port's
    super_acc/super_parity plain versions against _super_acc_pallas and
    _super_parity_pallas (interpret).  FMA contraction: rtol 1e-5, atol
    1e-6."""
    monkeypatch.setattr(jbt, "NO_ALIGNED", True)
    monkeypatch.setattr(tbt, "NO_ALIGNED", True)
    pj, pt, At = _pairs("hpcg:12x8x6", np.float32, torch.float32)
    assert not pj[0].fused and not pt[0].fused and not pt[1].fused
    y = _y(At.n_rows, 10, np.float32)
    ref = np.asarray(jbt.blocked_ilu0(*pj, jnp.asarray(y)))
    tbt.super_acc.launches = tbt.super_parity.launches = 0
    got = tbt.blocked_ilu0(*pt, torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    assert tbt.super_acc.launches == tbt.super_parity.launches == 0
