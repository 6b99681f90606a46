"""The port's GMRES basis passes (ops/gmres_basis.py) against the JAX
package's Pallas kernels, run in interpret mode, and the port's wrappers.

The hand-written CUDA kernels cannot run here; their plain PyTorch
versions, which `chip_smoke.py` holds the kernels against on the card, are
compared with the TPU kernels on the sizes the JAX package's own test uses
(R = 512, L = 512, m = 10, two column chunks; R = 1024 with a bfloat16
basis, whose chunks hold twice the rows), the (m_pad, R, L) basis reshaped
to flat rows.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from basic_iterative_solvers_tpu.ops import gmres_basis as jgb
from basic_iterative_solvers_tpu.ops import pallas_env

from basic_iterative_solvers_tpu_torch.ops import gmres_basis as tgb

L, M = 512, 10
#: basis dtype -> (JAX dtype, torch dtype, R)
DTYPES = {"float32": (jnp.float32, torch.float32, 512),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 1024)}


@pytest.fixture
def interpret():
    pallas_env.INTERPRET = True
    try:
        yield
    finally:
        pallas_env.INTERPRET = False


def _inputs(dtype, seed):
    """The same basis, w, vc and ht in both packages: V is drawn in
    float32 and rounded to the basis dtype by JAX; the port takes the
    rounded values (exact in float32) and stores them in its dtype."""
    jdt, tdt, R = DTYPES[dtype]
    plan = jgb.plan_for((R, L), M, jdt)
    assert plan is not None and plan.n_chunks > 1
    rng = np.random.default_rng(seed)
    Vj = jnp.asarray(rng.standard_normal((plan.m_pad, R, L)),
                     dtype=jnp.float32).astype(jdt)
    w = rng.standard_normal((R, L)).astype(np.float32)
    vc = rng.standard_normal((R, L)).astype(np.float32)
    ht = rng.standard_normal(plan.m_pad).astype(np.float32)
    Vt = torch.from_numpy(np.asarray(Vj.astype(jnp.float32))
                          .reshape(plan.m_pad, R * L)).to(tdt)
    assert torch.equal(Vt.to(torch.float32).reshape(Vj.shape),
                       torch.from_numpy(np.asarray(Vj.astype(jnp.float32))))
    return plan, Vj, Vt, w.ravel(), vc.ravel(), ht


@pytest.mark.parametrize("j", [0, M - 1])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_project_gram_matches_pallas_kernel(interpret, dtype, j):
    """Pw and Pv of rows 0..j at the JAX test's rtol 1e-4 / atol 1e-2 (two
    float32 sums of 262,144 products in different orders); the port's are
    zero beyond row j (the TPU kernel's bucket rows there are the caller's
    to ignore)."""
    plan, Vj, Vt, w, vc, _ = _inputs(dtype, 1)
    shape = (plan.R, L)
    Pw_j, Pv_j = jgb.project_gram(Vj, jnp.asarray(w.reshape(shape)),
                                  jnp.asarray(vc.reshape(shape)), j,
                                  plan=plan)
    Pw, Pv = tgb.project_gram_plain(Vt, torch.from_numpy(w),
                                    torch.from_numpy(vc), j)
    for got, want in ((Pw, Pw_j), (Pv, Pv_j)):
        assert got.dtype == torch.float32 and got.shape == (plan.m_pad,)
        np.testing.assert_allclose(got[:j + 1].numpy(),
                                   np.asarray(want)[:j + 1],
                                   rtol=1e-4, atol=1e-2)
        assert not got[j + 1:].any()


@pytest.mark.parametrize("j", [0, M - 1])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_correct_write_matches_pallas_kernel(interpret, dtype, j):
    """The written row equals the returned vnext bit for bit, every other
    row of V is unchanged bit for bit, and nrm2 is Σ vnext² (rtol 1e-5,
    summation order).  Against the TPU kernel, vnext agrees to the JAX
    test's atol 1e-5 (the float32 rounding of w − Σ h̃·V, which the TPU
    kernel contracts to fused multiply-adds and the port does not); in
    bfloat16 also to one unit in the last place (2⁻⁷ relative), since two
    float32 sums that differ in their last bit round to neighbouring
    bfloat16 values near a midpoint."""
    plan, Vj, Vt, w, _, ht = _inputs(dtype, 2)
    ht[j + 1:] = 0.0
    _, vnext_j, _ = jgb.correct_write(Vj, jnp.asarray(w.reshape(plan.R, L)),
                                      jnp.asarray(ht), j, plan=plan)
    V0 = Vt.clone()
    vnext, nrm2 = tgb.correct_write_plain(Vt, torch.from_numpy(w),
                                          torch.from_numpy(ht), j)
    assert vnext.dtype == torch.float32 and vnext.shape == (plan.R * L,)
    assert torch.equal(Vt[j + 1].to(torch.float32), vnext)
    others = [i for i in range(plan.m_pad) if i != j + 1]
    assert torch.equal(Vt[others], V0[others])
    np.testing.assert_allclose(float(nrm2),
                               float(np.sum(vnext.numpy().astype(np.float64)
                                            ** 2)), rtol=1e-5)
    want = np.asarray(vnext_j).ravel()
    if dtype == "float32":
        np.testing.assert_allclose(vnext.numpy(), want, rtol=0, atol=1e-5)
    else:
        np.testing.assert_allclose(vnext.numpy(), want, rtol=2.0 ** -7,
                                   atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_tensors_launch_no_kernel(dtype):
    """On CPU tensors both wrappers run their plain versions and equal
    them; the launch counters stay at 0."""
    tgb.project_gram.launches = tgb.correct_write.launches = 0
    rng = np.random.default_rng(3)
    n, rows, j = 1000, 6, 3
    V = torch.from_numpy(rng.standard_normal((rows, n))).to(dtype)
    w, vc = (torch.from_numpy(rng.standard_normal(n).astype(np.float32))
             for _ in range(2))
    ht = torch.from_numpy(rng.standard_normal(rows).astype(np.float32))
    for got, want in zip(tgb.project_gram(V, w, vc, j),
                         tgb.project_gram_plain(V, w, vc, j)):
        assert torch.equal(got, want)
    V2 = V.clone()
    got = tgb.correct_write(V, w, ht, j)
    want = tgb.correct_write_plain(V2, w, ht, j)
    assert torch.equal(V, V2)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert tgb.project_gram.launches == tgb.correct_write.launches == 0


@pytest.mark.parametrize("basis,w_dtype,ok", [
    (torch.float32, torch.float32, True),
    ("bfloat16", torch.float32, True),
    (torch.float64, torch.float32, False),
    (torch.float16, torch.float32, False),
    (torch.float32, torch.float64, False),
], ids=["f32", "bf16", "f64-basis", "f16-basis", "f64-w"])
def test_plan_for(basis, w_dtype, ok):
    """The kernels take a float32 w and a float32 or bfloat16 basis."""
    assert tgb.plan_for(50, basis, w_dtype) == (51 if ok else None)


@pytest.mark.parametrize("case", ["basis-dtype", "w-dtype", "shape", "j",
                                  "last-row", "noncontig"])
def test_wrappers_reject_bad_operands(case):
    n, rows = 64, 5
    V = torch.zeros((rows, n))
    w = torch.zeros(n)
    ht = torch.zeros(rows)
    call, err = {
        "basis-dtype": (lambda: tgb.project_gram(V.double(), w, w, 0),
                        TypeError),
        "w-dtype": (lambda: tgb.project_gram(V, w.double(), w, 0), TypeError),
        "shape": (lambda: tgb.correct_write(V, w[:-1], ht, 0), ValueError),
        "j": (lambda: tgb.project_gram(V, w, w, rows), ValueError),
        "last-row": (lambda: tgb.correct_write(V, w, ht, rows - 1),
                     ValueError),
        "noncontig": (lambda: tgb.project_gram(V.t().contiguous().t(), w, w,
                                               0), ValueError),
    }[case]
    with pytest.raises(err):
        call()
