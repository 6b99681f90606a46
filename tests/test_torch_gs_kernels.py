"""The port's multicolour GS step (the plain version of kernel #3) and its
colourings against the JAX package's.

The hand-written CUDA kernel cannot run here; its plain PyTorch version
is held against the JAX package's masked sweep (its XLA path, float64) and
against the Pallas kernel it replaces, `stencil_gs_color_step`, run in
interpret mode on planar vectors (float32).  Inputs come from
`numpy.random.default_rng` and reach each package as numpy arrays.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from basic_iterative_solvers_tpu import coloring as jcol
from basic_iterative_solvers_tpu import stencil_op as jso
from basic_iterative_solvers_tpu.ops import pallas_env

from basic_iterative_solvers_tpu_torch import coloring as tcol
from basic_iterative_solvers_tpu_torch import stencil_op as tso

#: the port's entry points run on the card unless asked; these tests
#: run on the CPU
CPU = "cpu"

SPECS = ["fdm:16", "hpcg:8x8x8",
         "anderson:Lx=4,Ly=5,Lz=3,t=1.2,ranpot=4.0,seed=6"]


@pytest.fixture
def interpret():
    pallas_env.INTERPRET = True
    try:
        yield
    finally:
        pallas_env.INTERPRET = False


def _operands(spec, np_dt, t_dt, seed):
    """(Aj, At, x, rhs, dinv): both operators, and x, rhs and D⁻¹ as numpy
    arrays in np_dt (D⁻¹ = 1/diag of the operator)."""
    Aj = jso.from_source_operator(spec, dtype=np_dt)
    At = tso.from_source_operator(spec, t_dt, device=CPU)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(At.n_rows).astype(np_dt)
    rhs = rng.standard_normal(At.n_rows).astype(np_dt)
    dinv = (1.0 / tso.stencil_diag(At).numpy()).astype(np_dt)
    return Aj, At, x, rhs, dinv


@pytest.mark.parametrize("spec", SPECS + ["hpcg:6x4x2"])
def test_color_specs_and_ids_match_jax(spec):
    Aj = jso.from_source_operator(spec, dtype=np.float64)
    At = tso.from_source_operator(spec, torch.float64, device=CPU)
    sj, st = jcol.spec_for_device(Aj), tcol.spec_for_device(At)
    assert (st.kind, st.n_colors, st.params) == (sj.kind, sj.n_colors,
                                                 sj.params)
    np.testing.assert_array_equal(tcol.color_ids(st, At).numpy(),
                                  np.asarray(jcol.color_ids(sj, Aj)))


def test_mod_color_spec_matches_jax():
    for offs, n in (([1, 2], 61), ([3, 6, 9], 40), ([0], 5)):
        sj, st = jcol.mod_color_spec(offs, n), tcol.mod_color_spec(offs, n)
        assert (st.kind, st.n_colors, st.params) == (sj.kind, sj.n_colors,
                                                     sj.params)


@pytest.mark.parametrize("spec", SPECS)
def test_plain_color_step_f64_matches_jax_step(spec):
    """Every colour's step against the JAX package's masked sweep step,
    where(ids == c, x + (y − A·x)·D⁻¹, x) on its XLA SpMV: the two SpMVs
    sum the legs in the same order, so rtol 1e-13."""
    Aj, At, x, rhs, dinv = _operands(spec, np.float64, torch.float64, 3)
    sj = jcol.spec_for_device(Aj)
    ids = jcol.color_ids(sj, Aj)
    st = tcol.spec_for_device(At)
    for c in range(st.n_colors):
        ref = np.asarray(jnp.where(
            ids == c, x + (rhs - jso.stencil_spmv_xla(Aj, jnp.asarray(x)))
            * dinv, x))
        got = tso.stencil_gs_color_step_plain(
            At, torch.from_numpy(x), torch.from_numpy(rhs),
            torch.from_numpy(dinv), st, c).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-13, atol=1e-13)
        # the entry point takes the plain version on CPU tensors
        assert np.array_equal(got, tso.stencil_gs_color_step(
            At, torch.from_numpy(x), torch.from_numpy(rhs),
            torch.from_numpy(dinv), st, c).numpy())


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("from_zero", [False, True], ids=["sweep", "solve"])
@pytest.mark.parametrize("spec", SPECS)
def test_colored_sweep_f64_matches_jax(spec, from_zero, reverse):
    """A whole sweep (the GS iteration, x given) or solve (x = None, the
    preconditioner apply), forward and reverse, against the JAX package's
    colored_sweep on its XLA path, rtol 1e-12."""
    Aj, At, x, rhs, dinv = _operands(spec, np.float64, torch.float64, 4)
    sj = jcol.spec_for_device(Aj)
    st = tcol.spec_for_device(At)
    ref = np.asarray(jcol.colored_sweep(
        Aj, jnp.asarray(dinv), jnp.asarray(rhs),
        None if from_zero else jnp.asarray(x), sj, None, sj.n_colors,
        reverse=reverse, use_pallas=False))
    got = tcol.colored_sweep(At, torch.from_numpy(dinv),
                             torch.from_numpy(rhs),
                             None if from_zero else torch.from_numpy(x), st,
                             st.n_colors, reverse=reverse).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("spec", SPECS)
def test_plain_color_step_f32_matches_pallas_kernel(interpret, spec):
    """Each colour, and for grid colourings an x-superstep (a tuple of sx
    colours), against the Pallas kernel in interpret mode.  The TPU kernel
    groups equal-coefficient legs and the plain SpMV does not, so A·x
    rounds differently: rtol 2e-6, atol 1e-5."""
    Aj, At, x, rhs, dinv = _operands(spec, np.float32, torch.float32, 5)
    Ap = jso.to_planar_matrix(Aj)
    sj = jcol.spec_for_device(Aj)
    st = tcol.spec_for_device(At)
    colors = list(range(st.n_colors))
    if st.kind == "grid":
        colors.append(tuple(range(st.params[3])))
    planar = [jso.to_planar_vec(Ap, v) for v in (x, rhs, dinv)]
    for c in colors:
        out = jso.stencil_gs_color_step(Ap, *planar, sj, c)
        ref = np.asarray(jso.from_planar_vec(Ap, out))
        got = tso.stencil_gs_color_step_plain(
            At, torch.from_numpy(x), torch.from_numpy(rhs),
            torch.from_numpy(dinv), st, c).numpy()
        np.testing.assert_allclose(got, ref, rtol=2e-6, atol=1e-5)


@pytest.mark.parametrize("case", ["dims", "rhs_dtype", "dinv_shape"])
def test_color_step_rejects_bad_operands(case):
    A = tso.from_source_operator("hpcg:8x6x4", torch.float64, device=CPU)
    x = torch.ones(A.n_rows, dtype=torch.float64)
    spec = tcol.spec_for_device(A)
    rhs, dinv = x.clone(), x.clone()
    if case == "dims":
        spec = tcol.grid_color_spec(A.legs, (8, 6, 2))
    elif case == "rhs_dtype":
        rhs = rhs.float()
    else:
        dinv = dinv[:-1]
    with pytest.raises(ValueError):
        tso.stencil_gs_color_step(A, x, rhs, dinv, spec, 0)


def test_stencil_split_matches_jax():
    """Legs split by the sign of their linear offset, coefficients and
    diagonal equal to the JAX package's."""
    for spec in SPECS:
        Aj = jso.from_source_operator(spec, dtype=np.float64)
        At = tso.from_source_operator(spec, torch.float64, device=CPU)
        Lj, Uj, Dj, Dij = jso.stencil_split(Aj)
        Lt, Ut, Dt, Dit = tso.stencil_split(At)
        for j, t in ((Lj, Lt), (Uj, Ut)):
            assert t.legs == j.legs and t.dims == j.dims
            np.testing.assert_array_equal(t.coeffs.numpy(),
                                          np.asarray(j.coeffs))
        np.testing.assert_array_equal(Dt.numpy(), np.asarray(Dj)[:At.n_rows])
        np.testing.assert_array_equal(Dit.numpy(),
                                      np.asarray(Dij)[:At.n_rows])
