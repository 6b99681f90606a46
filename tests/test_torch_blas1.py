"""The port's BLAS-1 layer (ops/blas1.py) and package exports against the
JAX package's, on the same numpy inputs made from a seed."""
import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import basic_iterative_solvers_tpu as bis
from basic_iterative_solvers_tpu import dia as jdia
from basic_iterative_solvers_tpu import device_matrix as jdm
from basic_iterative_solvers_tpu import ops as jops
from basic_iterative_solvers_tpu import stencil_op as jso
from basic_iterative_solvers_tpu import utils as jutils
from basic_iterative_solvers_tpu.ops import blas1 as jb
from basic_iterative_solvers_tpu.ops import lane_ell as jle

import basic_iterative_solvers_tpu_torch as bt
from basic_iterative_solvers_tpu_torch import convert
from basic_iterative_solvers_tpu_torch import ops as tops
from basic_iterative_solvers_tpu_torch import utils as tutils
from basic_iterative_solvers_tpu_torch.ops import blas1 as tb
from basic_iterative_solvers_tpu_torch.ops import lane_ell as tle

CPU = "cpu"


def _vectors(seed, n=257):
    rng = np.random.default_rng(seed)
    v1, v2 = rng.standard_normal((2, n))
    v2[np.abs(v2) < 1e-3] = 1.0           # keep the divisions finite
    return v1, v2


@pytest.mark.parametrize("scale_", [1.0, -2.5])
@pytest.mark.parametrize("name", ["elemwise_mult_vectors",
                                  "elemwise_div_vectors"])
def test_elemwise_match_jax(name, scale_):
    """r = v1 * (s·v2) and v1 / (s·v2): the same float64 operations, bit
    for bit."""
    v1, v2 = _vectors(1)
    want = np.asarray(getattr(jb, name)(jnp.asarray(v1), jnp.asarray(v2),
                                        scale_))
    got = getattr(tb, name)(torch.from_numpy(v1), torch.from_numpy(v2),
                            scale_)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_scale_and_infty_vec_norm_match_jax(dtype):
    v1, _ = _vectors(2)
    v1 = v1.astype(dtype)
    np.testing.assert_array_equal(
        tb.scale(torch.from_numpy(v1), 0.75).numpy(),
        np.asarray(jb.scale(jnp.asarray(v1), 0.75)))
    assert float(tb.infty_vec_norm(torch.from_numpy(v1))) == float(
        jb.infty_vec_norm(jnp.asarray(v1)))


@pytest.mark.parametrize("kind,spec", [
    ("dia", "hpcg:8x6x4"), ("dia", "band:700,2"), ("ell", "fdm:16"),
    ("lane_ell", "sband:1500,6,260"), ("stencil", "hpcg:8x6x4"),
    ("stencil", "anderson:Lx=4,Ly=3,Lz=5,t=0.5,ranpot=3.0,seed=2")])
def test_infty_mat_norm_matches_jax(kind, spec):
    """The largest row sum of |A| for each device format (a stencil's
    with its diagonal, where it has one), float64; rtol 1e-14 (row sums in
    other orders)."""
    if kind == "dia":
        Aj = jdia.from_source_device(spec, dtype=np.float64)
        At = bt.dia.from_source_device(spec, torch.float64, device=CPU)
    elif kind == "ell":
        Aj = jdm.csr_to_ell(bis.generators.from_source(spec),
                            dtype=np.float64)
        At = bt.device_matrix.csr_to_ell(bt.generators.from_source(spec),
                                         torch.float64, device=CPU)
    elif kind == "lane_ell":
        Aj = jle.csr_to_lane_ell(bis.generators.from_source(spec),
                                 dtype=np.float64)
        At = tle.csr_to_lane_ell(bt.generators.from_source(spec),
                                 torch.float64, device=CPU)
    else:
        Aj = jso.from_source_operator(spec, dtype=jnp.float64)
        At = bt.stencil_op.from_source_operator(spec, torch.float64,
                                                device=CPU)
        diag = None if Aj.diag is None else np.asarray(Aj.diag)
        assert (diag is None) == (At.diag is None)
        At = convert.stencil_from_numpy(Aj.legs, Aj.coeff_values, Aj.dims,
                                        diag, dtype=torch.float64,
                                        device=CPU)
    want = float(jb.infty_mat_norm(Aj))
    assert want > 0
    np.testing.assert_allclose(float(tb.infty_mat_norm(At)), want,
                               rtol=1e-14)


def test_infty_mat_norm_refuses_other_types():
    with pytest.raises(TypeError):
        jb.infty_mat_norm(np.eye(3))
    with pytest.raises(TypeError):
        tb.infty_mat_norm(torch.eye(3))


@pytest.mark.parametrize("jax_pkg,port_pkg", [(bis, bt), (jops, tops),
                                              (jutils, tutils)],
                         ids=["package", "ops", "utils"])
def test_exports_cover_the_jax_package(jax_pkg, port_pkg):
    """Every public name the JAX package, its ops and its utils export,
    the port's export too, each a function, class or module of its own
    (JAX objects are never re-exported).  The subpackages' submodules are
    not exports: ops/pallas_env.py and the TPU layouts are not ported."""
    names = {n for n in dir(jax_pkg) if not n.startswith("_")
             and not (jax_pkg is not bis
                      and inspect.ismodule(getattr(jax_pkg, n)))}
    missing = sorted(n for n in names if not hasattr(port_pkg, n))
    assert not missing
    for n in names:
        obj = getattr(port_pkg, n)
        assert "basic_iterative_solvers_tpu_torch" in getattr(
            obj, "__module__", getattr(obj, "__name__", "")) or not callable(
            obj), n
