"""The port's mesh operators (parallel/mesh_ops.py) against the JAX
package's shard_map mode on the same inputs: the mesh SpMV on a stencil,
a DIA and a lane-ELL matrix, and the mesh GS colour step, 8 shards on the
CPU (the JAX side on its 8 virtual devices of tests/conftest.py, its
Pallas kernels in interpret mode), and the shard-local plain versions
(the kernels' twins) against the single-device plain versions, shard by
shard, with the layouts the port picks.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import basic_iterative_solvers_tpu as bis
from basic_iterative_solvers_tpu.ops import pallas_env
from basic_iterative_solvers_tpu.parallel import make_mesh as jmake_mesh
from basic_iterative_solvers_tpu.parallel import mesh_ops as jmo

import basic_iterative_solvers_tpu_torch as bt
from basic_iterative_solvers_tpu_torch import stencil_op as tso
from basic_iterative_solvers_tpu_torch.coloring import spec_for_device
from basic_iterative_solvers_tpu_torch.ops import dia_spmv as tdia
from basic_iterative_solvers_tpu_torch.ops import lane_ell as tle
from basic_iterative_solvers_tpu_torch.ops.spmv import spmv, spmv_dots
from basic_iterative_solvers_tpu_torch.parallel import make_mesh
from basic_iterative_solvers_tpu_torch.parallel import mesh_ops as tmo
from basic_iterative_solvers_tpu_torch.parallel.sharded import (
    _halo, _halo_exchange, _split)
from tests.test_torch_ilu0_factor import numpy_branch  # noqa: F401
from tests.test_torch_mesh_solve import mesh_x

CPU = "cpu"
STENCILS = ["hpcg:8x6x4", "hpcg:8x8x8", "fdm:16",
            "anderson:Lx=6,Ly=5,Lz=9,t=1.0,ranpot=2.0,seed=1"]


@pytest.fixture
def interpret():
    pallas_env.INTERPRET = True
    try:
        yield
    finally:
        pallas_env.INTERPRET = False


@pytest.fixture(scope="module")
def mesh8():
    return make_mesh(8, device=CPU)


def _on(M, v):
    """v placed on M's mesh in M's layout (a MeshVector)."""
    return M.mesh.scatter(v, M.blocks.rows)


def _mesh_stencil(spec, dtype, mesh):
    A = tso.from_source_operator(spec, dtype, device=CPU)
    return A, tmo.wrap_stencil(dataclasses.replace(A, shards=8), mesh,
                               "rows")


@pytest.mark.parametrize("spec,rows", [("hpcg:8x6x4", 64), ("hpcg:8x8x8", 128),
                                       ("fdm:16", 32), ("hpcg:128x128x128",
                                                        262144),
                                       ("fdm:2048", 524288)])
def test_stencil_layout(spec, rows):
    """R_local: whole z-planes where nz ≥ 8, else whole x-lines, at least
    the halo (HPCG 8x8x8: 73 rows, two 64-row planes a shard, 4 shards
    inert); the main path's 128^3 needs no padding."""
    nx, ny, nz = (int(v) for v in spec.split(":")[1].split("x")) \
        if spec.startswith("hpcg") else (int(spec[4:]),) * 2 + (1,)
    halo = (nx * ny + nx + 1,) * 2 if nz > 1 else (nx + 1,) * 2
    assert tmo.stencil_shard_rows((nx, ny, nz), halo, 8) == rows


def test_mesh_stencil_spmv_matches_jax_mesh(interpret, rng):
    """The JAX test's unit (test_mesh_pallas.py:177): hpcg:8x6x4 in
    float32, the mesh SpMV against the JAX package's mesh SpMV, within the
    JAX test's tolerance, and bit-equal to the port's single-device SpMV."""
    from basic_iterative_solvers_tpu.ops.spmv import spmv as jspmv
    from basic_iterative_solvers_tpu.stencil_op import (
        from_planar_vec, to_planar_matrix, to_planar_vec)
    Aj = to_planar_matrix(bis.stencil_op.from_source_operator(
        "hpcg:8x6x4", dtype=np.float32))
    x = rng.standard_normal(Aj.n_rows).astype(np.float32)
    A8 = dataclasses.replace(Aj, shards=8, diag=None)
    Mj = jmo.wrap_stencil(A8, jmake_mesh(8), "rows")
    yj = np.asarray(from_planar_vec(A8, jspmv(Mj, to_planar_vec(A8, x))))
    A, M = _mesh_stencil("hpcg:8x6x4", torch.float32, make_mesh(8,
                                                                device=CPU))
    xt = torch.from_numpy(x)
    yt = mesh_x(spmv(M, _on(M, xt)))
    np.testing.assert_allclose(yt.numpy(), yj, rtol=2e-6, atol=1e-5)
    assert torch.equal(yt, tso.stencil_spmv(A, xt))


@pytest.mark.parametrize("spec", STENCILS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_mesh_stencil_spmv_equals_single_device(spec, dtype, mesh8):
    """y bit-equal to the single-device SpMV row for row, every dot kind
    within rounding of its single-device value (the shards' partials are
    summed by psum in another grouping), one halo pair and one psum of
    scalars a call."""
    A, M = _mesh_stencil(spec, dtype, mesh8)
    g = np.random.default_rng(3)
    x = torch.from_numpy(g.standard_normal(A.n_rows)).to(dtype)
    aux = torch.from_numpy(g.standard_normal(A.n_rows)).to(dtype)
    dots = ("x", "self", "aux")
    x8, aux8 = _on(M, x), _on(M, aux)
    mesh8.reset_counts()
    y8 = tmo.mesh_stencil_spmv(M, x8, dots, aux8)
    y1 = tso.stencil_spmv(A, x, dots, aux)
    assert torch.equal(mesh_x(y8[0]), y1[0])
    rtol = 1e-12 if dtype == torch.float64 else 1e-5
    for kind, d8, d1 in zip(dots, y8[1:], y1[1:]):
        partner = {"x": x, "self": y1[0], "aux": aux}[kind]
        assert abs(float(d8 - d1)) <= rtol * float((y1[0] * partner).abs()
                                                   .sum())
    itemsize = x.element_size()
    assert mesh8.counts["ppermute"] == 2 and mesh8.counts["psum"] == 1
    assert mesh8.counts["psum_bytes"] == 8 * len(dots) * 8   # f64 partials
    assert mesh8.counts["ppermute_bytes"] == (2 * 7 * A.window_halo[0]
                                             * itemsize)
    assert torch.equal(mesh_x(spmv_dots(M, x8, aux=aux8,
                                        with_self=True)[0]), y1[0])


@pytest.mark.parametrize("spec", STENCILS)
def test_halo_plain_equals_single_device_plain(spec, mesh8):
    """The shard-local plain twin of #1 on each shard's window gives the
    single-device plain version's rows bit for bit (inert rows 0), and
    the shard-local plain GS step the single-device plain step's."""
    A, M = _mesh_stencil(spec, torch.float64, mesh8)
    g = np.random.default_rng(5)
    x = torch.from_numpy(g.standard_normal(A.n_rows))
    rhs = torch.from_numpy(g.standard_normal(A.n_rows))
    dinv = torch.from_numpy(g.uniform(0.5, 1.0, A.n_rows))
    R = M.rows
    npad = 8 * R
    pad = lambda v: torch.nn.functional.pad(v, (0, npad - A.n_rows))  # noqa
    windows = _halo_exchange(mesh8, _split(pad(x), 8), *A.window_halo)
    y1 = tso.stencil_spmv_plain(A, x)
    diags = M.diag_shards or (None,) * 8
    ys = [tso.stencil_spmv_halo_plain(A, windows[k], k * R, diag=diags[k])
          for k in range(8)]
    assert torch.equal(torch.cat(ys)[:A.n_rows], y1)
    assert not torch.cat(ys)[A.n_rows:].any()
    cs = spec_for_device(A)
    for c in (0, tuple(range(cs.params[3])) if cs.kind == "grid" else 1):
        x1 = tso.stencil_gs_color_step_plain(A, x, rhs, dinv, cs, c)
        xs = [tso.stencil_gs_color_step_halo_plain(
            A, windows[k], k * R, _split(pad(rhs), 8)[k],
            _split(pad(dinv), 8)[k], cs, c, diag=diags[k])
            for k in range(8)]
        assert torch.equal(torch.cat(xs)[:A.n_rows], x1)


@pytest.mark.parametrize("spec", STENCILS)
def test_mesh_gs_step_matches_jax_mesh(spec, interpret, rng):
    """The mesh GS colour step against the JAX package's
    mesh_gs_color_step (its planar vectors decoded), every colour and the
    first superstep, float64: within 1e-13, and bit-equal to the port's
    single-device step."""
    from basic_iterative_solvers_tpu.coloring import (
        spec_for_device as jspec)
    from basic_iterative_solvers_tpu.stencil_op import (
        from_planar_vec, to_planar_matrix, to_planar_vec)
    Aj = to_planar_matrix(bis.stencil_op.from_source_operator(
        spec, dtype=np.float64))
    n = Aj.n_rows
    x, rhs = rng.standard_normal(n), rng.standard_normal(n)
    dinv = rng.uniform(0.5, 1.0, n)
    A8 = dataclasses.replace(Aj, shards=8)
    if Aj.diag is not None:
        A8 = dataclasses.replace(A8, diag=to_planar_vec(
            A8, from_planar_vec(Aj, Aj.diag)))
    Mj = jmo.wrap_stencil(A8, jmake_mesh(8), "rows")
    csj = jspec(Aj)
    enc = lambda v: to_planar_vec(A8, jnp.asarray(v))  # noqa: E731
    A, M = _mesh_stencil(spec, torch.float64, make_mesh(8, device=CPU))
    cs = spec_for_device(A)
    assert (cs.kind, cs.params) == (csj.kind, tuple(csj.params))
    xt, rt, dt = (torch.from_numpy(v) for v in (x, rhs, dinv))
    colors = [(c,) for c in range(cs.n_colors)]
    if cs.kind == "grid" and cs.params[3] > 1:
        colors.append(tuple(range(cs.params[3])))
    for c in colors:
        yj = np.asarray(from_planar_vec(A8, jmo.mesh_gs_color_step(
            Mj, enc(x), enc(rhs), enc(dinv), csj, c)))
        yt = mesh_x(tmo.mesh_gs_color_step(M, _on(M, xt), _on(M, rt),
                                           _on(M, dt), cs, c))
        np.testing.assert_allclose(yt.numpy(), yj, rtol=1e-13, atol=1e-13)
        assert torch.equal(yt, tso.stencil_gs_color_step(A, xt, rt, dt, cs,
                                                         c))


def test_mesh_dia_spmv_matches_jax_mesh(interpret, rng):
    """DIA (HPCG 8x8x8, float64): the mesh SpMV against the JAX package's
    mesh_dia_spmv (its lane-grouped kernel: within rounding), bit-equal to
    the port's single-device SpMV, and to the shard-local plain twin shard
    by shard; R_local = max(⌈n/8⌉, halo) = 73 rows."""
    Aj = bis.dia.stencil_27pt_device(8, 8, 8, dtype=np.float64)
    Mj = jmo.wrap_dia(Aj, jmake_mesh(8), "rows", np.float64)
    x = rng.standard_normal(Aj.n_rows)
    yj = np.asarray(jmo.mesh_dia_spmv(Mj, jnp.asarray(x)))
    mesh = make_mesh(8, device=CPU)
    A = bt.dia.stencil_27pt_device(8, 8, 8, dtype=torch.float64, device=CPU)
    M = tmo.wrap_dia(A, mesh, "rows")
    assert M.rows == 73 and len(M.data_shards) == 8
    assert all(d.shape == (27, 73) for d in M.data_shards)
    xt = torch.from_numpy(x)
    yt = mesh_x(spmv(M, _on(M, xt)))
    np.testing.assert_allclose(yt.numpy(), yj, rtol=1e-13, atol=1e-12)
    assert torch.equal(yt, tdia.dia_spmv(A, xt))
    hneg, hpos = _halo(A.offsets)
    windows = _halo_exchange(mesh, _split(torch.nn.functional.pad(
        xt, (0, 8 * 73 - 512)), 8), hneg, hpos)
    ys = [tdia.dia_spmv_halo_plain(M.data_shards[k], A.offsets, windows[k],
                                   hneg) for k in range(8)]
    assert torch.equal(torch.cat(ys)[:512], yt)
    with pytest.raises(ValueError, match="does not cover"):
        tdia.dia_spmv_halo(M.data_shards[0], A.offsets, windows[0][:-1],
                           hneg)


@pytest.mark.parametrize("dtype,np_dtype,rtol", [
    (torch.float64, np.float64, 1e-12), (torch.float32, np.float32, 1e-6)])
def test_mesh_lane_ell_spmv_matches_jax_mesh(dtype, np_dtype, rtol,
                                             interpret, rng,
                                             numpy_branch):  # noqa: F811
    """The JAX test's lane-ELL unit (test_mesh_pallas.py:198):
    scattered_band(2048, 6, 200, seed=3), the mesh SpMV against the JAX
    package's (rtol 1e-12 in float64), bit-equal to the port's
    single-device SpMV; the planes extended as the JAX package extends
    them and cut into 8 shards of their own."""
    from basic_iterative_solvers_tpu.ops.lane_ell import csr_to_lane_ell
    Aj = bis.generators.scattered_band(2048, 6, 200, seed=3)
    Mj = csr_to_lane_ell(Aj, dtype=np_dtype)
    Wj = jmo.wrap_lane_ell(Mj, jmake_mesh(8), "rows", np_dtype)
    x = rng.standard_normal(Aj.n_rows).astype(np_dtype)
    yj = np.asarray(jax.device_get(jmo.mesh_lane_ell_spmv(Wj,
                                                          jnp.asarray(x))))
    A = bt.generators.scattered_band(2048, 6, 200, seed=3)
    M = tle.csr_to_lane_ell(A, dtype, device=CPU)
    W = tmo.wrap_lane_ell(M, make_mesh(8, device=CPU), "rows")
    assert W.inner.R == Wj.inner.R and W.rows == Wj.inner.R // 8
    np.testing.assert_array_equal(W.inner.vals.numpy(),
                                  np.asarray(Wj.inner.vals))
    assert all(v.shape == (M.K, W.rows, tle.LANES) for v in W.vals_shards)
    xt = torch.from_numpy(x)
    yt = mesh_x(spmv(W, _on(W, xt)))
    np.testing.assert_allclose(yt.numpy(), yj, rtol=rtol,
                               atol=rtol * np.abs(yj).max())
    assert torch.equal(yt, tle.lane_ell_spmv(M, xt))


def test_lane_ell_extend_rows_inert():
    """Inert rows: value 0, each slot's index in range (rowoff 0); y is 0
    there, and the extension refuses a count off the row tile."""
    M = tle.csr_to_lane_ell(bt.generators.from_source("sband:1500,6,260"),
                            torch.float64, device=CPU)
    tile = tle.lane_ell_row_tile(M.n_rows, M.S)
    E = tle.lane_ell_extend_rows(M, M.R + 2 * tile)
    assert E.R == M.R + 2 * tile
    assert not E.vals[:, M.R:].any()
    assert bool((E.idx[:, M.R:] == M.S * tle.LANES).all())
    x = torch.randn(M.n_rows, dtype=torch.float64)
    assert torch.equal(tle.lane_ell_spmv(E, x), tle.lane_ell_spmv(M, x))
    with pytest.raises(ValueError, match="bad extension"):
        tle.lane_ell_extend_rows(M, M.R + 1)


def test_halo_wrappers_refuse_bad_windows(mesh8):
    """A window that does not start a shard on an x-line, a diagonal
    slice missing where the operator has one, a lane-ELL halo below the
    span."""
    A, M = _mesh_stencil("hpcg:8x6x4", torch.float64, mesh8)
    xw = torch.zeros(M.rows + sum(A.window_halo), dtype=torch.float64)
    with pytest.raises(ValueError, match="whole x-lines"):
        tso.stencil_spmv_halo(A, xw, 3)
    with pytest.raises(ValueError, match="whole x-lines"):
        tso.stencil_spmv_halo(A, xw[1:], 0)
    An, Mn = _mesh_stencil(STENCILS[3], torch.float64, mesh8)
    with pytest.raises(ValueError, match="diagonal slice"):
        tso.stencil_spmv_halo(An, torch.zeros(
            Mn.rows + sum(An.window_halo), dtype=torch.float64), 0)
    L = tle.csr_to_lane_ell(bt.generators.from_source("sband:1500,6,260"),
                            torch.float64, device=CPU)
    with pytest.raises(ValueError, match="halo"):
        tle.lane_ell_spmv_halo(L, L.vals, L.idx, torch.zeros(
            L.R * tle.LANES, dtype=torch.float64), 0, 0)
