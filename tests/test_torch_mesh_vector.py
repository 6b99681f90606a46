"""The row-sharded vector of the port's single-controller Mesh
(parallel/mesh_vector.py): every operation the solvers send through a
MeshVector against the same operation on the whole tensor, the refusal to
mix it with a full-length plain tensor, the copying ppermute, the counted
gather and scatter, and placement on a Mesh over two devices
(`Mesh(["cpu", "meta"])`: a meta shard has shapes and no data, so any
operation that mixes the two shards' devices raises).  Small sizes, the
CPU only.
"""
import dataclasses

import numpy as np
import pytest
import torch

import basic_iterative_solvers_tpu_torch as bt
from basic_iterative_solvers_tpu_torch.ops.blas1 import (
    full_value, is_sharded)
from basic_iterative_solvers_tpu_torch.ops.spmv import spmv
from basic_iterative_solvers_tpu_torch.parallel import (
    Mesh, MeshVector, make_mesh, shard_setup)
from basic_iterative_solvers_tpu_torch.parallel import mesh_ops as tmo

N, ROWS = 29, 8            # four shards, the last short: 8, 8, 8, 5 rows


@pytest.fixture
def mesh4():
    return make_mesh(4, device="cpu")


def _vecs(mesh, dtype=torch.float64, seed=0):
    g = np.random.default_rng(seed)
    a, b = (torch.from_numpy(g.standard_normal(N)).to(dtype)
            for _ in range(2))
    return a, b, mesh.scatter(a, ROWS), mesh.scatter(b, ROWS)


#: the solvers' shard-by-shard operations (ops/blas1.py, the methods, the
#: fused harness's gates), each as f(a, b, s) for two vectors and a 0-d
#: scalar
POINTWISE = {
    "addcmul": lambda a, b, s: torch.addcmul(a, b, s),
    "addcmul_neg": lambda a, b, s: torch.addcmul(a, b, s, value=-1),
    "sub_alpha": lambda a, b, s: torch.sub(a, b, alpha=3.0),
    "add_alpha": lambda a, b, s: torch.add(a, b, alpha=-0.5),
    "mul_scalar": lambda a, b, s: a * s,
    "div": lambda a, b, s: a / (s * b),
    "reciprocal": lambda a, b, s: 1.0 / b,
    "where": lambda a, b, s: torch.where(a > 0, a + (b - a) * s, a),
    "where_active": lambda a, b, s: torch.where(s > 0, a, b),
    "neg_abs": lambda a, b, s: -torch.abs(a),
    "zeros_like": lambda a, b, s: a + torch.zeros_like(b),
    "clone_cast": lambda a, b, s: a.clone().to(torch.float32),
    "isfinite": lambda a, b, s: torch.isfinite(a / b),
    "eq_int": lambda a, b, s: (a > 0).to(torch.int64) == 1,
}


@pytest.mark.parametrize("op", sorted(POINTWISE))
def test_pointwise_bit_equal_to_whole(mesh4, op):
    a, b, a4, b4 = _vecs(mesh4)
    s = torch.tensor(0.75, dtype=torch.float64)
    out = POINTWISE[op](a4, b4, s)
    assert isinstance(out, MeshVector) and out.blocks == a4.blocks
    assert [t.shape[0] for t in out.shards] == [8, 8, 8, 5]
    assert torch.equal(mesh4.gather(out), POINTWISE[op](a, b, s))


def test_reductions(mesh4):
    """dot and sum: the shards' partials summed by psum in its fixed order
    (exactly), within 1e-14 relative of the whole tensor's; max, min, all
    and any of the shards' results."""
    a, b, a4, b4 = _vecs(mesh4)
    mesh4.reset_counts()
    d = torch.dot(a4, b4)
    assert d.dim() == 0 and mesh4.counts["psum"] == 1
    parts = [torch.dot(x, y) for x, y in zip(a4.shards, b4.shards)]
    assert torch.equal(d, torch.stack(parts).sum(0))
    assert abs(float(d - torch.dot(a, b))) <= 1e-14 * float(
        (a * b).abs().sum())
    assert abs(float(a4.sum() - a.sum())) <= 1e-14 * float(a.abs().sum())
    assert torch.equal(torch.max(torch.abs(a4)), torch.max(torch.abs(a)))
    assert torch.equal(a4.min(), a.min())
    assert bool(torch.isfinite(a4).all()) and not bool((a4 > 1e9).any())
    norm = bt.ops.blas1.euclidean_vec_norm(a4)
    assert abs(float(norm) - float(torch.linalg.norm(a))) <= 1e-14 * float(
        torch.linalg.norm(a))


def test_mixing_raises(mesh4):
    """A full-length plain tensor, a vector of another layout, a move to
    another device and an operation with no shard-by-shard form raise,
    naming the op; a 0-d tensor goes to every shard."""
    a, b, a4, _ = _vecs(mesh4)
    with pytest.raises(ValueError, match=r"aten.add.Tensor: a plain tensor "
                                         r"of shape \(29,\)"):
        a4 + a
    with pytest.raises(ValueError, match="plain tensor of shape"):
        torch.where(a4 > 0, a, a4)
    with pytest.raises(ValueError, match="different layouts"):
        a4 + mesh4.scatter(b, 10)
    with pytest.raises(ValueError, match="does not move to"):
        a4.to("meta")
    with pytest.raises(NotImplementedError, match="aten.cumsum"):
        torch.cumsum(a4, 0)
    with pytest.raises(ValueError, match="sharded dimension"):
        a4[3]
    assert torch.equal(mesh4.gather(a4 * torch.tensor(2.0,
                                                      dtype=a4.dtype)),
                       a * 2.0)


def test_views_stack_and_basis_rows(mesh4):
    """A GMRES basis of rows per shard: a row write lands in every shard's
    columns, a row read and a slice of rows are views, stack moves the
    sharded dimension; full_value and is_sharded see a MeshVector."""
    a, b, a4, b4 = _vecs(mesh4)
    V = a4.blocks.zeros(torch.float64, lead=(3,))
    V[1] = a4
    assert torch.equal(mesh4.gather(V)[1], a) and not mesh4.gather(V)[0].any()
    assert torch.equal(mesh4.gather(V[1]), a)
    assert tuple(V[:2].shape) == (2, N)
    S = torch.stack([a4, b4], dim=1)
    assert tuple(S.shape) == (N, 2) and S.sdim == -2
    assert torch.equal(mesh4.gather(S), torch.stack([a, b], dim=1))
    assert is_sharded(a4) and not is_sharded(a)
    mesh4.reset_counts()
    assert torch.equal(full_value(a4), a) and mesh4.counts["gather"] == 1


def test_ppermute_copies_and_gather_scatter_count():
    """A received slab is a copy, also between shards of one device: a
    write into it leaves the sender's rows as they were.  Gather and
    scatter are inverses, each counted with its bytes."""
    mesh = make_mesh(2, device="cpu")
    slabs = [torch.arange(3.0), torch.arange(3.0) + 10]
    got = mesh.ppermute(slabs, 1)
    got[1].fill_(-1.0)
    assert torch.equal(slabs[0], torch.arange(3.0))
    assert not got[0].any()
    v = torch.arange(7.0)
    mesh.reset_counts()
    v2 = mesh.scatter(v, 4)
    assert torch.equal(mesh.gather(v2), v)
    assert (mesh.counts["scatter"], mesh.counts["scatter_bytes"],
            mesh.counts["gather"], mesh.counts["gather_bytes"]) == (
        1, 28, 1, 28)


def _diagonal_ops(dtype):
    """A stencil, a DIA and a lane-ELL matrix of hpcg:8x8x8's diagonal
    alone (no halo: each shard's SpMV reads only its own rows) and an
    x."""
    St = bt.stencil_op.from_source_operator("hpcg:8x8x8", dtype, device="cpu")
    St = dataclasses.replace(St, legs=((0, 0, 0),),
                             coeffs=torch.tensor([26.0], dtype=dtype),
                             coeff_values=(26.0,))
    n = St.n_rows
    I = np.arange(n)
    csr = bt.matrix.convert_coo_to_csr(bt.MatrixCOO.from_arrays(
        I, I, 26.0 + I % 5, n_rows=n, n_cols=n))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(n)).to(
        dtype)
    return {"stencil": St,
            "dia": bt.from_csr(csr, dtype, "dia", device="cpu"),
            "lane_ell": bt.from_csr(csr, dtype, "lane_ell", device="cpu")}, x


@pytest.mark.parametrize("family", ["stencil", "dia", "lane_ell"])
def test_placement_on_two_devices(family):
    """On Mesh(["cpu", "meta"]) an operator's shard data lies on each
    shard's device, and a mesh SpMV gives shard 0's rows equal to the
    single-device SpMV's and shard 1's as a meta tensor of its shape."""
    ops, x = _diagonal_ops(torch.float64)
    A = ops[family]
    mesh = Mesh(["cpu", "meta"])
    wrap = {"stencil": lambda: tmo.wrap_stencil(
        dataclasses.replace(A, shards=2), mesh, "rows"),
        "dia": lambda: tmo.wrap_dia(A, mesh, "rows"),
        "lane_ell": lambda: tmo.wrap_lane_ell(A, mesh, "rows")}[family]()
    data = {"stencil": [op.coeffs for op in getattr(wrap, "ops", ())],
            "dia": getattr(wrap, "data_shards", ()),
            "lane_ell": getattr(wrap, "vals_shards", ())}[family]
    devs = [torch.device("cpu"), torch.device("meta")]
    assert [t.device for t in data] == devs
    x2 = mesh.scatter(x, wrap.blocks.rows)
    y = spmv(wrap, x2)
    R = wrap.blocks.rows
    assert [t.device for t in y.shards] == devs
    assert torch.equal(y.shards[0], spmv(A, x)[:R])
    # lane-ELL's row tile puts all 512 rows on shard 0 (an empty shard 1)
    assert y.shards[1].shape == (max(A.n_rows - R, 0),)


def test_setup_placement_and_mixing_on_two_devices():
    """shard_setup on Mesh(["cpu", "meta"]): b, x0, the diagonals and
    every operator's shard data (the stencil's coefficients, the
    superblock solves' per-shard rows) on their shard's device; the SpMV
    of the whole HPCG stencil, whose halo crosses the two shards, raises
    there, as any operation that mixes two devices' rows does."""
    A = bt.stencil_op.from_source_operator("hpcg:8x8x8", torch.float64,
                                           device="cpu")
    cfg = bt.SolverConfig(
        preconditioner=bt.PrecondType.SYMMETRIC_GAUSS_SEIDEL,
        dtype=torch.float64)
    mesh = Mesh(["cpu", "meta"])
    s2 = shard_setup(bt.preprocessing_device(A, cfg), mesh, mode="shard_map")
    devs = [torch.device("cpu"), torch.device("meta")]
    for v in (s2.b, s2.x0, s2.A_D, s2.M.A_D):
        assert isinstance(v, MeshVector)
        assert [t.device for t in v.shards] == devs
    assert [op.coeffs.device for op in s2.A.ops] == devs
    L = s2.M.L_block
    assert [e[0].device for e in L.exchange[0]] == devs
    for k, Bs in enumerate(L.shards):
        for t in (Bs.dinv_rows, Bs.d_rows, Bs.table, Bs.table_dinv):
            assert t is None or t.device == devs[k]
    with pytest.raises((NotImplementedError, RuntimeError)):
        spmv(s2.A, s2.b)
    with pytest.raises(RuntimeError, match="device"):
        torch.add(s2.b.shards[0], s2.b.shards[1][:1])


def test_fused_gmres_runs_the_basis_passes_per_shard():
    """Fused-mode GMRES on the mesh: #6 and #7 (their plain twins here) on
    each shard's columns of V, the Gram partials and ‖v‖² summed by psum:
    the same iteration count as the single-device fused solve, histories
    within float32 rounding."""
    cfg = bt.SolverConfig(method=bt.SolverType.GMRES, restart_length=10,
                          orthog_mode="fused", dtype=torch.float32,
                          tolerance=1e-5)
    A = bt.stencil_op.from_source_operator("hpcg:8x8x8", torch.float32,
                                           device="cpu")
    r1 = bt.solve(bt.preprocessing_device(A, cfg))
    s8 = shard_setup(bt.preprocessing_device(A, cfg),
                     make_mesh(8, device="cpu"))
    r8 = bt.solve(s8)
    assert isinstance(r8.x_star, MeshVector)
    assert r8.converged and r8.iter_count == r1.iter_count
    np.testing.assert_allclose(r8.residual_norms[:-1],
                               r1.residual_norms[:-1], rtol=1e-4)


@pytest.mark.parametrize("shards", [3, 8])
def test_f32_dot_does_not_hang_on_the_shard_cut(shards):
    """ops.blas1.whole_dot of float32 vectors: their products summed in
    float64, one rounding to float32, so the mesh's dot (the shards'
    float64 partials summed by psum) equals one device's bit for bit,
    where float32 sums in another order need not."""
    n = 4099
    g = np.random.default_rng(3)
    a, b = (torch.from_numpy(g.standard_normal(n) * 10.0 ** g.uniform(
        -3, 3, n)).to(torch.float32) for _ in range(2))
    mesh = make_mesh(shards, device="cpu")
    rows = -(-n // shards)
    a8, b8 = mesh.scatter(a, rows), mesh.scatter(b, rows)
    whole = bt.ops.blas1.whole_dot(a, b)
    assert whole.dtype == torch.float32
    assert torch.equal(whole,
                       torch.sum(a * b, dtype=torch.float64).float())
    got = bt.ops.blas1.whole_dot(a8, b8)
    assert got.dtype == torch.float32 and torch.equal(got, whole)
    assert torch.equal(bt.ops.blas1.euclidean_vec_norm(a8),
                       bt.ops.blas1.euclidean_vec_norm(a))


def test_mesh_census_flags_a_whole_vector_round_trip_in_the_loop():
    """The negative control of parallel.census.mesh_census: a CG whose
    step gathers x and scatters it back is flagged for both, in the
    loop, with the vector's elements; the same CG without it has none."""
    from basic_iterative_solvers_tpu_torch.parallel import mesh_census
    from basic_iterative_solvers_tpu_torch.solvers import make_method
    A = bt.stencil_op.from_source_operator("hpcg:8x8x8", torch.float64,
                                           device="cpu")
    cfg = bt.SolverConfig(dtype=torch.float64, max_iters=3, tolerance=0.0)
    s8 = shard_setup(bt.preprocessing_device(A, cfg),
                     make_mesh(8, device="cpu"), mode="shard_map")
    mesh, n = s8.b.mesh, A.n_rows
    clean = mesh_census(s8)
    assert clean["full_gathers"] == [], clean
    assert clean["in_while"]["all-gather"] == clean["in_while"][
        "scatter"] == 0
    method = make_method(s8)
    step = method.iterate

    def round_trip(state, active=None):
        out = step(state, active)
        x = out["x"]
        out["x"] = mesh.scatter(mesh.gather(x), x.blocks.rows)
        return out

    method.iterate = round_trip
    c = mesh_census(s8, method)
    assert c["in_while"]["all-gather"] == c["in_while"]["scatter"] == 1, c
    assert ("all-gather", "while", n) in c["full_gathers"]
    assert ("scatter", "while", n) in c["full_gathers"]
    assert {w for _k, w, _e in c["full_gathers"]} == {"while"}
