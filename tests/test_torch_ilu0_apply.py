"""The port's factor-table superblock solves (the plain versions of kernel
#9 in factor-table mode and of the split pair #10/#11) against the JAX
package's exact coloured ILU(0) apply.

The JAX side runs its XLA path (float64); its Pallas kernels are in
tests/test_torch_ilu0_pallas.py.  The port's split route is held against
its fused route, and the pair carried across from the JAX package's
translation tables (convert.ilu0_pair_from_numpy) against the port's own.
Inputs come from `numpy.random.default_rng`.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from basic_iterative_solvers_tpu import _native
from basic_iterative_solvers_tpu import coloring as jcol
from basic_iterative_solvers_tpu import stencil_op as jso
from basic_iterative_solvers_tpu.ops import block_trisolve as jbt

from basic_iterative_solvers_tpu_torch import coloring as tcol
from basic_iterative_solvers_tpu_torch import convert
from basic_iterative_solvers_tpu_torch import stencil_op as tso
from basic_iterative_solvers_tpu_torch.ops import block_trisolve as tbt

#: the port's entry points run on the card unless asked; these tests
#: run on the CPU
CPU = "cpu"

SPECS = ["hpcg:16x16x16", "hpcg:32x24x20", "hpcg:12x8x6"]


def _pairs(spec, np_dt, t_dt):
    Aj = jso.from_source_operator(spec, dtype=np_dt)
    At = tso.from_source_operator(spec, t_dt, device=CPU)
    pj = jbt.build_superblock_ilu0_pair_stencil(
        Aj, jcol.spec_for_device(Aj), dtype=np_dt)
    pt = tbt.build_superblock_ilu0_pair_stencil(
        At, tcol.spec_for_device(At), dtype=t_dt)
    return pj, pt, At


def _y(n, seed, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal(n).astype(dtype)


def _split(B):
    return dataclasses.replace(B, fused=False, _args={})


@pytest.mark.parametrize("spec", SPECS)
def test_pair_metadata_matches_jax(spec):
    """Levels (superblock, cross groups, self legs) equal the JAX
    package's; L has no pivots, U one per class."""
    (Lj, Uj), (Lt, Ut), At = _pairs(spec, np.float64, torch.float64)
    assert Lt.levels == Lj.levels and Ut.levels == Uj.levels
    assert (Lt.S, Lt.sx, Lt.m) == (Lj.S, Lj.sx, Lj.m)
    assert Lt.table_dinv is None and Ut.table_dinv is not None
    assert Lt.table.shape == (27, int(np.prod(Lt.proto)))
    assert Lt.table is Ut.table and Lt.fused and Ut.fused


@pytest.mark.parametrize("spec", SPECS)
def test_plain_apply_f64_matches_jax_xla(spec):
    """blocked_ilu0 (plain) against the JAX package's XLA apply: cross
    legs in (src, Δ) order, then self legs, each product and difference
    rounded alone as XLA's separate ops round them: rtol 1e-14."""
    pj, pt, At = _pairs(spec, np.float64, torch.float64)
    y = _y(At.n_rows, 7)
    ref = np.asarray(jbt.blocked_ilu0(*pj, jnp.asarray(y), use_pallas=False))
    got = tbt.blocked_ilu0(*pt, torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-14, atol=1e-14)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("spec", ["hpcg:12x8x6", "hpcg:40x8x6"])
def test_split_route_equals_fused_route(spec, dtype):
    """The split route (acc for the whole level, then one step per
    x-parity) rounds exactly as the fused level: bit for bit, per level
    and for a whole apply."""
    At = tso.from_source_operator(spec, dtype, device=CPU)
    L, U = tbt.build_superblock_ilu0_pair_stencil(
        At, tcol.spec_for_device(At), dtype=dtype)
    y = torch.from_numpy(_y(At.n_rows, 11)).to(dtype)
    x = torch.from_numpy(_y(At.n_rows, 12)).to(dtype)
    for B in (L, U):
        for li, (_sb, cross, _s) in enumerate(B.levels):
            fused = tbt.super_level(B, li, y, x.clone())
            split = x.clone()
            acc = torch.empty(B.m, dtype=dtype)
            if cross:
                tbt.super_acc(B, li, y, split, acc)
            for p in tbt._parity_order(B):
                tbt.super_parity(B, li, p, y, acc if cross else None, split)
            assert torch.equal(split, fused)
    assert torch.equal(tbt.blocked_ilu0(_split(L), _split(U), y),
                       tbt.blocked_ilu0(L, U, y))


@pytest.mark.parametrize("spec", ["hpcg:16x16x16", "hpcg:32x24x20"])
def test_pair_carried_across_applies_like_own(spec, monkeypatch):
    """The pair convert.ilu0_pair_from_numpy builds from the JAX package's
    translation tables (its NumPy factorization branch) applies bit for
    bit like the pair the port factors itself."""
    monkeypatch.setenv("BIS_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(_native, "_LIB", None)
    monkeypatch.setattr(_native, "_TRIED", True)
    Aj = jso.from_source_operator(spec, dtype=np.float64)
    sj = jcol.spec_for_device(Aj)
    tables = jbt._ilu0_translation_tables(
        Aj, tuple(int(p) for p in sj.params), sj.n_colors, 1e-8, 1e-4)
    At = tso.from_source_operator(spec, torch.float64, device=CPU)
    carried = convert.ilu0_pair_from_numpy(At, tables, dtype=torch.float64)
    own = tbt.build_superblock_ilu0_pair_stencil(
        At, tcol.spec_for_device(At), dtype=torch.float64)
    y = torch.from_numpy(_y(At.n_rows, 13))
    assert torch.equal(tbt.blocked_ilu0(*carried, y),
                       tbt.blocked_ilu0(*own, y))
    T, Td, proto, R, h = tables
    with pytest.raises(ValueError, match="prototype"):
        convert.ilu0_pair_from_numpy(At, (T[:, :-1], Td, proto, R, h),
                                     dtype=torch.float64)


def test_level_writes_own_rows_and_checks():
    """A factor-table level writes only its superblock's rows, the U solve
    runs in place, and bad operands raise."""
    At = tso.from_source_operator("hpcg:8x8x8", torch.float64, device=CPU)
    L, U = tbt.build_superblock_ilu0_pair_stencil(
        At, tcol.spec_for_device(At), dtype=torch.float64)
    y = torch.from_numpy(_y(512, 14))
    x = torch.full_like(y, 7.0)
    tbt.super_level(L, 0, y, x)
    sb = L.levels[0][0]
    i = torch.arange(512)
    mine = ((i // 8) % 8 % 2 + 2 * ((i // 64) % 2)) == sb
    assert bool((x[~mine] == 7.0).all()) and not bool((x[mine] == 7.0).any())
    t = tbt.blocked_trisolve(L, y)
    ref = tbt.blocked_ilu0(L, U, y)
    for li in range(len(U.levels)):
        tbt.super_level(U, li, t, t)
    assert torch.equal(t, ref)
    acc = torch.empty(L.m, dtype=torch.float64)
    with pytest.raises(TypeError):
        tbt.super_acc(L, 1, y.float(), x, acc)
    with pytest.raises(ValueError):
        tbt.super_acc(L, 1, y, x, acc[:-1])
    with pytest.raises(ValueError, match="cross legs"):
        tbt.super_parity(L, 1, 0, y, None, x)
    with pytest.raises(IndexError):
        tbt.super_parity(L, 0, 2, y, None, x)
    Lc, Uc = tbt.build_superblock_gs_pair_stencil(
        At, tcol.spec_for_device(At), dtype=torch.float64)
    with pytest.raises(ValueError, match="factor-table"):
        tbt.blocked_ilu0(Lc, Uc, y)
    with pytest.raises(ValueError, match="split route"):
        tbt.super_acc(Lc, 1, y, x, acc)


def _struct_fields(source: str, name: str):
    """(type, field, array?) of each member of the C struct `name`."""
    import re
    body = re.search(r"struct %s \{(.*?)\};" % name, source, re.S).group(1)
    fields = []
    for decl in re.sub(r"//[^\n]*", "", body).split(";"):
        decl = decl.strip()
        if not decl:
            continue
        ctype, names = decl.split(None, 1) if not decl.startswith(
            "long long") else ("long long", decl[len("long long"):])
        for f in names.split(","):
            f = f.strip()
            fields.append((ctype, f.split("[")[0], "[" in f))
    return fields


def test_launch_table_mirrors_the_kernel_struct():
    """SuperLevelArgs (the ctypes mirror in _build.py) lists the fields of
    BisSuperLevelArgs in csrc/block_trisolve.cu in order, with the same
    types and array lengths, 8-byte fields first (no padding but the tail
    up to the struct's 8-byte alignment), so the kernel reads what the
    wrapper wrote; the library checks the size again when it loads."""
    import ctypes
    import pathlib
    from basic_iterative_solvers_tpu_torch import _build
    src = (pathlib.Path(_build.__file__).parent / "csrc" /
           "block_trisolve.cu").read_text()
    c_fields = _struct_fields(src, "BisSuperLevelArgs")
    mirror = _build.SuperLevelArgs._fields_
    assert [f for _t, f, _a in c_fields] == [f for f, _t in mirror]
    size = {"long long": 8, "double": 8, "int": 4}
    for (ctype, _f, is_array), (_n, ptype) in zip(c_fields, mirror):
        n = _build.MAX_LEGS if is_array else 1
        assert ctypes.sizeof(ptype) == size[ctype] * n
        assert ("c_int" in repr(ptype)) == (ctype == "int")
    assert "#define BIS_SL_MAX_LEGS %d" % _build.MAX_LEGS in src
    packed = sum(size[t] * (_build.MAX_LEGS if a else 1)
                 for t, _f, a in c_fields)
    assert ctypes.sizeof(_build.SuperLevelArgs) == -(-packed // 8) * 8


def _proto_class(i, n, P, s, R):
    """csrc/block_trisolve.cu's proto_class, in NumPy."""
    if P == n:
        return i
    c = np.where(i < R, i, np.where(n - 1 - i < R, P - 1 - (n - 1 - i),
                                    R + (i - R) % s))
    return np.clip(c, 0, P - 1)


def _emulate_level(a, y, x, table, tdinv, split=False):
    """The fused level kernel (or the split pair, acc returned beside x)
    from its launch table, in NumPy: each product and difference is one
    NumPy operation, rounded alone, as the kernel rounds it."""
    x = x.copy()
    line = np.arange(a.lines)[:, None]
    gx = np.arange(a.nx)[None, :]
    gy = a.sy * (line % a.my) + a.py
    gz = a.sz * (line // a.my) + a.pz
    i = a.nx * (gy + a.ny * gz) + gx
    base = (_proto_class(gx, a.nx, a.proto_x, a.sx, a.radius)
            + a.proto_x * (_proto_class(gy, a.ny, a.proto_y, a.sy, a.radius)
                           + a.proto_y * _proto_class(gz, a.nz, a.proto_z,
                                                      a.sz, a.radius)))
    acc = y[i]
    for l in range(a.n_cross):
        px, py, pz = gx + a.cross_dx[l], gy + a.cross_dy[l], gz + a.cross_dz[l]
        ok = ((px >= 0) & (px < a.nx) & (py >= 0) & (py < a.ny) & (pz >= 0)
              & (pz < a.nz))
        f = table[a.cross_kd[l] * a.n_proto + base]
        acc = np.where(ok, acc - f * x[np.where(ok, i + a.cross_off[l], 0)],
                       acc)
    x[i] = acc
    for step in range(a.sx):
        p = a.sx - 1 - step if a.upper else step
        v = x[i]
        for l in range(a.n_self):
            px = gx + a.self_dx[l]
            ok = (px >= 0) & (px < a.nx)
            ps = np.where(ok, px, 0) % a.sx
            ok &= (ps > p) if a.upper else (ps < p)
            f = table[a.self_kd[l] * a.n_proto + base]
            v = np.where(ok, v - f * x[np.where(ok, i + a.self_dx[l], 0)], v)
        if tdinv is not None:
            v = v * tdinv[base]
        x[i] = np.where(gx % a.sx == p, v, x[i])
    return (x, acc.reshape(-1)) if split else x


@pytest.mark.parametrize("spec", ["hpcg:32x24x20", "hpcg:12x8x6"])
def test_launch_table_reproduces_plain_level(spec):
    """Each level's factor-mode launch table (leg table rows, prototype
    dims, class radius, line geometry) drives an emulation of the kernel
    that equals super_level_plain bit for bit, and its acc equals
    super_acc_plain's; the class map covers mapped axes (32×24×20)."""
    At = tso.from_source_operator(spec, torch.float64, device=CPU)
    L, U = tbt.build_superblock_ilu0_pair_stencil(
        At, tcol.spec_for_device(At), dtype=torch.float64)
    y, x = _y(At.n_rows, 15), _y(At.n_rows, 16)
    table = L.table.numpy().reshape(-1)
    for B in (L, U):
        tdinv = None if B.table_dinv is None else B.table_dinv.numpy()
        for li, (_sb, cross, selfs) in enumerate(B.levels):
            a = tbt._level_args(B, li)
            assert (a.proto_x, a.proto_y, a.proto_z) == B.proto
            assert (a.radius, a.n_proto) == (B.radius, int(np.prod(B.proto)))
            assert [a.cross_kd[j] for j in range(a.n_cross)] == [
                kd for kd, *_ in B.table_cross[li]]
            assert [a.self_kd[j] for j in range(a.n_self)] == [
                kd for kd, _dx in B.table_self[li]]
            assert (a.n_cross, a.n_self, a.upper) == (
                len(cross), len(selfs), int(B.upper))
            assert a.block_x * a.block_y == 256
            assert a.grid_x * a.block_y >= a.lines == B.m // At.dims[0]
            got, acc = _emulate_level(a, y, x, table, tdinv, split=True)
            ref = tbt.super_level_plain(B, li, torch.from_numpy(y),
                                        torch.from_numpy(x.copy())).numpy()
            np.testing.assert_array_equal(got, ref)
            if cross:
                ref_acc = tbt.super_acc_plain(
                    B, li, torch.from_numpy(y), torch.from_numpy(x),
                    torch.empty(B.m, dtype=torch.float64)).numpy()
                np.testing.assert_array_equal(acc, ref_acc)


def test_table_route_kept_with_the_launch_table():
    """level_route_for works each factor-table level's route out once per
    vector type and card and keeps it with the launch tables, the whole
    level's on B and a mesh shard's on the shard: a kept route comes back
    without the kernel library (which this machine cannot build), and
    float64 takes the direct route without it."""
    from basic_iterative_solvers_tpu_torch.parallel import make_mesh
    At = tso.from_source_operator("hpcg:16x16x16", torch.float32,
                                  device=CPU)
    L, _U = tbt.build_superblock_ilu0_pair_stencil(
        At, tcol.spec_for_device(At), dtype=torch.float32)
    Bs = tbt.shard_superblock(L, make_mesh(2, device=CPU)).shards[1]
    card = torch.device("cuda", 0)
    L._args[("route", 1, 4, 0)] = "staged"
    Bs._args[("route", 1, 4, 0)] = "direct"
    for _ in range(2):
        assert tbt.level_route_for(L, 1, 4, device=card) == "staged"
        assert tbt.level_route_for(L, 1, 4, Bs, card) == "direct"
    assert tbt.level_route_for(L, 0, 8, device=card) == "direct"
    assert L._args[("route", 0, 8, 0)] == "direct"
    assert ("route", 0, 8, 0) not in Bs._args
    assert tbt.level_route_for(L, 0, 8, Bs, card) == "direct"
    assert Bs._args[("route", 0, 8, 0)] == "direct"
