"""The collective census of the port's GSPMD mode (parallel/census.py),
the JAX package's tests/test_gspmd.py census cases.

Parity (test_torch_gspmd.py) shows the DTensor solves compute the right
answer; these show they communicate the right way: per iteration, scalar
all-reduces for the dots, collective-permutes for the SpMV halos (the
port's point-to-point exchanges, counted by its own counter), and no
all-gather or all-to-all of a full vector.  The solves run on 4 gloo ranks
(tests/torch_gspmd_ranks.py, suite "census") on hpcg 16^3 in DIA form,
where n = 4096 fills the rows; the negative control, the pad-and-slice
SpMV DTensor partitions by gathering x, runs there and in this process on
torch's fake process group.
"""
import pytest
import torch

from torch_gspmd_ranks import RankGroups

GROUPS = (["cg_j", "gm_2st", "bi_s2st", "mg", "negative_gloo"],)
N = 16 ** 3


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    run = RankGroups("census", GROUPS, tmp_path_factory.mktemp("census"))
    yield run
    run.close()


@pytest.mark.parametrize("case", ["cg_j", "gm_2st", "bi_s2st"])
def test_gspmd_collective_structure(ranks, case):
    for c in ranks.case(case):
        w = c["in_while"]
        # a psum per dot product: all-reduces of scalars
        assert w["all-reduce"] >= 1, c
        # the SpMV halos: neighbour exchanges
        assert w["collective-permute"] >= 1, c
        # no full-vector broadcast per iteration
        assert c["full_gathers"] == [], c
        assert w["all-gather"] == 0 and w["all-to-all"] == 0, c


def test_cg_jacobi_counts_per_iteration(ranks):
    """CG + Jacobi on DIA, one iteration: one SpMV (a halo exchange, two
    shifts) and four all-reduces ((t, p), (r, z), (r', z'), ‖r'‖); the
    same on every rank."""
    for c in ranks.case("cg_j"):
        assert c["in_while"] == {"all-reduce": 4, "all-gather": 0,
                                 "collective-permute": 2,
                                 "reduce-scatter": 0, "all-to-all": 0}, c


def test_replicated_preconditioner_gathers_once_an_apply(ranks):
    """The multigrid V-cycle runs whole on every rank: its apply gathers
    the vector (one full all-gather an iteration, flagged "while"), the
    rest of the iteration is CG's."""
    for c in ranks.case("mg"):
        w = c["in_while"]
        assert w["all-gather"] == 1 and w["all-reduce"] >= 1
        assert w["collective-permute"] >= 1
        assert ("all-gather", "while", N) in c["full_gathers"]


def test_census_catches_full_vector_gather_on_ranks(ranks):
    for c in ranks.case("negative_gloo"):
        assert c["full_gathers"] and c["full_gathers"][0][1] == "while"
        assert c["in_while"]["all-gather"] >= 1


def test_census_catches_full_vector_gather():
    """Negative control in this process, on torch's fake process group of
    4 ranks: the scatter-into-padding SpMV's DTensor counterpart (pad, two
    shifted slices) must be FLAGGED as a per-iteration full-vector
    all-gather, as in the JAX package's test."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from basic_iterative_solvers_tpu_torch.parallel import (
        collective_census, make_device_mesh)
    from basic_iterative_solvers_tpu_torch.parallel.gspmd import shard_rows
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        mesh = make_device_mesh()
        n = 1024
        x = shard_rows(torch.ones(n, dtype=torch.float32), mesh)

        def body():
            xp = torch.nn.functional.pad(x, (1, 1))
            return xp[0:n] + xp[2:n + 2]
        c = collective_census(body, full_vector_len=n)
    finally:
        dist.destroy_process_group()
    assert c["full_gathers"], "census failed to flag the all-gather"
    assert c["full_gathers"][0][1] == "while"
    assert c["in_while"]["all-gather"] >= 1


def test_ranks_load_no_jax(ranks):
    assert not any(res["_jax_loaded"] for group in ranks.results()
                   for res in group)
