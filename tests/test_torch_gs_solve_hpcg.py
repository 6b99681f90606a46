"""The port's GS-family solves against the JAX package's, HPCG 16³, host
harness (the superblock route), with the case table the other
test_torch_gs_solve_* files share.

Each case builds the same generator spec in both packages and hands both
b = 2 and x₀ = 1 (the bench's), float64, tolerance 1e-10, GMRES(50),
one Richardson sweep for the two-stage types.  The iteration counts were
measured with the JAX package; `_check_parity` (tests/test_torch_methods.py)
holds the histories to rtol 1e-8 and the explicit final residual to 1e-4.
"""
import pytest

from tests.test_torch_methods import _check_parity, _solve_both

#: the port's entry points run on the card unless asked; these tests
#: run on the CPU
CPU = "cpu"

#: (id, method, preconditioner, config, iterations on HPCG 16³, on fdm:16)
SOLVES = [
    ("gs", "GAUSS_SEIDEL", "NONE", {}, 304, 674),
    ("sgs", "SYMMETRIC_GAUSS_SEIDEL", "NONE", {}, 233, 673),
    ("cg_sgs", "CONJUGATE_GRADIENT", "SYMMETRIC_GAUSS_SEIDEL", {}, 23, 22),
    ("gm_sgs", "GMRES", "SYMMETRIC_GAUSS_SEIDEL", {"restart_length": 50},
     21, 21),
    ("bi_sgs", "BICGSTAB", "SYMMETRIC_GAUSS_SEIDEL", {}, 14, 15),
    ("bi_bgs", "BICGSTAB", "BACKWARDS_GAUSS_SEIDEL", {}, 17, 14),
    ("cg_s2st", "CONJUGATE_GRADIENT", "SYMMETRIC_TWO_STAGE_GS",
     {"precond_inner_iters": 1}, 26, 29),
]
HPCG = "hpcg:16x16x16"


def cases(ids=None):
    return [pytest.param(*c[1:], id=c[0]) for c in SOLVES
            if ids is None or c[0] in ids]


def run_parity(spec, harness, method, precond, cfg, iters,
               final_rtol=1e-4):
    """Solve in both packages; check the count and `_check_parity`."""
    rj, rt = _solve_both(spec, harness, method, precond, tolerance=1e-10,
                         **cfg)
    assert rt.converged and rt.iter_count == iters
    _check_parity(rj, rt, final_rtol)


def route(spec, method, precond, cfg):
    """(GS method on the superblock pair, preconditioner on it) of the
    port's setup for this case."""
    import torch
    import basic_iterative_solvers_tpu_torch as bt
    A = bt.stencil_op.from_source_operator(spec, torch.float64, device=CPU)
    s = bt.preprocessing_device(A, bt.SolverConfig(
        method=bt.SolverType[method], preconditioner=bt.PrecondType[precond],
        dtype=torch.float64, **cfg))
    return (s.gs_L_block is not None,
            s.M.L_block is not None or s.M.U_block is not None)


@pytest.mark.parametrize("method,precond,cfg,iters,_fdm", cases())
def test_hpcg_host_parity(method, precond, cfg, iters, _fdm):
    run_parity(HPCG, "host", method, precond, cfg, iters)
    gs_method = precond == "NONE"
    colored_precond = "GAUSS_SEIDEL" in precond and "TWO" not in precond
    assert route(HPCG, method, precond, cfg) == (gs_method, colored_precond)
