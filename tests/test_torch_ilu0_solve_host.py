"""The port's CG, BiCGSTAB and GMRES(50) with exact coloured ILU(0)
(-p ilu0) against the JAX package's, host harness.

Each solve builds the same generator spec in both packages and hands both
b = 2 and x₀ = 1 (the bench's), float64, tolerance 1e-8.  The iteration
counts were measured with the JAX package (its device path:
preprocessing_device with the translation-table pair); `_check_parity`
(tests/test_torch_methods.py) holds the histories to rtol 1e-8 and the
explicit final residual to 1e-4, which sits at the rounding floor of
b − A·x.
"""
import pytest

from basic_iterative_solvers_tpu_torch.ops import block_trisolve as tbt
from tests.test_torch_methods import _check_parity, _solve_both

#: (id, method, config, iterations on HPCG 16³, on HPCG 32×24×20)
SOLVES = [
    ("cg", "CONJUGATE_GRADIENT", {}, 19, 30),
    ("bi", "BICGSTAB", {}, 11, 20),
    ("gm", "GMRES", {"restart_length": 50}, 16, 25),
]
SPECS = ["hpcg:16x16x16", "hpcg:32x24x20"]


def cases():
    return [pytest.param(spec, method, cfg, iters[k], id=f"{sid}-{spec}")
            for sid, method, cfg, *iters in SOLVES
            for k, spec in enumerate(SPECS)]


def run_parity(spec, harness, method, cfg, iters):
    rj, rt = _solve_both(spec, harness, method, "ILU0", tolerance=1e-8,
                         **cfg)
    assert rt.converged and rt.iter_count == iters
    _check_parity(rj, rt)


@pytest.mark.parametrize("spec,method,cfg,iters", cases())
def test_ilu0_host_parity(spec, method, cfg, iters):
    tbt.super_level.table_launches = 0
    run_parity(spec, "host", method, cfg, iters)
    assert tbt.super_level.table_launches == 0      # CPU: plain versions
