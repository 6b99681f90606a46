"""Every test process runs torch on one CPU thread.

The tier-1 command runs six pytest-xdist workers on the machine's cores.
Each worker's torch starts an OpenMP pool as wide as the machine, and six
such pools, spinning while they wait, oversubscribe the cores: one ILU(0)
parity case (`test_torch_ilu0_solve_fused.py`, bi-hpcg:32x24x20) took
5 s alone, 810 s beside five copies of itself, and 17 s beside them with
one thread each.  Every worker imports each test module of the run while
it collects, before any test runs, so this module's import sets the width
for the whole run in every worker; the test holds it.
"""
import torch

torch.set_num_threads(1)


def test_torch_runs_on_one_thread():
    assert torch.get_num_threads() == 1
