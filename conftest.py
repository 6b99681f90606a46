"""Session set-up that runs once, before any test process starts.

The JAX package's native host library (basic_iterative_solvers_tpu/
_native.py) compiles itself at first use straight into csrc/libbis_host.so
and trusts that file once it exists.  Under pytest-xdist every worker
imports every test module while collecting, so on a tree without the
library several workers would start the same g++ at once, and a worker
that loads the half-written file keeps the failure for its whole life:
tests/test_native.py and tests/test_torch_native.py then skip there.

`pytest_configure` below builds the library once, in the controlling
process only (an xdist worker carries `workerinput`), before the workers
start; with the file in place no worker compiles.  It registers no marker
and selects or skips nothing.  A failed build changes nothing: the tests
decide for themselves, as before.
"""
import os
import subprocess
import sys

_ROOT = os.path.dirname(os.path.abspath(__file__))

#: loads the JAX package's _native.py by its path (the module imports no
#: JAX) and lets it build and load the library
_BUILD = (
    "import importlib.util, sys\n"
    "spec = importlib.util.spec_from_file_location('bis_native_build', "
    "sys.argv[1])\n"
    "mod = importlib.util.module_from_spec(spec)\n"
    "spec.loader.exec_module(mod)\n"
    "mod.available()\n")


def pytest_configure(config):
    if hasattr(config, "workerinput"):
        return
    src = os.path.join(_ROOT, "basic_iterative_solvers_tpu", "_native.py")
    if not os.path.exists(src) or os.path.exists(
            os.path.join(_ROOT, "csrc", "libbis_host.so")):
        return
    try:
        subprocess.run([sys.executable, "-c", _BUILD, src], cwd=_ROOT,
                       capture_output=True, timeout=600, check=False)
    except (OSError, subprocess.TimeoutExpired):
        pass
