"""`python -m basic_iterative_solvers_tpu_torch <matrix> <method> ...`."""
from .cli import run

if __name__ == "__main__":
    raise SystemExit(run())
