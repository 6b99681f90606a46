"""setup_s: seconds from process start to the window's start: torch and
CUDA start-up, the port's kernels loaded (built on a checkout's first
run), operator and preconditioner on the card, one warm-up solve."""


def read(run):
    return run.setup_s
