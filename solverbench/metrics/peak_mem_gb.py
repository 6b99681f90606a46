"""peak_mem_gb: torch.cuda.max_memory_allocated over set-up and window,
reset at the start of the run, in 10^9 bytes."""


def read(run):
    return run.memory_peak_bytes / 1e9 if run.memory_peak_bytes else None
