"""``torch.cuda.max_memory_allocated`` over the window, after
``reset_peak_memory_stats`` at its start, in GB (1e9 bytes).  None off
the card."""


def read(run):
    return run.peak_bytes / 1e9 if run.peak_bytes else None
