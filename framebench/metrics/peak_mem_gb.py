"""Peak device memory allocated over the measured window, GB (rank 0's
on the sharded frame): max_memory_allocated after reset_peak_memory_stats
at the window's start."""


def read(r):
    return r.peak_bytes / 1e9 if r.peak_bytes else None
