"""Device time of the NCCL kernels on rank 0, ms per traced graph frame
(the collectives of parallel/mesh: halos, gathers, the SHARC
reduce-scatter, the counters' all-reduce)."""

import re

PATTERN = re.compile(r"^nccl", re.IGNORECASE)


def read(r):
    if not r.graph_frames:
        return None
    secs = sum(e - s for n, s, e in r.kernels if PATTERN.search(n)) * 1e-6
    return secs * 1e3 / r.graph_frames if secs else None
