"""Device time of the frame graph's `trace` stage, ms per frame: the
kernels that ran inside the benchmark's span around the stage in the
eager frames after the window (the same kernels as a graph frame's),
averaged over a SHARC cadence cycle."""

STAGE = "trace"


def read(r):
    if STAGE not in r.stage_ms:
        return None
    return r.stage_ms[STAGE]
