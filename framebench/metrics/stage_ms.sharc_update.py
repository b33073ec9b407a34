"""Device time of the frame graph's `sharc_update` stage, ms per frame: the
kernels that ran inside the benchmark's span around the stage in the
eager frames after the window (the same kernels as a graph frame's),
averaged over a SHARC cadence cycle."""

STAGE = "sharc_update"


def read(r):
    if STAGE not in r.stage_ms:
        return None
    return r.stage_ms[STAGE]
