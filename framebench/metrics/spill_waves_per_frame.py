"""Spill waves a graph frame replayed, over the measured window: the
graph callable's GraphStats.spill_waves over its frames (the compiled
frame's layer)."""


def read(r):
    return r.spill_waves_per_frame
