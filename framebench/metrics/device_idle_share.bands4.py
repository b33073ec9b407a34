"""The four-card cell's split of device_idle_share (it moves
frame_ms.bands4), read as device_idle_share reads it: rank 0's traced
window of graph frames."""

from framebench.harness import spec

read = spec.metric_reader("device_idle_share").read
