"""The four-card cell's split of peak_mem_gb (it moves frame_ms.bands4),
read as peak_mem_gb reads it: rank 0's window."""

from framebench.harness import spec

read = spec.metric_reader("peak_mem_gb").read
