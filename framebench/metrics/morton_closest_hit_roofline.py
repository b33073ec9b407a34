"""B1's share of its roofline, in %: the least time its launches could
take (their least bytes over the card's memory bandwidth: it is bound by
bytes), over its device time. Device time per frame from the traced graph
frames by kernel name; least bytes per frame counted from the inputs of
its launches in the eager frames (harness.roofline)."""

from framebench.harness import roofline

KERNEL = "morton_closest_hit"
WRAP = ("drts_tpu_torch.ops.intersect_kernels", "intersect_morton",
        roofline.closest_hit_bytes)


def read(r):
    secs = r.kernel_seconds(roofline.kernel_pattern(KERNEL))
    least = r.bytes.get(KERNEL + "_roofline")
    bw = roofline.HBM_BYTES_PER_S.get(r.device_name)
    if not (secs and least and bw and r.graph_frames and r.eager_frames):
        return None
    per_frame_s = secs / r.graph_frames
    per_frame_b = least / r.eager_frames
    return 100.0 * (per_frame_b / bw) / per_frame_s
