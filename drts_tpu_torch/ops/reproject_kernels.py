"""History reprojection kernel of the port: wrapper, plain version, counter.

``reproject_packed`` replaces ``drts_tpu/ops/reproject_pallas.py``'s
``reproject_window`` (B4), reached through ``reproject_packed``, with the
exact gather that its tile windows approximate (``csrc/reproject.cu``):
every pixel samples the (H, W, C) history at pixel + motion, in nearest
mode (round-half-even, clamped; the words copied as int32, so f16-packed
rows arrive bit for bit) or clamp-addressed bilinear mode (the formulas of
``reproject_pallas._gather_fallback``). ``ok`` is the sample point's
in-frame test. The TPU kernel's extra ``ok=False`` for residuals outside
both of its windows has no counterpart: the gather is exact for any motion.
A ``row0`` writes only the rows of a band of the frame: motion holds the
band's h rows, the history the whole frame's, and output row y samples
history row row0 + y + motion y (the sharded frame's history fetch).

What bounds it on the H100: memory. One row of C words per tap in, C words
out and the motion per pixel. The kernel is one thread per (pixel, vector
of V words): ``vector_width`` picks V = 4, 2 or 1 from C and the
pointers' alignment, so a warp moves contiguous 4V-byte vectors; in
bilinear mode one thread takes a pixel's C channels. A block covers a 2-D
patch of the output (about 32 vector slots by 8 rows, set in the
``.cu``), so its taps fall into a few source rows where the motion is
smooth.

Dispatch is by the tensor's device: a CPU tensor takes the plain version;
a CUDA tensor launches the kernel, or the wrapper raises.
"""

from __future__ import annotations

import torch

from .. import backend

MODES = ("nearest", "bilinear")


def vector_width(c: int, *tensors) -> int:
    """Words per thread of the nearest-mode kernel: 4 where C % 4 == 0 and
    every tensor's data is 16-byte aligned, 2 where C % 2 == 0 and it is
    8-byte aligned, else 1."""
    for v in (4, 2):
        if c % v == 0 and all(t.data_ptr() % (4 * v) == 0 for t in tensors):
            return v
    return 1


def _coords(motion, src_h: int, row0: int):
    h, w = motion.shape[:2]
    dev = motion.device
    px = torch.arange(w, dtype=torch.float32, device=dev)[None, :] \
        + motion[..., 0]
    py = torch.arange(row0, row0 + h, dtype=torch.float32,
                      device=dev)[:, None] + motion[..., 1]
    ok = (px >= 0) & (px <= w - 1) & (py >= 0) & (py <= src_h - 1)
    return px, py, ok


def _clamp_index(v, hi: int):
    """Float -> index in [0, hi]; NaN goes to 0, as the kernel's fmaxf."""
    return torch.clamp(torch.nan_to_num(v, nan=0.0), 0, hi).long()


def reproject_packed_plain(src, motion, mode: str = "bilinear",
                           row0: int = 0):
    """Plain PyTorch B4. src (H, W, C) float32; motion (h, W, 2) pixel
    offsets (x, y) of the h rows from history row `row0` on (the whole
    frame by default). Returns (out (h, W, C), ok (h, W) bool): output row
    y samples the history at (x + motion x, row0 + y + motion y)."""
    h, w, c = src.shape
    px, py, ok = _coords(motion, h, row0)
    if mode == "nearest":
        lin = _clamp_index(torch.round(py), h - 1) * w \
            + _clamp_index(torch.round(px), w - 1)
        bits = src.reshape(h * w, c).view(torch.int32)
        return bits[lin].view(torch.float32), ok
    flat = src.reshape(h * w, c)
    y0 = torch.floor(py)
    x0 = torch.floor(px)
    fy = (py - y0)[..., None]
    fx = (px - x0)[..., None]
    y0i = _clamp_index(y0, h - 1)
    x0i = _clamp_index(x0, w - 1)
    y1i = torch.clamp(y0i + 1, max=h - 1)
    x1i = torch.clamp(x0i + 1, max=w - 1)
    out = ((flat[y0i * w + x0i] * (1 - fx) + flat[y0i * w + x1i] * fx)
           * (1 - fy)
           + (flat[y1i * w + x0i] * (1 - fx) + flat[y1i * w + x1i] * fx)
           * fy)
    return out, ok


def reproject_packed(src, motion, mode: str = "bilinear", row0: int = 0):
    """B4; see reproject_packed_plain for the contract. A CUDA tensor
    launches drts_reproject (csrc/reproject.cu)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if src.dim() != 3 or src.dtype != torch.float32:
        raise ValueError(f"src must be (H, W, C) float32, got "
                         f"{tuple(src.shape)} {src.dtype}")
    src_h, w, c = src.shape
    h = motion.shape[0]
    if (motion.dim() != 3 or tuple(motion.shape[1:]) != (w, 2)
            or motion.dtype != torch.float32
            or not 0 <= row0 <= row0 + h <= src_h):
        raise ValueError(f"motion must be (h, {w}, 2) float32 with rows "
                         f"{row0} + h within {src_h}, got "
                         f"{tuple(motion.shape)} {motion.dtype}")
    if src.device != motion.device:
        raise ValueError(f"src on {src.device}, motion on {motion.device}")
    if src.device.type == "cpu":
        return reproject_packed_plain(src, motion, mode, row0)
    if src.device.type != "cuda":
        raise ValueError(f"unsupported device {src.device}")
    src = src.contiguous()
    motion = motion.contiguous()
    if motion.data_ptr() % 8:
        motion = motion.clone()   # the kernel loads (x, y) as one float2
    out = src.new_empty((h, w, c))
    ok = torch.empty((h, w), dtype=torch.bool, device=src.device)
    bilinear = mode == "bilinear"
    vec = 1 if bilinear else vector_width(c, src, out)
    rc = backend.kernels().drts_reproject(
        src.data_ptr(), motion.data_ptr(), h, src_h, row0, w, c,
        int(bilinear), vec, out.data_ptr(), ok.data_ptr(),
        backend.stream_handle(src))
    backend.check_launch(rc, "drts_reproject")
    backend.launched("reproject_packed")
    return out, ok
