"""Host image helpers of the port: a minimal PNG writer and reader, and
SSIM.

All are numpy-only, so the port needs neither PIL nor the JAX package to
write a rendered frame or check it against ``tests/golden/demo_64.png``.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def write_png(path: str, image: np.ndarray) -> None:
    """Write an (H, W), (H, W, 3) or (H, W, 4) uint8 or float [0, 1] array
    as an 8-bit PNG whose rows all use filter type 0 (so read_png reads it
    back)."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if img.ndim == 2:
        img = img[..., None].repeat(3, -1)
    h, w, c = img.shape
    color_type = {3: 2, 4: 6}[c]

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    raw = b"".join(b"\x00" + img[row].tobytes() for row in range(h))
    png = (_PNG_MAGIC
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type,
                                        0, 0, 0))
           + chunk(b"IDAT", zlib.compress(raw, 6))
           + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit RGB or RGBA, non-interlaced PNG whose rows all use
    filter type 0 (None). Returns (H, W, C) float32 in [0, 1]. Raises
    ValueError on anything else."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] != _PNG_MAGIC:
        raise ValueError(f"{path}: not a PNG file")
    off = 8
    header = None
    idat = []
    while off < len(buf):
        (size,) = struct.unpack_from(">I", buf, off)
        tag = buf[off + 4:off + 8]
        data = buf[off + 8:off + 8 + size]
        off += 12 + size
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif tag == b"IDAT":
            idat.append(data)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: missing IHDR")
    w, h, depth, color_type, _, _, interlace = header
    channels = {2: 3, 6: 4}.get(color_type)
    if depth != 8 or channels is None or interlace != 0:
        raise ValueError(f"{path}: only 8-bit non-interlaced RGB/RGBA "
                         f"is supported (depth {depth}, color type "
                         f"{color_type}, interlace {interlace})")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    stride = 1 + w * channels
    if raw.size != h * stride:
        raise ValueError(f"{path}: image data size mismatch")
    rows = raw.reshape(h, stride)
    if np.any(rows[:, 0] != 0):
        raise ValueError(f"{path}: only filter type 0 rows are supported")
    return rows[:, 1:].reshape(h, w, channels).astype(np.float32) / 255.0


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 1.0) -> float:
    """Mean SSIM (Wang et al. 2004) on the luma of (H, W, 3) images with an
    11x11 Gaussian window (sigma 1.5) — the same metric as
    ``drts_tpu.utils.image.ssim``."""
    def luma(x):
        x = np.asarray(x, np.float64)
        return x @ [0.2126, 0.7152, 0.0722] if x.ndim == 3 else x

    x, y = luma(a), luma(b)
    r = np.arange(11) - 5
    g = np.exp(-(r ** 2) / (2 * 1.5 ** 2))
    g /= g.sum()

    def filt(img):
        for axis in (0, 1):
            img = np.apply_along_axis(
                lambda v: np.convolve(np.pad(v, 5, mode="reflect"), g,
                                      "valid"), axis, img)
        return img

    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mx, my = filt(x), filt(y)
    sxx = filt(x * x) - mx * mx
    syy = filt(y * y) - my * my
    sxy = filt(x * y) - mx * my
    s = ((2 * mx * my + c1) * (2 * sxy + c2)) / (
        (mx * mx + my * my + c1) * (sxx + syy + c2))
    return float(s.mean())
