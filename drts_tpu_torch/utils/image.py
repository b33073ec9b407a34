"""Host image helpers of the port: a minimal PNG writer and reader, the
texture loader (PIL, where it is installed), a minimal OpenEXR reader and
writer, the Reinhard preview map and SSIM (port of
``drts_tpu/utils/image.py``).

All but the texture loader are numpy-only, so the port needs neither PIL
nor the JAX package to write a rendered frame, check it against
``tests/golden/demo_64.png`` or read a lat-long environment map.
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


def load_image(path: str, size: int | None = None) -> np.ndarray | None:
    """Load an image as (H, W, 4) float32 in [0, 1]; optionally resized to
    (size, size). Returns None when PIL is unavailable (textures then fall
    back to material constants, like the reference with missing assets)."""
    try:
        from PIL import Image
    except ImportError:
        return None
    img = Image.open(path).convert("RGBA")
    if size is not None:
        img = img.resize((size, size), Image.BILINEAR)
    return np.asarray(img, np.float32) / 255.0


def _exr_zip_decode(data: bytes) -> bytes:
    """OpenEXR ZIP post-decompression reconstruction: delta-decode then
    de-interleave the two buffer halves (the inverse of the writer's
    interleave + delta predictor)."""
    # t[i] = t[i-1] + raw[i] - 128 (mod 256) for i >= 1, t[0] = raw[0].
    raw = np.frombuffer(zlib.decompress(data), np.uint8).astype(np.int64)
    t = np.cumsum(np.concatenate([raw[:1], raw[1:] - 128])) & 0xFF
    t = t.astype(np.uint8)
    n = t.size
    out = np.empty(n, np.uint8)
    half = (n + 1) // 2
    out[0::2] = t[:half]
    out[1::2] = t[half:]
    return out.tobytes()


def read_exr(path: str) -> np.ndarray:
    """Minimal OpenEXR scanline reader: single-part, compression
    NONE/ZIPS/ZIP, HALF or FLOAT channels. Returns (H, W, 3) float32 RGB.

    The stand-in for DirectXTex's EXR path (TextureHelpers.ixx:34-138),
    used by the demo scene's environment map (MyScene.ixx:95)."""
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<iI", buf, 0)
    if magic != 20000630:
        raise ValueError(f"{path}: not an EXR file")
    if version & 0x200:
        raise ValueError("multi-part EXR unsupported")
    off = 8

    def read_cstr(o):
        e = buf.index(b"\0", o)
        return buf[o:e].decode("latin1"), e + 1

    channels = []
    data_window = None
    compression = 0
    while True:
        name, off = read_cstr(off)
        if not name:
            break
        _type, off = read_cstr(off)
        size = struct.unpack_from("<i", buf, off)[0]
        off += 4
        payload = buf[off:off + size]
        off += size
        if name == "channels":
            o = 0
            while payload[o] != 0:
                cname_end = payload.index(b"\0", o)
                cname = payload[o:cname_end].decode("latin1")
                o = cname_end + 1
                ptype = struct.unpack_from("<i", payload, o)[0]
                o += 16  # type + pLinear/reserved + x/y sampling
                channels.append((cname, ptype))
        elif name == "dataWindow":
            data_window = struct.unpack_from("<4i", payload, 0)
        elif name == "compression":
            compression = payload[0]

    if data_window is None or not channels:
        raise ValueError("missing EXR header fields")
    if compression not in (0, 2, 3):
        raise ValueError(f"unsupported EXR compression {compression}")
    x0, y0, x1, y1 = data_window
    w, h = x1 - x0 + 1, y1 - y0 + 1
    rows_per_block = 1 if compression in (0, 2) else 16
    n_blocks = -(-h // rows_per_block)
    # channels are stored sorted by name
    channels.sort(key=lambda c: c[0])
    dtypes = {1: np.float16, 2: np.float32}
    for _, pt in channels:
        if pt not in dtypes:
            raise ValueError(f"unsupported pixel type {pt}")

    off += n_blocks * 8  # skip line-offset table (blocks are sequential)
    planes = {c: np.empty((h, w), np.float32) for c, _ in channels}
    for _ in range(n_blocks):
        y, size = struct.unpack_from("<ii", buf, off)
        off += 8
        data = buf[off:off + size]
        off += size
        rows = min(rows_per_block, y1 - y + 1)
        row_bytes = sum(w * np.dtype(dtypes[pt]).itemsize
                        for _, pt in channels)
        if compression != 0:
            data = _exr_zip_decode(data)
        if len(data) != rows * row_bytes:
            raise ValueError("EXR block size mismatch")
        o = 0
        for r in range(rows):
            for cname, pt in channels:
                nb = w * np.dtype(dtypes[pt]).itemsize
                row = np.frombuffer(data, dtypes[pt], count=w, offset=o)
                planes[cname][y - y0 + r] = row.astype(np.float32)
                o += nb

    names = [c for c, _ in channels]
    def plane(n):
        if n in planes:
            return planes[n]
        return planes[names[0]]
    return np.stack([plane("R"), plane("G"), plane("B")],
                    axis=-1).astype(np.float32)


def write_exr(path: str, image: np.ndarray) -> None:
    """Minimal uncompressed scanline EXR writer (FLOAT RGB): environment
    maps made in code (tests, chip_smoke.py) round-trip through
    read_exr."""
    img = np.asarray(image, np.float32)
    h, w = img.shape[:2]
    out = bytearray()
    out += struct.pack("<iI", 20000630, 2)

    def attr(name, typ, payload):
        out.extend(name.encode() + b"\0" + typ.encode() + b"\0")
        out.extend(struct.pack("<i", len(payload)))
        out.extend(payload)

    ch = bytearray()
    for c in ("B", "G", "R"):
        ch += c.encode() + b"\0" + struct.pack("<i", 2) + b"\0\0\0\0" \
            + struct.pack("<ii", 1, 1)
    ch += b"\0"
    attr("channels", "chlist", bytes(ch))
    attr("compression", "compression", b"\0")
    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    attr("dataWindow", "box2i", box)
    attr("displayWindow", "box2i", box)
    attr("lineOrder", "lineOrder", b"\0")
    attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
    attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    out += b"\0"

    table_pos = len(out)
    out += b"\0" * (8 * h)
    offsets = []
    for y in range(h):
        offsets.append(len(out))
        row = b"".join(img[y, :, c].astype("<f4").tobytes()
                       for c in (2, 1, 0))  # B, G, R sorted order
        out += struct.pack("<ii", y, len(row)) + row
    for i, o in enumerate(offsets):
        struct.pack_into("<Q", out, table_pos + 8 * i, o)
    with open(path, "wb") as f:
        f.write(bytes(out))


def tonemap_preview(radiance: np.ndarray, exposure: float = 1.0) -> np.ndarray:
    """Quick Reinhard + sRGB preview mapping for debug PNGs."""
    x = np.maximum(np.asarray(radiance, np.float32) * exposure, 0.0)
    x = x / (1.0 + x)
    return np.where(x <= 0.0031308, x * 12.92,
                    1.055 * np.power(np.maximum(x, 1e-8), 1 / 2.4) - 0.055)


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
