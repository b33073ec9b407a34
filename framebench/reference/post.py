"""The demo's display pass, plain PyTorch in any precision: sharpen,
bloom, ACES filmic tone map and sRGB encode (App.cpp:1498-1514; Bloom
.ixx; DirectXTK's Operator_ACESFilmic). Written from those formulas with
clamp addressing at the edges; nothing here imports the program."""

from __future__ import annotations

import torch

LUMA = (0.2126, 0.7152, 0.0722)


def _shift(img, dy: int, dx: int):
    h, w = img.shape[0], img.shape[1]
    rows = torch.clamp(torch.arange(h, device=img.device) + dy, 0, h - 1)
    cols = torch.clamp(torch.arange(w, device=img.device) + dx, 0, w - 1)
    return img[rows][:, cols]


def _luminance(c):
    return (c * torch.tensor(LUMA, dtype=c.dtype, device=c.device)).sum(-1)


def sharpen(img, sharpness: float):
    blur = 0.25 * (_shift(img, -1, 0) + _shift(img, 1, 0)
                   + _shift(img, 0, -1) + _shift(img, 0, 1))
    return torch.clamp(img + (img - blur) * (0.8 * sharpness), min=0.0)


def resize_bilinear(img, out_h: int, out_w: int):
    """Align-corners-false bilinear resize with clamped taps."""
    h, w, dev = img.shape[0], img.shape[1], img.device
    y = (torch.arange(out_h, dtype=torch.float32, device=dev) + 0.5) \
        * (h / out_h) - 0.5
    x = (torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5) \
        * (w / out_w) - 0.5
    y0, x0 = torch.floor(y), torch.floor(x)
    fy = (y - y0)[:, None, None].to(img.dtype)
    fx = (x - x0)[None, :, None].to(img.dtype)
    y0i = torch.clamp(y0.long(), 0, h - 1)
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    x0i = torch.clamp(x0.long(), 0, w - 1)
    x1i = torch.clamp(x0i + 1, 0, w - 1)
    top = img[y0i][:, x0i] * (1 - fx) + img[y0i][:, x1i] * fx
    bot = img[y1i][:, x0i] * (1 - fx) + img[y1i][:, x1i] * fx
    return top * (1 - fy) + bot * fy


def _downsample(img):
    """13 taps as five 4-tap boxes, each weighted by the Karis average
    (1 / (1 + luminance)), then every second pixel."""
    def box(dy, dx):
        return 0.25 * (_shift(img, dy, dx) + _shift(img, dy, dx + 1)
                       + _shift(img, dy + 1, dx) + _shift(img, dy + 1, dx + 1))
    groups = [(box(0, 0), 0.5), (box(-1, -1), 0.125), (box(-1, 1), 0.125),
              (box(1, -1), 0.125), (box(1, 1), 0.125)]
    total, acc = 0.0, 0.0
    for g, share in groups:
        w = (1.0 / (1.0 + _luminance(g)))[..., None] * share
        total = total + w
        acc = acc + g * w
    return (acc / total)[::2, ::2]


def _tent(up):
    acc = 4.0 * up
    for dy, dx, w in ((-1, 0, 2.0), (1, 0, 2.0), (0, -1, 2.0), (0, 1, 2.0),
                      (-1, -1, 1.0), (-1, 1, 1.0), (1, -1, 1.0), (1, 1, 1.0)):
        acc = acc + w * _shift(up, dy, dx)
    return acc / 16.0


def bloom(img, strength: float, levels: int = 4):
    mips = [img]
    for _ in range(levels):
        mips.append(_downsample(mips[-1]))
    up = mips[-1]
    for level in range(levels - 1, -1, -1):
        target = mips[level]
        up = target + _tent(resize_bilinear(up, target.shape[0],
                                            target.shape[1]))
    return img * (1.0 - strength) + (up / (levels + 1)) * strength


def aces(x, exposure: float):
    x = torch.clamp(x * exposure, min=0.0)
    return torch.clamp((x * (2.51 * x + 0.03)) / (x * (2.43 * x + 0.59)
                                                  + 0.14), 0.0, 1.0)


def to_srgb(c):
    c = torch.clamp(c, min=0.0)
    return torch.where(c <= 0.0031308, c * 12.92,
                       1.055 * torch.pow(c, 1.0 / 2.4) - 0.055)


def display(hdr, post: dict):
    """The output image of an (H, W, 3) HDR colour under the display
    settings `post` (sharpness, bloom_strength, exposure)."""
    x = sharpen(hdr, post["sharpness"])
    x = bloom(x, post["bloom_strength"])
    return to_srgb(aces(x, post["exposure"]))
