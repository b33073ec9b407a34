"""Vector / quaternion / frame math (port of ``drts_tpu/utils/math.py``).

Same conventions as the reference: vectors and colors are ``(..., 3)``
float32 tensors, quaternions ``(..., 4)`` in (x, y, z, w) order, every
function elementwise over the leading axes.
"""

from __future__ import annotations

import functools
import math

import torch

from .. import backend


@functools.lru_cache(maxsize=None)
def _const(values, dtype, device):
    return torch.tensor(values, dtype=dtype, device=device)


def const(values, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """The tensor of `values` (a number or nested tuples), made once per
    (values, dtype, device) and then shared: the frame's small constants
    come from the host only on their first use, so a CUDA graph capture
    after one eager frame copies nothing from the host. Never write into
    it."""
    return _const(values, dtype, torch.device(device))


def as_f32(x, device) -> torch.Tensor:
    """`x`, a tensor or a number, as a float32 tensor on `device`. A number
    is filled on the device, not copied from the host, so that a frame
    captured as a CUDA graph copies nothing from the host."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.full((), float(x), device=device)

# ----------------------------------------------------------------------------
# scalar helpers


def sqr(x):
    return x * x


def saturate(x):
    return torch.clamp(x, 0.0, 1.0)


def safe_div(a, b, eps: float = 1e-20):
    """a / b with |b| clamped away from zero, its sign kept."""
    return a / torch.where(torch.abs(b) < eps,
                           torch.where(b < 0, -eps, eps), b)


def sign_not_zero(x):
    """+1 for x >= 0, -1 for x < 0 (HLSL ``Math::Sign`` semantics)."""
    return torch.where(x >= 0, 1.0, -1.0)


# ----------------------------------------------------------------------------
# vectors (trailing axis = components)


def dot(a, b, keepdims: bool = False):
    return torch.sum(a * b, dim=-1, keepdim=keepdims)


def length(v, keepdims: bool = False):
    return torch.sqrt(torch.clamp(dot(v, v, keepdims=keepdims), min=0.0))


def normalize(v, eps: float = 1e-20):
    return v * torch.reciprocal(torch.clamp(length(v, keepdims=True),
                                            min=eps))


def cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def reflect(i, n):
    """HLSL reflect: i - 2*dot(i,n)*n (i points toward the surface)."""
    return i - 2.0 * dot(i, n, keepdims=True) * n


def refract(i, n, eta):
    """HLSL refract. Returns (refracted_dir, total_internal_reflection_mask);
    the direction is 0 where TIR occurs."""
    eta = eta[..., None]
    cosi = -dot(i, n, keepdims=True)
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    tir = k[..., 0] < 0.0
    dir_ = eta * i + (eta * cosi - torch.sqrt(torch.clamp(k, min=0.0))) * n
    return torch.where(tir[..., None], 0.0, dir_), tir


def vec3(x, y, z, device="cuda"):
    """(..., 3) float32 from three components, broadcast together. Tensors
    keep their device; scalars and arrays alone go to `device`."""
    dev = next((v.device for v in (x, y, z) if isinstance(v, torch.Tensor)),
               None)
    if dev is None:
        dev = backend.device(device)
    parts = [torch.as_tensor(v, dtype=torch.float32, device=dev)
             for v in (x, y, z)]
    return torch.stack(torch.broadcast_tensors(*parts), dim=-1)


def lerp(a, b, t):
    return a + (b - a) * t


# ----------------------------------------------------------------------------
# quaternions (x, y, z, w)

QUAT_IDENTITY = (0.0, 0.0, 0.0, 1.0)


def quat_mul(q1, q2):
    x1, y1, z1, w1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    x2, y2, z2, w2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], dim=-1)


def quat_integrate(q, omega, dt):
    """Integrate angular velocity (rad/s, world frame) over dt; renormalize."""
    omega_q = torch.cat([omega, torch.zeros_like(omega[..., :1])], dim=-1)
    dq = 0.5 * quat_mul(omega_q, q)
    return normalize(q + dq * dt)


def quat_conj(q):
    return q * const((-1.0, -1.0, -1.0, 1.0), q.dtype, q.device)


def quat_rotate(q, v):
    """Rotate vector v by quaternion q."""
    qv = q[..., :3]
    t = 2.0 * cross(qv, v)
    return v + q[..., 3:4] * t + cross(qv, t)


def quat_from_axis_angle(axis, angle, device="cuda"):
    device = backend.device(device)
    axis = normalize(torch.as_tensor(axis, dtype=torch.float32,
                                     device=device))
    half = 0.5 * torch.as_tensor(angle, dtype=torch.float32, device=device)
    s = torch.sin(half)[..., None]
    return torch.cat([axis * s, torch.cos(half)[..., None]], dim=-1)


def quat_to_matrix(q):
    """(..., 4) quaternion -> (..., 3, 3) rotation matrix (rows = basis)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    mat = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy + wz), 2 * (xz - wy),
        2 * (xy - wz), 1 - 2 * (xx + zz), 2 * (yz + wx),
        2 * (xz + wy), 2 * (yz - wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return mat.reshape(mat.shape[:-1] + (3, 3))


# ----------------------------------------------------------------------------
# frames / bases


def calculate_tbn(n, t):
    """Gram-Schmidt TBN rows (T', B, N) (Math::CalculateTBN,
    Math.hlsli:18-22)."""
    t = normalize(t - n * dot(n, t, keepdims=True))
    return t, cross(n, t), n


def orthonormal_basis(n):
    """Branchless tangent basis from a unit normal (Duff et al.): returns
    (t, b) with (t, b, n) right-handed."""
    s = sign_not_zero(n[..., 2])
    a = -1.0 / (s + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = torch.stack([1.0 + s * n[..., 0] * n[..., 0] * a, s * b,
                     -s * n[..., 0]], dim=-1)
    bt = torch.stack([b, s + n[..., 1] * n[..., 1] * a, -n[..., 1]], dim=-1)
    return t, bt


def to_local(t, b, n, v):
    """World -> tangent space (``Geometry::RotateVector`` with basis rows)."""
    return torch.stack([dot(v, t), dot(v, b), dot(v, n)], dim=-1)


def to_world(t, b, n, v):
    """Tangent -> world space (``Geometry::RotateVectorInverse``)."""
    return v[..., 0:1] * t + v[..., 1:2] * b + v[..., 2:3] * n


# ----------------------------------------------------------------------------
# screen-space mappings (Math.hlsli:5-16)


def calculate_uv(pixel_xy, dims_xy, jitter_xy=0.0):
    """(pixel + 0.5 + jitter) / dims — Math::CalculateUV."""
    return (pixel_xy + 0.5 + jitter_xy) / dims_xy


def calculate_ndc(uv):
    """UV -> NDC: x in [-1,1], y flipped — Math::CalculateNDC."""
    scale = const((2.0, -2.0), uv.dtype, uv.device)
    bias = const((-1.0, 1.0), uv.dtype, uv.device)
    return uv * scale + bias


def to_latlong(direction):
    """Unit direction -> lat-long UV (Math::ToLatLongCoordinate)."""
    u = (1.0 + torch.atan2(direction[..., 0], direction[..., 2])
         / math.pi) / 2
    v = torch.acos(torch.clamp(direction[..., 1], -1.0, 1.0)) / math.pi
    return torch.stack([u, v], dim=-1)


# ----------------------------------------------------------------------------
# sampling (Math.hlsli:36-51)


def sample_triangle(random2):
    """Uniform barycentrics from 2 uniforms (Math::SampleTriangle)."""
    value = torch.sqrt(random2[..., 0])
    return torch.stack([value * (1.0 - random2[..., 1]),
                        value * random2[..., 1]], dim=-1)


def to_solid_angle_pdf(area_pdf, dist, cos_theta, eps: float = 1e-8):
    """Area-measure pdf -> solid-angle pdf (Math::ToSolidAnglePDF)."""
    return area_pdf * dist * dist / torch.clamp(cos_theta, min=eps)


# ----------------------------------------------------------------------------
# color (MathLib Color::*)

_LUMA = (0.2126, 0.7152, 0.0722)


def luminance(rgb):
    return torch.sum(rgb * const(_LUMA, rgb.dtype, rgb.device), dim=-1)


def from_srgb(c):
    """sRGB -> linear."""
    return torch.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def to_srgb(c):
    """Linear -> sRGB."""
    c = torch.clamp(c, min=0.0)
    return torch.where(c <= 0.0031308, c * 12.92,
                       1.055 * torch.pow(c, 1.0 / 2.4) - 0.055)


# ----------------------------------------------------------------------------
# packing (Shaders/Packing.hlsli equivalents). Packed words are f32 bit
# patterns: they move as int32 views and selects, never through float
# arithmetic or a value cast, which could canonicalise NaN payloads.


def oct_encode(n):
    """Unit vector -> octahedral [-1,1]^2 (Packing::EncodeUnitVector)."""
    n = n / torch.sum(torch.abs(n), dim=-1, keepdim=True)
    xy = n[..., :2]
    flipped = (1.0 - torch.abs(xy.flip(-1))) * sign_not_zero(xy)
    return torch.where(n[..., 2:3] >= 0.0, xy, flipped)


def oct_decode(e):
    """Octahedral [-1,1]^2 -> unit vector."""
    x, y = e[..., 0], e[..., 1]
    z = 1.0 - torch.abs(x) - torch.abs(y)
    t = torch.clamp(-z, min=0.0)
    x = x - sign_not_zero(x) * t
    y = y - sign_not_zero(y) * t
    return normalize(torch.stack([x, y, z], dim=-1))


def _half_bits(x):
    """float32 -> its IEEE half bit pattern in [0, 65536), as int32."""
    return x.to(torch.float16).view(torch.int16).to(torch.int32) & 0xFFFF


def _half_from_bits(b):
    """[0, 65536) int32 half bit patterns -> float32 values."""
    b = torch.where(b >= 0x8000, b - 0x10000, b)
    return b.to(torch.int16).view(torch.float16).to(torch.float32)


def word_as_f32(u):
    """[0, 2^32) int64 words -> the float32 with those bits."""
    u = torch.where(u >= 1 << 31, u - (1 << 32), u)
    return u.to(torch.int32).view(torch.float32)


def pack2f16(a, b):
    """Two f32 -> one f32 carrying their f16 bit patterns (low half a, high
    half b), clamped to +-60000 first (~2^-10 relative precision)."""
    lim = 60000.0
    au = _half_bits(torch.clamp(a, -lim, lim)).to(torch.int64)
    bu = _half_bits(torch.clamp(b, -lim, lim)).to(torch.int64)
    return word_as_f32(au | (bu << 16))


def unpack2f16(x):
    """Inverse of pack2f16: one bit-packed f32 -> (a, b) f32."""
    u = x.view(torch.int32)
    return _half_from_bits(u & 0xFFFF), _half_from_bits((u >> 16) & 0xFFFF)


def pack_oct16(n):
    """Unit vector -> one f32 (octahedral xy as an f16 pair)."""
    e = oct_encode(n)
    return pack2f16(e[..., 0], e[..., 1])


def unpack_oct16(x):
    """Inverse of pack_oct16."""
    a, b = unpack2f16(x)
    return oct_decode(torch.stack([a, b], dim=-1))


def pack_depth_oct8(depth, n):
    """Depth (f16, clamped to +-3e4) and a unit normal (octahedral, 2 x 8-bit
    unorm) in one f32: [depth half | qx | qy]. A NaN normal packs as 0, as
    the reference's float -> uint32 conversion gives."""
    du = _half_bits(torch.clamp(depth, -3e4, 3e4)).to(torch.int64)
    q = torch.round((oct_encode(n) * 0.5 + 0.5) * 255.0)
    q = torch.clamp(torch.nan_to_num(q, nan=0.0), min=0.0).to(torch.int64)
    return word_as_f32((du << 16) | (q[..., 0] << 8) | q[..., 1])


def unpack_depth_oct8(x):
    """Inverse of pack_depth_oct8 -> (depth, normal)."""
    u = x.view(torch.int32)
    q0 = ((u >> 8) & 255).to(torch.float32)
    q1 = (u & 255).to(torch.float32)
    e = torch.stack([q0, q1], dim=-1) / 255.0 * 2.0 - 1.0
    return _half_from_bits((u >> 16) & 0xFFFF), oct_decode(e)
