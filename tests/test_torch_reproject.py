"""The port's reprojection kernel (B4) plain version against the
reference's exact-gather formulas (``reproject_pallas._gather_fallback``
run over every pixel), and the f16 / depth-oct8 packing it carries.

Tolerance: nearest mode is bit for bit, on f16-packed reservoir rows
built by the reference's own packers (the words are copied as int32).
Bilinear mode agrees to 2e-6 relative + 1e-6 absolute (the reference's
XLA:CPU contracts the tent's multiply-adds into FMAs, the port rounds each
one); measured on this data: largest difference 0 (bit-equal) on values
in [-4, 4]. ``ok`` is the in-frame test in both, including for motion that
leaves the frame on every side.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drts_tpu.ops import reproject_pallas as rp
from drts_tpu.utils import math as jm
from drts_tpu_torch import backend
from drts_tpu_torch.ops import reproject_kernels as rk
from drts_tpu_torch.utils import math as tm

H, W = 40, 56


@pytest.fixture(scope="module")
def case():
    """Smooth motion with a discontinuous patch, a margin that leaves the
    frame on every edge, and a half-pixel tie column for rounding."""
    rng = np.random.RandomState(3)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    motion = np.stack([3.0 * np.sin(yy / 7.0) + 0.3 * rng.randn(H, W),
                       2.0 * np.cos(xx / 9.0) + 0.3 * rng.randn(H, W)], -1)
    motion[10:20, 10:30] += np.array([-9.5, 6.0])      # a moving object
    motion[:, :3, 0] -= 6.0                            # leaves on the left
    motion[:, -3:, 0] += 6.0                           # and on the right
    motion[:3, :, 1] -= 6.0
    motion[-3:, :, 1] += 6.0
    motion[:, 30, 0] = 0.5                             # round-half-even
    motion = motion.astype(np.float32)

    # Packed reservoir rows (the temporal pass's layout), from the
    # reference's packers.
    idx = rng.randint(0, 128, (H, W)).astype(np.float32)
    m_count = rng.randint(1, 200, (H, W)).astype(np.float32)
    uv = rng.rand(H, W, 2).astype(np.float32)
    w_out = (rng.rand(H, W) * 5).astype(np.float32)
    depth = (1 + 20 * rng.rand(H, W)).astype(np.float32)
    n = rng.randn(H, W, 3)
    n = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)
    packed = np.stack([
        np.asarray(jm.pack2f16(jnp.asarray(idx), jnp.asarray(m_count))),
        np.asarray(jm.pack2f16(jnp.asarray(uv[..., 0]),
                               jnp.asarray(uv[..., 1]))),
        w_out,
        np.asarray(jm.pack_depth_oct8(jnp.asarray(depth), jnp.asarray(n))),
    ], axis=-1)
    values = (rng.rand(H, W, 5) * 8 - 4).astype(np.float32)
    return motion, packed, values, (idx, m_count, uv, depth, n)


def reference(src, motion, mode):
    """_gather_fallback with every pixel in its failing set = the exact
    gather over the whole frame."""
    py = jnp.arange(H, dtype=jnp.float32)[:, None] + motion[..., 1]
    px = jnp.arange(W, dtype=jnp.float32)[None, :] + motion[..., 0]
    in_bounds = (px >= 0) & (px <= W - 1) & (py >= 0) & (py <= H - 1)
    src = jnp.asarray(src)
    out, _ = rp._gather_fallback(src, jnp.zeros_like(src),
                                 jnp.zeros((H, W), bool),
                                 jnp.ones((H, W), bool), py, px, mode, 1)
    return np.asarray(out), np.asarray(in_bounds)


def test_nearest_bit_for_bit_on_packed_rows(case):
    motion, packed, _, _ = case
    want, want_ok = reference(packed, jnp.asarray(motion), "nearest")
    got, ok = rk.reproject_packed(torch.from_numpy(packed),
                                  torch.from_numpy(motion), "nearest")
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    np.testing.assert_array_equal(ok.numpy(), want_ok)
    assert 0.5 < want_ok.mean() < 0.95


def test_bilinear_matches(case):
    motion, _, values, _ = case
    want, want_ok = reference(values, jnp.asarray(motion), "bilinear")
    got, ok = rk.reproject_packed(torch.from_numpy(values),
                                  torch.from_numpy(motion), "bilinear")
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=1e-6)
    np.testing.assert_array_equal(ok.numpy(), want_ok)


@pytest.mark.parametrize("channels", [1, 9])
def test_channel_counts(case, channels):
    motion, _, values, _ = case
    src = np.repeat(values, 2, axis=-1)[..., :channels].copy()
    for mode in ("nearest", "bilinear"):
        want, _ = reference(src, jnp.asarray(motion), mode)
        got, _ = rk.reproject_packed(torch.from_numpy(src),
                                     torch.from_numpy(motion), mode)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=1e-6)


def test_packers_bit_for_bit(case):
    """pack2f16 / pack_depth_oct8 equal the reference's words, and the
    unpackers invert them identically."""
    _, packed, _, (idx, m_count, uv, depth, n) = case
    t = torch.from_numpy
    words = torch.stack([tm.pack2f16(t(idx), t(m_count)),
                         tm.pack2f16(t(uv[..., 0]), t(uv[..., 1])),
                         t(packed[..., 2]),
                         tm.pack_depth_oct8(t(depth), t(n))], dim=-1)
    np.testing.assert_array_equal(words.numpy().view(np.int32),
                                  packed.view(np.int32))
    a, b = tm.unpack2f16(t(packed[..., 0]))
    ja, jb = jm.unpack2f16(jnp.asarray(packed[..., 0]))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    d, nn = tm.unpack_depth_oct8(t(packed[..., 3]))
    jd, jn = jm.unpack_depth_oct8(jnp.asarray(packed[..., 3]))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_allclose(nn.numpy(), np.asarray(jn), atol=1e-6)
    # Values outside the f16 range clamp; a zero normal packs NaN as 0.
    big = torch.tensor([1e6, -1e6, 65504.0])
    np.testing.assert_array_equal(
        tm.pack2f16(big, big).numpy().view(np.int32),
        np.asarray(jm.pack2f16(jnp.asarray(big.numpy()),
                               jnp.asarray(big.numpy()))).view(np.int32))
    zero = torch.zeros(1, 3)
    np.testing.assert_array_equal(
        tm.pack_depth_oct8(torch.ones(1), zero).numpy().view(np.int32),
        np.asarray(jm.pack_depth_oct8(jnp.ones(1),
                                      jnp.zeros((1, 3)))).view(np.int32))


def test_wrapper_checks_and_cpu_dispatch(case):
    motion, packed, _, _ = case
    src, mot = torch.from_numpy(packed), torch.from_numpy(motion)
    before = dict(backend.LAUNCHES)
    rk.reproject_packed(src, mot, "nearest")
    assert backend.LAUNCHES == before
    with pytest.raises(ValueError, match="mode"):
        rk.reproject_packed(src, mot, "catmull")
    with pytest.raises(ValueError, match="motion"):
        rk.reproject_packed(src, mot[:, :-1], "nearest")
    with pytest.raises(ValueError, match="unsupported device"):
        rk.reproject_packed(src.to("meta"), mot.to("meta"), "nearest")


@pytest.mark.parametrize("c,vec", [(1, 1), (2, 2), (3, 1), (4, 4), (8, 4),
                                   (9, 1), (129, 1), (258, 2), (1025, 1),
                                   (4100, 4)])
def test_vector_width(c, vec):
    """The words per thread that the wrapper hands the kernel: 4 where C
    divides by 4, 2 where by 2, else 1, on 16-byte-aligned tensors; a view
    4 bytes into its storage takes 1, and 8 bytes in takes 2 at most."""
    src = torch.zeros(H, W, c)
    out = torch.empty_like(src)
    assert src.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    assert rk.vector_width(c, src, out) == vec
    store = torch.zeros(H * W * c + 2)
    assert rk.vector_width(c, store[1:1 + H * W * c].view(H, W, c),
                           out) == 1
    assert rk.vector_width(c, store[2:].view(H, W, c), out) == min(
        vec, 2)
