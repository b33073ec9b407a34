"""The port's fly camera (``ops/camera.CameraController``,
``apply_input_key``, ``KEY_HELP``) against the reference's. Both keep
their state in numpy float64 and run the same arithmetic, so positions
and axes must be equal bit for bit after any key script; ``pose()`` must
equal the reference's float32 pose exactly."""

import numpy as np
import pytest
import torch

from drts_tpu.ops import camera as jcamera
from drts_tpu_torch.ops import camera as tcamera

SCRIPTS = {
    "walk": ("wwwdd sa qe", 0.5, np.deg2rad(5.0)),
    "look": ("jjjliikkuo lw", 1.0, np.deg2rad(10.0)),
    "mixed": ("wjwjwiwdWLxzp r.oueq" * 3, 0.16, 0.3),
}


def _assert_same(tc, jc):
    for name in ("position", "forward", "right", "up"):
        np.testing.assert_array_equal(getattr(tc, name), getattr(jc, name),
                                      err_msg=name)
    tp, jp = tc.pose("cpu"), jc.pose()
    for name in ("position", "forward", "up"):
        t, j = getattr(tp, name), np.asarray(getattr(jp, name))
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), j, err_msg=name)


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_key_script_matches(script):
    keys, move, turn = SCRIPTS[script]
    start = dict(position=(1.0, 2.0, -15.0), forward=(0.1, -0.2, 1.0))
    tc = tcamera.CameraController(**start)
    jc = jcamera.CameraController(**start)
    for k in keys:
        assert (tcamera.apply_input_key(tc, k, move, turn)
                == jcamera.apply_input_key(jc, k, move, turn))
        _assert_same(tc, jc)
    assert tcamera.KEY_HELP == jcamera.KEY_HELP


def test_translate_rotate_look_at_match():
    tc = tcamera.CameraController(position=(0, 0, 0), forward=(0, 0, 1))
    jc = jcamera.CameraController(position=(0, 0, 0), forward=(0, 0, 1))
    for c in (tc, jc):
        c.translate((0.0, 0.0, 2.0))
        c.rotate(yaw=np.pi / 2)
        c.translate((0.0, 0.0, 1.0))
        c.rotate(yaw=0.3, pitch=0.2, roll=0.1)
    _assert_same(tc, jc)
    # Left-handed frame: +90 degrees of yaw turns +z to +x.
    np.testing.assert_allclose(tc.position, [1, 0, 2], atol=1e-6)
    assert abs(np.dot(tc.forward, tc.right)) < 1e-12
    for c in (tc, jc):
        c.look_at((0.0, 1.0, 0.0))
    _assert_same(tc, jc)
    for c in (tc, jc):   # straight up: the degenerate right axis
        c.look_at(c.position + np.array([0.0, 5.0, 0.0]))
    _assert_same(tc, jc)


def test_key_actions():
    c = tcamera.CameraController(position=(0.0, 0.0, -15.0))
    assert tcamera.apply_input_key(c, "w", move_step=2.0) == "move"
    np.testing.assert_array_equal(c.position, [0, 0, -13])
    assert tcamera.apply_input_key(c, "l") == "turn"
    assert c.forward[0] > 0.0
    assert [tcamera.apply_input_key(c, k) for k in "rpxz "] == [
        "reset", "screenshot", "quit", "", ""]
