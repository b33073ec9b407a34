"""Faults planted in the timed path, under the check that has to see each
one: ``plant(name, setattr)`` swaps a piece of the program for a broken
one (``setattr(owner, attribute, value)``: pytest's
``monkeypatch.setattr`` in the tests, the builtin in ``control.py`` on
the card). Each has to read ``correct`` false.

- ``state_unchanged``: a frame returns the state it was given;
- ``half_batch``: the path trace's lower half of the rows replaced by
  the mean of the upper half;
- ``answer_altered``: a 4x4 patch of the output image brightened by 0.05;
- ``restir_dropped`` / ``restir_doubled``: ReSTIR DI's final shading (the
  direct light of the emissive spheres) left out or counted twice;
- ``occlusion_off``: the any-hit kernel (B2) reports no blocker, so every
  shadow ray reaches its light.
"""

from __future__ import annotations

import torch


def _pipeline():
    from drts_tpu_torch.models import pipeline
    return pipeline.RenderPipeline


def state_unchanged(setattr):
    cls = _pipeline()
    inner = cls.render_frame

    def frame(self, state, *a, **kw):
        _, image = inner(self, state, *a, **kw)
        return state, image
    setattr(cls, "render_frame", frame)


def half_batch(setattr):
    cls = _pipeline()
    inner = cls._stage_trace

    def trace(self, *a, **kw):
        out = inner(self, *a, **kw)
        rad = out.radiance.clone()
        h = rad.shape[0] // 2
        rad[h:] = rad[:h].mean(dim=(0, 1))
        return type(out)(**dict(out.__dict__, radiance=rad))
    setattr(cls, "_stage_trace", trace)


def answer_altered(setattr):
    cls = _pipeline()
    inner = cls._stage_postfx

    def postfx(self, *a, **kw):
        img = inner(self, *a, **kw).clone()
        img[4:8, 4:8] += 0.05
        return img
    setattr(cls, "_stage_postfx", postfx)


def _restir_scaled(setattr, scale):
    cls = _pipeline()
    inner = cls._restir_final

    def final(self, *a, **kw):
        diffuse, specular = inner(self, *a, **kw)
        return diffuse * scale, specular * scale
    setattr(cls, "_restir_final", final)


def restir_dropped(setattr):
    _restir_scaled(setattr, 0.0)


def restir_doubled(setattr):
    _restir_scaled(setattr, 2.0)


def occlusion_off(setattr):
    from drts_tpu_torch.ops import intersect_kernels

    def occlusion(rays9, *a, **kw):
        return torch.zeros(rays9.shape[1], dtype=torch.bool,
                           device=rays9.device)
    setattr(intersect_kernels, "occlusion_morton", occlusion)


FAULTS = {f.__name__: f for f in (state_unchanged, half_batch,
                                  answer_altered, restir_dropped,
                                  restir_doubled, occlusion_off)}


def plant(name: str, setattr=setattr) -> None:
    FAULTS[name](setattr)
