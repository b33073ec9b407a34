"""The benchmark's arithmetic of times on synthetic readings."""

import pytest

from framebench.harness import timing


def test_p95_and_rate_from_intervals():
    steady = [100.0] * 200
    assert timing.percentile(steady, 95) == 100.0
    assert timing.frame_ms(20.0, 200) == pytest.approx(100.0)
    # A stall of 15 frames' worth inside the window moves both: the tail
    # sees the stalled intervals, the rate the lost time.
    stalled = [100.0] * 185 + [250.0] * 15
    assert timing.percentile(stalled, 95) == 250.0
    assert timing.frame_ms(sum(stalled) / 1e3, 200) > 100.0
    # Nearest rank: the 95th of 1..100 is 95, of 1..20 is 19.
    assert timing.percentile(range(1, 101), 95) == 95
    assert timing.percentile(range(1, 21), 95) == 19


def test_intervals_from_stamps():
    assert timing.intervals_ms([0.0, 10.0, 25.0, 45.0]) == [10.0, 15.0, 20.0]


def test_frame_ms_needs_frames():
    with pytest.raises(ValueError):
        timing.frame_ms(1.0, 0)


@pytest.mark.parametrize("spans, lo, hi, busy, gaps", [
    ([(0, 10), (5, 15), (20, 30)], 0, 40, 25, [(15, 20), (30, 40)]),
    ([(2, 4), (3, 5), (1, 2)], 0, 6, 4, [(0, 1), (5, 6)]),
    ([(-5, 5), (8, 50)], 0, 10, 7, [(5, 8)]),
    ([], 0, 10, 0, [(0, 10)]),
])
def test_busy_and_idle_from_overlapping_intervals(spans, lo, hi, busy, gaps):
    assert timing.busy(spans, lo, hi) == busy
    assert timing.gaps(spans, lo, hi) == gaps
    idle_share = 1 - timing.busy(spans, lo, hi) / (hi - lo)
    assert idle_share == pytest.approx(sum(e - s for s, e in gaps)
                                       / (hi - lo))
