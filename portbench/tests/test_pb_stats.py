"""The end-to-end metrics' arithmetic on synthetic timings."""
import pytest

from portbench.harness import stats


def test_rays_per_s_counts_every_pass_over_the_whole_window():
    # 12 passes of 1920x1080 at 3 bounces in 2.5 s
    assert stats.rays_per_s(1920, 1080, 3, 12, 2.5) == pytest.approx(
        1920 * 1080 * 3 * 12 / 2.5)


def test_percentile_interpolates_between_order_statistics():
    frames = [0.1 * k for k in range(1, 201)]           # 0.1 .. 20.0
    assert stats.percentile(frames, 95) == pytest.approx(19.005)
    assert stats.percentile([5.0], 95) == 5.0
    assert stats.percentile([3.0, 1.0, 2.0], 50) == 2.0
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_percentile_sees_the_tail():
    frames = [100.0] * 190 + [300.0] * 10
    # position 0.95 x 199 = 189.05 lies between the last 100 and the
    # first 300
    assert stats.percentile(frames, 95) == pytest.approx(110.0)
    assert stats.percentile(frames, 90) == 100.0
