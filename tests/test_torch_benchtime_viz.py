"""``utils/benchtime.py`` and ``utils/viz.py`` against the JAX package's.

Timing runs on an injected fake clock (no sleeps, so no scheduler noise):
each call of the timed function advances it by a fixed cost, the fence
by another, and windows can be slowed on purpose. The port's
``timed_per_item`` returns exactly what the JAX helper returns on the
same clock, recovers the per-item cost when the fence dominates, and
``measure_rtt`` returns the cheapest fenced launch. ``flow_to_color`` and
the colour wheel are bit-identical to JAX's; the OpenCV drawings are
identical images.
"""

import numpy as np
import pytest
import torch

from sfd2_torch.ops import cuda_build
from sfd2_torch.utils import benchtime as t_bt
from sfd2_torch.utils import viz as t_viz
from sfd2_tpu.utils import benchtime as j_bt
from sfd2_tpu.utils import viz as j_viz


class FakeClock:
    """A clock that moves only when the work says so; `slow` maps a
    window's index (in fence order) to extra seconds spent in it."""

    def __init__(self, per_call=2e-3, fence=30e-3, slow=None):
        self.t, self.per_call, self.fence_cost = 0.0, per_call, fence
        self.slow = dict(slow or {})
        self.windows = 0

    def __call__(self):
        return self.t

    def fn(self):
        self.t += self.per_call
        return self.t

    def fence(self, _out):
        self.t += self.fence_cost + self.slow.get(self.windows, 0.0)
        self.windows += 1


@pytest.mark.parametrize("slow", [None, {0: 0.5}, {1: 0.5, 2: 0.2}, {0: 1.0, 2: 1.0, 4: 1.0}])
@pytest.mark.parametrize("items,rtt", [(1, 0.0), (4, 30e-3)])
def test_timed_per_item_equals_jax_on_a_fake_clock(monkeypatch, slow, items, rtt):
    port = FakeClock(slow=slow)
    got = t_bt.timed_per_item(port.fn, port.fence, items_per_call=items, iters=3, inner=8,
                              rtt=rtt, clock=port)
    ref_clock = FakeClock(slow=slow)
    monkeypatch.setattr(j_bt.time, "perf_counter", ref_clock)
    ref = j_bt.timed_per_item(ref_clock.fn, ref_clock.fence, items_per_call=items, iters=3,
                              inner=8, rtt=rtt)
    assert got == ref
    assert port.windows == 6
    assert got >= 2e-3 / items * (1 - 1e-9)  # conservative: never below the true cost
    if rtt == 30e-3 and (slow is None or len(slow) < 3):
        # A calm pair survives and `rtt` is the fence's cost: both
        # estimators cancel the fence, the per-item cost remains.
        assert got == pytest.approx(2e-3 / items, rel=1e-9)


def test_measure_rtt_takes_the_cheapest_fenced_launch():
    clock = FakeClock(per_call=0.0, fence=4e-3, slow={1: 0.1, 3: 0.05})
    fences = []

    def fence(out):
        fences.append(out.shape)
        clock.fence(out)

    assert t_bt.measure_rtt(samples=5, device="cpu", clock=clock, fence=fence) == \
        pytest.approx(4e-3)
    assert fences == [(8, 128)] * 6  # one warm-up and five samples


def test_enable_compile_cache_moves_the_kernel_builds(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", cuda_build.BUILD_DIR)
    got = t_bt.enable_compile_cache(tmp_path)
    assert got == cuda_build.BUILD_DIR == tmp_path.resolve() / "sfd2_torch" / "_build"
    assert cuda_build._paths("match")[1].parent == got  # where the next build goes


def test_cuda_fence_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises((RuntimeError, AssertionError, AttributeError)):
        t_bt.cuda_fence()


def test_flow_colours_match_jax():
    np.testing.assert_array_equal(t_viz._make_colorwheel(), j_viz._make_colorwheel())
    rng = np.random.default_rng(0)
    flow = rng.normal(size=(24, 32, 2)).astype(np.float32) * 5
    flow[0, :4] = np.nan
    for max_flow in (None, 3.0):
        got = t_viz.flow_to_color(flow, max_flow)
        assert got.dtype == np.uint8 and (got[0, :4] == 0).all()
        np.testing.assert_array_equal(got, j_viz.flow_to_color(flow, max_flow))


def test_cv2_drawings_match_jax():
    pytest.importorskip("cv2")
    rng = np.random.default_rng(1)
    img1 = rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)
    img2 = rng.integers(0, 256, (30, 60), dtype=np.uint8)
    p1 = rng.random((12, 2)) * [50, 40]
    p2 = rng.random((12, 2)) * [60, 30]
    inl = rng.random(12) > 0.3
    for kw in ({}, {"inliers": inl}, {"inliers": inl, "plot_outliers": True}):
        got = t_viz.draw_matches_cv2(img1, np.repeat(img2[..., None], 3, -1), p1, p2, **kw)
        ref = j_viz.draw_matches_cv2(img1, np.repeat(img2[..., None], 3, -1), p1, p2, **kw)
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(t_viz.draw_reprojections(img2, p2, p2 + 2),
                                  j_viz.draw_reprojections(img2, p2, p2 + 2))
