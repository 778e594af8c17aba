"""The port's training data pipeline against the JAX package's.

The port warps and upscales without OpenCV (``warp_perspective``,
``resize_linear``) and draws nothing from the ``Generator`` for it, so the
same seed gives the same homography, colour jitter, noise, crop windows,
flow and mask, exactly. The warped pixels agree with
``cv2.warpPerspective`` within 1e-4 (measured: at most 2e-5 over 20
seeds, on smooth textures and on raw noise alike; cv2 rounds the sample
position to a fixed-point grid), the upscale with ``cv2.resize`` within
1e-5.
"""

import cv2
import numpy as np
import pytest

from sfd2_torch.training import data as t_data
from sfd2_torch.training import transforms as t_tf
from sfd2_tpu.training import data as j_data

WARP_TOL = 1e-4


def texture(rng, h, w):
    img = rng.random((h, w, 3)).astype(np.float32)
    for _ in range(2):
        img = (img + np.roll(img, 1, 0) + np.roll(img, 1, 1)) / 3
    return img.astype(np.float32)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("raw", [False, True])
def test_warp_perspective_matches_cv2(seed, raw):
    rng = np.random.default_rng(seed)
    img = rng.random((80, 100, 3)).astype(np.float32) if raw else texture(rng, 80, 100)
    hmat = t_tf.sample_homography(rng, 100, 80)
    got = t_data.warp_perspective(img, hmat, (100, 80))
    ref = cv2.warpPerspective(img, hmat, (100, 80))
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=WARP_TOL)


def test_resize_linear_matches_cv2():
    img = texture(np.random.default_rng(0), 40, 50)
    np.testing.assert_allclose(t_data.resize_linear(img, (71, 57)), cv2.resize(img, (71, 57)),
                               rtol=0, atol=1e-5)


def _same_sample(got, ref, resized=False):
    np.testing.assert_array_equal(got.mask, ref.mask)
    for f in ("img1", "gray1", "raw1"):  # the same window of the same image
        if resized:  # upscaled first: within the resize tolerance
            np.testing.assert_allclose(getattr(got, f), getattr(ref, f), rtol=0,
                                       atol=1e-5 / 0.225, err_msg=f)
        else:
            np.testing.assert_array_equal(getattr(got, f), getattr(ref, f), err_msg=f)
    np.testing.assert_array_equal(got.aflow, ref.aflow)  # NaN where invalid, in both
    for f in ("img2", "gray2"):  # jitter and noise exact, the warp within WARP_TOL
        np.testing.assert_allclose(getattr(got, f), getattr(ref, f), rtol=0,
                                   atol=WARP_TOL / 0.225, err_msg=f)


@pytest.mark.parametrize("hw", [(80, 100), (40, 50)])  # the second upscales first
def test_synthetic_pairs_match_jax(hw):
    img = texture(np.random.default_rng(1), *hw)
    for seed in range(3):
        rg, rr = np.random.default_rng(seed), np.random.default_rng(seed)
        got = t_data.SyntheticPairBuilder(crop=48).build(rg, img)
        ref = j_data.SyntheticPairBuilder(crop=48).build(rr, img)
        _same_sample(got, ref, resized=hw[0] < 48)
        assert rg.integers(1 << 30) == rr.integers(1 << 30)  # the same draws were made
        assert got.mask.mean() > 0.2


class _Pairs:
    """A dataset with ``get_pair``: shifted copies with their flow."""

    def __init__(self, n=5):
        rng = np.random.default_rng(2)
        self.items = []
        for _ in range(n):
            base = texture(rng, 70, 90)
            ys, xs = np.mgrid[0:64, 0:80].astype(np.float32)
            aflow = np.stack([xs + 3, ys + 2], -1)
            mask = rng.random((64, 80)) < 0.95
            self.items.append((base[:64, :80], base[2:66, 3:83], aflow, mask))

    def __len__(self):
        return len(self.items)

    def get_pair(self, i):
        return self.items[i]


@pytest.mark.parametrize("builder", ["PrecomputedPairBuilder", "TransformedPairBuilder"])
def test_pair_builders_match_jax(builder):
    ds = _Pairs()
    for i in range(len(ds)):
        rg, rr = np.random.default_rng(i), np.random.default_rng(i)
        got = getattr(t_data, builder)(crop=40).build_from_pair(rg, *ds.get_pair(i))
        ref = getattr(j_data, builder)(crop=40).build_from_pair(rr, *ds.get_pair(i))
        _same_sample(got, ref)


def test_pair_loader_matches_jax():
    rng = np.random.default_rng(3)
    images = [texture(rng, 60, 72) for _ in range(6)]
    got_ds = t_data.CatDataset([t_data.ArrayDataset(images[:2]), t_data.ArrayDataset(images[2:])])
    assert len(got_ds) == 6
    np.testing.assert_array_equal(got_ds.get_image(3), images[3])

    class Ref:
        def __len__(self):
            return len(images)

        def get_image(self, i):
            return images[i]

    got = t_data.PairLoader(got_ds, t_data.SyntheticPairBuilder(crop=40), batch_size=2,
                            seed=5, workers=2, iters_per_epoch=2)
    ref = j_data.PairLoader(Ref(), j_data.SyntheticPairBuilder(crop=40), batch_size=2, seed=5,
                            workers=2, iters_per_epoch=2)
    for epoch in (0, 1):
        bg, br = list(got.epoch(epoch)), list(ref.epoch(epoch))
        assert len(bg) == len(br) == 2
        for a, b in zip(bg, br):
            assert set(a) == set(b)
            for k in ("image1", "gray1", "raw1", "mask"):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            np.testing.assert_array_equal(a["aflow"], b["aflow"])
            np.testing.assert_allclose(a["image2"], b["image2"], rtol=0, atol=WARP_TOL / 0.225)


class _Recorder:
    """``ArrayDataset`` that records which images were asked for."""

    def __init__(self, images):
        import threading

        self.images = images
        self.asked = set()
        self.cond = threading.Condition()

    def __len__(self):
        return len(self.images)

    def get_image(self, i):
        with self.cond:
            self.asked.add(int(i))
            self.cond.notify_all()
        return self.images[i]

    def wait_for(self, idxs, timeout=30.0):
        with self.cond:
            return self.cond.wait_for(lambda: set(idxs) <= self.asked, timeout)


def test_pair_loader_prefetches_the_next_batch():
    """While the caller holds batch b, batch b+1's samples are built, and
    the batches are those of the JAX loader (same seeds, same order)."""
    rng = np.random.default_rng(4)
    images = [texture(rng, 60, 72) for _ in range(6)]
    ds = _Recorder(images)
    loader = t_data.PairLoader(ds, t_data.SyntheticPairBuilder(crop=40), batch_size=2, seed=7,
                               workers=2)
    order = np.random.default_rng(7 + 0 * 7919).permutation(6)
    it = loader.epoch(0)
    first = next(it)
    assert ds.wait_for(order[2:4]), "batch 1 was not built while batch 0 was held"
    assert not ds.asked & set(order[4:].tolist())  # one batch ahead, not two
    batches = [first] + list(it)
    ref = list(j_data.PairLoader(t_data.ArrayDataset(images), j_data.SyntheticPairBuilder(crop=40),
                                 batch_size=2, seed=7, workers=2).epoch(0))
    assert len(batches) == len(ref) == 3
    for a, b in zip(batches, ref):
        for k in ("image1", "gray1", "raw1", "mask", "aflow"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        np.testing.assert_allclose(a["image2"], b["image2"], rtol=0, atol=WARP_TOL / 0.225)


def test_pair_loader_stopped_early_builds_nothing_more():
    images = [texture(np.random.default_rng(5), 60, 72) for _ in range(8)]
    ds = _Recorder(images)
    it = t_data.PairLoader(ds, t_data.SyntheticPairBuilder(crop=40), batch_size=2, seed=1,
                           workers=1).epoch(3)
    next(it)
    it.close()  # the caller stops after one batch: the prefetch is cancelled or finished
    assert len(ds.asked) <= 4
