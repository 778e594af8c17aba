"""sfd2_torch extraction ops against the JAX package on the same inputs.

NMS, bilinear resize, point sampling and ``extract_keypoints`` (the
``sizes``-aware border, the cell-max top-K and the flat top-K). Scores
are random continuous values, so no two candidates tie and keypoint
indices must agree exactly; values are float32 and agree to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sfd2_torch.ops.extract import extract_keypoints
from sfd2_torch.ops.grid_sample import sample_at_points
from sfd2_torch.ops.nms import simple_nms
from sfd2_torch.ops.resize import resize_bilinear
from sfd2_tpu.ops import extract as jextract
from sfd2_tpu.ops import grid_sample as jgrid
from sfd2_tpu.ops import nms as jnms
from sfd2_tpu.ops import resize as jresize

# The suite runs in several worker processes on a few cores: keep each
# worker's intra-op thread pool small so workers do not oversubscribe them.
torch.set_num_threads(2)


def _f32(rng, *shape):
    return rng.random(shape).astype(np.float32)


@pytest.mark.parametrize("radius", [2, 4])
def test_simple_nms_matches_jax(rng, radius):
    s = _f32(rng, 2, 48, 64) ** 4  # peaked maps: many suppressed neighbours
    got = simple_nms(torch.from_numpy(s), radius).numpy()
    ref = np.asarray(jnms.simple_nms(jnp.asarray(s), radius))
    np.testing.assert_array_equal(got, ref)
    assert 0 < (got > 0).sum() < s.size


@pytest.mark.parametrize("src,dst", [((12, 16), (48, 64)), ((48, 64), (20, 30)),
                                     ((13, 7), (29, 40))])
@pytest.mark.parametrize("align_corners", [False, True])
def test_resize_bilinear_matches_jax(rng, src, dst, align_corners):
    x = _f32(rng, 2, *src, 3)
    got = resize_bilinear(torch.from_numpy(x), dst, align_corners).numpy()
    ref = np.asarray(jresize.resize_bilinear(jnp.asarray(x), dst, align_corners))
    np.testing.assert_allclose(got, ref, atol=1e-6)
    x2 = x[0, ..., 0]  # a 2-D map is one [H, W] plane
    np.testing.assert_allclose(
        resize_bilinear(torch.from_numpy(x2), dst, align_corners).numpy(),
        np.asarray(jresize.resize_bilinear(jnp.asarray(x2), dst, align_corners)), atol=1e-6)


def test_stability_upsample_interpolate_matches_jax_image_resize(rng):
    """V2 stability upsamples logit planes with F.interpolate where the JAX
    model calls jax.image.resize: the same half-pixel bilinear when upsampling."""
    sta = rng.normal(size=(2, 3, 16, 24)).astype(np.float32)
    got = F.interpolate(torch.from_numpy(sta), size=(64, 96), mode="bilinear",
                        align_corners=False).numpy()
    ref = np.asarray(jax.image.resize(jnp.asarray(sta), (2, 3, 64, 96), method="bilinear"))
    np.testing.assert_allclose(got, ref, atol=1e-6)


@pytest.mark.parametrize("mode", ["zeros", "border"])
def test_sample_at_points_matches_jax(rng, mode):
    fmap = _f32(rng, 10, 14, 8)
    xy = (rng.random((50, 2)) * [16, 12] - 1).astype(np.float32)  # some off the map
    got = sample_at_points(torch.from_numpy(fmap), torch.from_numpy(xy), mode).numpy()
    ref = np.asarray(jgrid.sample_at_points(jnp.asarray(fmap), jnp.asarray(xy), mode))
    np.testing.assert_allclose(got, ref, atol=1e-6)


def _maps(rng, b=2, h=64, w=96, c=32):
    heat = _f32(rng, b, h, w) ** 3 * 0.05
    desc = rng.normal(size=(b, h // 4, w // 4, c)).astype(np.float32)
    stab = rng.choice(np.array([0.1, 0.5, 1.0], np.float32), size=(b, h, w))
    return heat, desc, stab


@pytest.mark.parametrize("k,radius", [
    (64, 4),    # cell-max two-stage top-K (radius ≥ 3, k ≤ cells)
    (300, 4),   # k > #candidates: padded rows must be invalid in both
    (64, 2),    # radius < 3: flat top-K
])
def test_extract_keypoints_matches_jax(rng, k, radius):
    heat, desc, stab = _maps(rng)
    sizes = np.array([[96, 64], [70, 50]], np.int32)  # image 1 is zero-padded
    kw = dict(max_keypoints=k, conf_threshold=0.001, nms_radius=radius, border=4)
    got = extract_keypoints(torch.from_numpy(heat), torch.from_numpy(desc),
                            torch.from_numpy(stab), torch.from_numpy(sizes), **kw)
    ref = jextract.extract_keypoints(jnp.asarray(heat), jnp.asarray(desc), jnp.asarray(stab),
                                     jnp.asarray(sizes), **kw)
    valid = np.asarray(ref.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.xy.numpy()[valid], np.asarray(ref.xy)[valid])
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores), atol=1e-7)
    np.testing.assert_allclose(got.descriptors.numpy(), np.asarray(ref.descriptors), atol=1e-6)
    # Border at the TRUE size of the padded image.
    xy1 = got.xy.numpy()[1][got.valid.numpy()[1]]
    assert len(xy1) and xy1[:, 0].max() < 70 - 4 and xy1[:, 1].max() < 50 - 4


def test_extract_keypoints_without_sizes_matches_jax(rng):
    heat, desc, _ = _maps(rng, b=1)
    got = extract_keypoints(torch.from_numpy(heat), torch.from_numpy(desc), max_keypoints=32)
    ref = jextract.extract_keypoints(jnp.asarray(heat), jnp.asarray(desc), max_keypoints=32)
    np.testing.assert_array_equal(got.xy.numpy(), np.asarray(ref.xy))
    np.testing.assert_allclose(got.descriptors.numpy(), np.asarray(ref.descriptors), atol=1e-6)
