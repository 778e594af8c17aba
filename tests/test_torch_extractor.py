"""The port's ``Extractor`` against the JAX ``Extractor``, and the store.

Both run the full-width ResSegNetV2 in float32 (``bf16=False``) on the
same Flax-initialised weights with randomised BN statistics. The port
always takes the fused stem (its plain version on the CPU) where the JAX
pipeline at ``bf16=False`` runs the unfused convolutions; the two differ
by float32 rounding (~1e-6), which can flip a near-tied NMS or top-K
decision. So at least 99 % of keypoints must be identical, and on those
the descriptors agree to 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfd2_torch.io.feature_store import FeatureStore, ImageFeatures
from sfd2_torch.models.convert import state_dict_from_flax
from sfd2_torch.pipeline.extract import ExtractionConfig, Extractor, normalize_image
from sfd2_tpu.io.feature_store import FeatureStore as JFeatureStore
from sfd2_tpu.io.feature_store import ImageFeatures as JImageFeatures
from sfd2_tpu.models.sfd2 import ResSegNetV2
from sfd2_tpu.pipeline import extract as jextract

# The suite runs in several worker processes on a few cores: keep each
# worker's intra-op thread pool small so workers do not oversubscribe them.
torch.set_num_threads(2)

K = 256


def _textured(rng, h, w):
    """Blocky colour noise at two scales: corners for the detector."""
    img = np.zeros((h, w, 3), np.float32)
    for cell, wgt in ((16, 0.6), (4, 0.4)):
        base = rng.random((-(-h // cell), -(-w // cell), 3)).astype(np.float32)
        img += wgt * np.kron(base, np.ones((cell, cell, 1), np.float32))[:h, :w]
    return img


@pytest.fixture(scope="module")
def extractors():
    rng = np.random.default_rng(0)
    model = ResSegNetV2(require_stability=True)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.normal(size=a.shape) * 0.3 if p[-1].key == "mean"
                      else rng.random(size=a.shape) + 0.5).astype(np.float32),
        variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    conf = dict(max_keypoints=K, bf16=False)
    jex = jextract.Extractor(variables, jextract.ExtractionConfig(**conf))
    tex = Extractor(state_dict_from_flax(variables), ExtractionConfig(**conf), device="cpu")
    return jex, tex


def _compare(f_t, f_j):
    key = lambda f: {tuple(p): i for i, p in enumerate(np.rint(f.keypoints).astype(int))}
    kt, kj = key(f_t), key(f_j)
    common = sorted(set(kt) & set(kj))
    assert len(kj) > 0.5 * K
    assert len(common) >= 0.99 * len(kj), (len(common), len(kj))
    it = [kt[p] for p in common]
    ij = [kj[p] for p in common]
    np.testing.assert_allclose(f_t.descriptors[it], f_j.descriptors[ij], atol=1e-4)
    np.testing.assert_allclose(f_t.scores[it], f_j.scores[ij], atol=1e-5, rtol=1e-4)
    np.testing.assert_array_equal(f_t.image_size, f_j.image_size)


@pytest.mark.parametrize("hw", [(120, 184), (200, 136)])  # buckets 128×192 and 256×192
def test_extractor_matches_jax_per_bucket(extractors, hw):
    jex, tex = extractors
    img = _textured(np.random.default_rng(hw[0]), *hw)
    _compare(tex.extract_batch([img])[0], jex.extract_batch([img])[0])


def test_extractor_ragged_batch_matches_jax(extractors):
    """Two images of different sizes share one padded batch; borders apply
    at each image's true size."""
    jex, tex = extractors
    rng = np.random.default_rng(5)
    imgs = [_textured(rng, 120, 184), _textured(rng, 90, 130)]
    for f_t, f_j, im in zip(tex.extract_batch(imgs), jex.extract_batch(imgs), imgs):
        _compare(f_t, f_j)
        assert f_t.keypoints[:, 0].max() < im.shape[1] - 4
        assert f_t.keypoints[:, 1].max() < im.shape[0] - 4


def test_extract_to_store_matches_jax(extractors, tmp_path):
    """cv2 loading, bucket grouping and the (kp + 0.5)·scale − 0.5 rescale."""
    import cv2

    jex, tex = extractors
    rng = np.random.default_rng(7)
    names = ["a.png", "b.png"]
    for n, hw in zip(names, [(100, 140), (150, 90)]):
        cv2.imwrite(str(tmp_path / n), (_textured(rng, *hw) * 255).astype(np.uint8))
    tstore = FeatureStore()
    assert tex.extract_to_store(tmp_path, names, tstore) == 2
    with JFeatureStore(tmp_path / "j.h5", "w") as jstore:
        jex.extract_to_store(tmp_path, names, jstore)
        for n in names:
            _compare(tstore.read(n), jstore.read(n))
    assert tex.extract_to_store(tmp_path, names, tstore) == 0  # existing groups skipped


def test_normalize_image_matches_jax(rng):
    img = rng.random((4, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(normalize_image(img), jextract.normalize_image(img))


def _feats(rng, n=30, c=16):
    return ImageFeatures(rng.random((n, 2)).astype(np.float32) * 100,
                         rng.normal(size=(n, c)).astype(np.float32),
                         rng.random(n).astype(np.float32), np.array([640, 480]),
                         rng.integers(0, 4, n).astype(np.int32))


@pytest.mark.parametrize("backing", ["dict", "hdf5"])
def test_feature_store_matches_jax_store(rng, tmp_path, backing):
    f = _feats(rng)
    with JFeatureStore(tmp_path / "j.h5", "w") as js:
        js.write("db/x.jpg", JImageFeatures(*f), as_half=True)
        ref = js.read_padded("db/x.jpg", 40, with_labels=True)
        jdesc = js._f["db/x.jpg"]["descriptors"][()]
    store = FeatureStore() if backing == "dict" else FeatureStore(tmp_path / "t.h5", "w")
    with store:
        store.write("db/x.jpg", f, as_half=True)
        got = store.read_padded("db/x.jpg", 40, with_labels=True)
        assert "db/x.jpg" in store and store.keys() == ["db/x.jpg"]
        raw = (store._groups["db/x.jpg"] if backing == "dict" else store._f["db/x.jpg"])
        assert raw["descriptors"].shape == (16, 30)  # reference [C, N] layout
        np.testing.assert_array_equal(raw["descriptors"][()], jdesc)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    assert got[1].dtype == np.float32
