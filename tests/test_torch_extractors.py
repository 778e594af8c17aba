"""The port's extractor registry and its two CLIs against the JAX package's.

Every registry name runs through the port's ``dynamic_load`` and the JAX
``dynamic_load`` with the same weights (Flax-initialised, carried across
by the port's converters) on the same 96×128 image, in float32 on the CPU.
At least 98 % of the keypoints must be identical (a convolution summed in
another order can flip a near-tied NMS or top-K decision; D2-Net's tied
scores may come in another order, so keypoints are compared as sets) and,
on those, descriptors and scores agree within 1e-5 (CAPS's descriptors
are raw feature-map samples, held within 1e-4 of their largest
magnitude). The DIR descriptor agrees within 1e-5. Then: ``KeyError`` on an unknown
name, ``ImportError`` for the OpenCV-based extractors with cv2 hidden
(while ``caps_describe`` still runs), both CLIs beside the JAX CLIs, and
the baseline branch of ``cli/extract_features.py`` for every extractor.
"""

import functools
import sys

import cv2
import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfd2_torch.cli import extract_features as t_cli
from sfd2_torch.cli import extract_global as t_gcli
from sfd2_torch.io.feature_store import FeatureStore
from sfd2_torch.models import convert_baselines as tcb
from sfd2_torch.models.baselines import CapsResUNet as TCapsResUNet
from sfd2_torch.models.convert import state_dict_from_flax
from sfd2_torch.pipeline import extractors as tx
from sfd2_tpu.cli import extract_features as j_cli
from sfd2_tpu.cli import extract_global as j_gcli
from sfd2_tpu.io.feature_store import FeatureStore as JFeatureStore
from sfd2_tpu.models import baselines as jb
from sfd2_tpu.models import r2d2 as jr2
from sfd2_tpu.models import retrieval as jret
from sfd2_tpu.models import superpoint as jsp
from sfd2_tpu.models.sfd2 import ResSegNetV2
from sfd2_tpu.pipeline import extractors as jx

torch.set_num_threads(2)

CFG = dict(max_keypoints=128, conf_threshold=1e-5)


def _randomise(variables, seed):
    """Random BN running statistics (numpy seed): no BN is an identity."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a = np.asarray(a)
        if path[-1].key == "mean":
            return (rng.normal(size=a.shape) * 0.3).astype(np.float32)
        if path[-1].key == "var":
            return (rng.random(size=a.shape) + 0.5).astype(np.float32)
        return a

    host = jax.tree_util.tree_map(np.asarray, dict(variables))
    return jax.tree_util.tree_map_with_path(leaf, host)


def _init(model, channels=3, seed=0):
    x = jnp.zeros((1, 64, 64, channels))
    return _randomise(jax.jit(model.init)(jax.random.PRNGKey(seed), x), seed)


# name → (JAX variables, the port's state_dict)
def _weights(name):
    if name == "superpoint":
        v = _init(jsp.SuperPoint(), channels=1)
        return v, tcb.superpoint_from_flax(v)
    if name == "r2d2":
        v = _init(jr2.QuadL2NetConfCFS())
        return v, tcb.quad_l2net_from_flax(v)
    if name == "d2net":
        v = _init(jb.D2NetDense(use_relu=True))
        return v, tcb.d2net_from_flax(v)
    if name == "caps":
        v = _init(jb.CapsResUNet())
        return v, tcb.caps_from_flax(v)
    if name == "sgd2":
        v = _init(jb.L2SegNetNB(outdim=128))
        return v, tcb.l2segnetnb_from_flax(v)
    if name == "sfd2":
        v = _init(ResSegNetV2(require_stability=True))
        return v, state_dict_from_flax(v)
    if name == "dir":
        v = _init(jret.ResNetGeM(depths=(1, 1, 1, 1)))
        return v, tcb.resnet_gem_from_flax(v)
    return None, None


def _textured(rng, h, w):
    img = np.zeros((h, w, 3), np.float32)
    for cell, wgt in ((16, 0.6), (4, 0.4)):
        base = rng.random((-(-h // cell), -(-w // cell), 3)).astype(np.float32)
        img += wgt * np.kron(base, np.ones((cell, cell, 1), np.float32))[:h, :w]
    return img


@pytest.fixture(scope="module")
def image():
    return _textured(np.random.default_rng(0), 96, 128)


def _shared(f_t, f_j):
    """Indices of the keypoints at the same position in both sets, and the
    numbers of distinct positions in each (SIFT repeats a position with
    another orientation)."""
    def key(f):
        return {tuple(p): i for i, p in enumerate(np.rint(f.keypoints * 64).astype(int).tolist())}

    kt, kj = key(f_t), key(f_j)
    common = sorted(set(kt) & set(kj))
    return [kt[p] for p in common], [kj[p] for p in common], len(kj), len(kt)


@pytest.mark.parametrize("name", ["superpoint", "r2d2", "sift", "d2net", "caps", "sgd2", "sfd2"])
def test_registry_matches_jax(name, image):
    v, sd = _weights(name)
    kw_j = {} if v is None else {"variables": v}
    f_j = jx.dynamic_load(name, jx.BaselineConfig(**CFG), **kw_j)(image)
    f_t = tx.dynamic_load(name, tx.BaselineConfig(**CFG), state_dict=sd, device="cpu")(image)
    it, ij, n_ref, n_got = _shared(f_t, f_j)
    assert n_ref > 20 and len(f_t.keypoints) <= CFG["max_keypoints"]
    assert len(it) >= 0.98 * max(n_ref, n_got), (len(it), n_ref, n_got)
    assert f_t.descriptors.shape[1] == f_j.descriptors.shape[1]
    d_t, d_j = f_t.descriptors[it], f_j.descriptors[ij]
    if name == "caps":
        np.testing.assert_allclose(d_t, d_j, rtol=0, atol=1e-4 * np.abs(d_j).max())
    else:
        np.testing.assert_allclose(d_t, d_j, rtol=0, atol=1e-5)
        np.testing.assert_allclose(np.linalg.norm(f_t.descriptors, axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(f_t.scores[it], f_j.scores[ij], rtol=0,
                               atol=1e-5)
    assert np.all(np.diff(f_t.scores) <= 0)  # by descending score


def test_registry_dir_matches_jax(image):
    v, sd = _weights("dir")
    g_j = jx.dynamic_load("dir", variables=v, depths=(1, 1, 1, 1))(image)
    g_t = tx.dynamic_load("dir", state_dict=sd, device="cpu")(image)
    assert g_t.shape == (2048,) and g_t.dtype == np.float32
    np.testing.assert_allclose(g_t, g_j, rtol=0, atol=1e-5)
    # With dirtorch's PCA whitening (a basis of 8 random orthonormal axes).
    rng = np.random.default_rng(1)
    comps = np.linalg.qr(rng.normal(size=(2048, 8)))[0].T
    pca = (rng.normal(size=2048) * 0.01, comps, rng.random(8) + 0.5)
    w_j = jx.dynamic_load("dir", variables=v, depths=(1, 1, 1, 1), whiten_pca=pca)(image)
    w_t = tx.dynamic_load("dir", state_dict=sd, device="cpu", whiten_pca=pca)(image)
    assert w_t.shape == (8,)
    np.testing.assert_allclose(w_t, w_j, rtol=0, atol=1e-5)


def test_d2net_selection_orders_ties_row_major():
    feats = torch.zeros((6, 8, 4))
    for y, x in ((1, 1), (1, 5), (4, 2), (4, 6)):  # four isolated, equal peaks
        feats[y, x, 0] = 1.0
        feats[y, x + 1, 0] = feats[y, x - 1, 0] = feats[y + 1, x, 0] = feats[y - 1, x, 0] = 0.5
    feats[4, 6, 0] = 2.0  # the one strongest first
    out = tx.d2net_select(feats, max_keypoints=3)
    np.testing.assert_array_equal(out[:, :2].numpy(),
                                  [[6 * 4 + 1.5, 4 * 4 + 1.5], [1 * 4 + 1.5, 1 * 4 + 1.5],
                                   [5 * 4 + 1.5, 1 * 4 + 1.5]])
    np.testing.assert_array_equal(out[:, 2].numpy(), [2.0, 1.0, 1.0])


def test_unknown_extractor_raises():
    with pytest.raises(KeyError):
        tx.dynamic_load("nope")


def test_cuda_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tx.dynamic_load("superpoint")  # device defaults to cuda


def test_opencv_extractors_need_cv2(monkeypatch, image):
    monkeypatch.setitem(sys.modules, "cv2", None)  # `import cv2` raises ImportError
    for name in ("sift", "caps"):
        with pytest.raises(ImportError, match="cv2"):
            tx.dynamic_load(name, device="cpu")
    with pytest.raises(ImportError, match="cv2"):
        tx.caps_detect(image)
    # The CAPS network itself needs no OpenCV.
    model = tx.build_model(TCapsResUNet(layers=(1, 1, 1)), device="cpu", seed=0)
    xy = np.array([[10.0, 20.0], [100.5, 50.25]], np.float32)
    de = tx.caps_describe(model, image, xy)
    assert de.shape == (2, 256) and np.isfinite(de).all()


def test_seeded_weights_are_reproducible():
    a = tx.seeded_init_(TCapsResUNet(layers=(1, 1, 1)), 3).state_dict()
    b = tx.seeded_init_(TCapsResUNet(layers=(1, 1, 1)), 3).state_dict()
    c = tx.seeded_init_(TCapsResUNet(layers=(1, 1, 1)), 4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["firstconv.weight"], c["firstconv.weight"])
    assert torch.equal(a["conv_fine.conv.bias"], torch.zeros(128))


# ---------------------------------------------------------------------------
# CLIs
# ---------------------------------------------------------------------------


def _write_images(root, sizes, seed=0):
    rng = np.random.default_rng(seed)
    (root / "db").mkdir(parents=True)
    names = []
    for i, (h, w) in enumerate(sizes):
        name = f"db/{i}.png"
        cv2.imwrite(str(root / name), (_textured(rng, h, w)[..., ::-1] * 255).astype(np.uint8))
        names.append(name)
    return names


def test_extract_features_cli_superpoint_matches_jax(tmp_path, monkeypatch):
    """Both CLIs with ``--extractor superpoint`` at ``sfd2-n4096-r1024``:
    the JAX CLI's weights are its registry default (Flax init from
    PRNGKey(0)); the port's CLI reads them from a ``.pth``. The JAX CLI
    initialises a ResSegNetV2 that its baseline branch never uses; a
    one-layer stand-in saves that compile."""
    monkeypatch.setattr(j_cli, "ResSegNetV2", lambda require_stability: flax.linen.Dense(1))
    names = _write_images(tmp_path / "imgs", [(96, 128), (120, 88)])
    v = jsp.SuperPoint().init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 1)))
    torch.save(tcb.superpoint_from_flax(v), tmp_path / "sp.pth")
    args = ["--image_dir", str(tmp_path / "imgs"), "--extractor", "superpoint",
            "--conf", "sfd2-n4096-r1024"]
    assert t_cli.main(args + ["--export_fn", str(tmp_path / "t.h5"), "--device", "cpu",
                              "--weights", str(tmp_path / "sp.pth")]) == 2
    j_cli.main(args + ["--export_fn", str(tmp_path / "j.h5")])
    with FeatureStore(tmp_path / "t.h5") as ts, JFeatureStore(tmp_path / "j.h5") as js:
        assert sorted(ts.keys()) == sorted(js.keys()) == names
        for n in names:
            f_t, f_j = ts.read(n), js.read(n)
            np.testing.assert_array_equal(f_t.image_size, f_j.image_size)
            it, ij, n_ref, n_got = _shared(f_t, f_j)
            assert n_ref > 50 and len(it) >= 0.98 * max(n_ref, n_got)
            np.testing.assert_allclose(f_t.keypoints[it], f_j.keypoints[ij], rtol=0, atol=1e-5)
            np.testing.assert_allclose(f_t.descriptors[it], f_j.descriptors[ij], rtol=0,
                                       atol=1e-5)
    # Resumable: a second run extracts nothing.
    assert t_cli.main(args + ["--export_fn", str(tmp_path / "t.h5"), "--device", "cpu",
                              "--weights", str(tmp_path / "sp.pth")]) == 0


@pytest.mark.parametrize("name", ["superpoint", "r2d2", "d2net", "sgd2", "caps", "sift"])
def test_extract_features_cli_runs_every_baseline(tmp_path, name):
    names = _write_images(tmp_path / "imgs", [(72, 96)], seed=3)
    (tmp_path / "list.txt").write_text("\n".join(names))
    assert t_cli.main(["--image_dir", str(tmp_path / "imgs"), "--image_list",
                       str(tmp_path / "list.txt"), "--export_fn", str(tmp_path / "f.h5"),
                       "--extractor", name, "--conf", "sfd2-n1000-r1600", "--as_half",
                       "--device", "cpu"]) == 1
    with FeatureStore(tmp_path / "f.h5") as store:
        f = store.read(names[0])
    dim = {"superpoint": 256, "d2net": 512, "caps": 256}.get(name, 128)
    assert 0 < len(f.keypoints) <= 1000 and f.descriptors.shape == (len(f.keypoints), dim)
    assert np.isfinite(f.descriptors).all() and np.isfinite(f.scores).all()
    np.testing.assert_array_equal(f.image_size, [96, 72])


def test_extract_global_cli_matches_jax(tmp_path, monkeypatch):
    """Both CLIs on the same PNGs with a ResNetGeM of depths (1, 1, 1, 1):
    the JAX registry entry is given the Flax variables, the port's CLI the
    same weights as a reference ``.pth``."""
    names = _write_images(tmp_path / "imgs", [(96, 128), (120, 88), (64, 64)], seed=5)
    v, sd = _weights("dir")
    torch.save(sd, tmp_path / "dir.pth")
    monkeypatch.setitem(jx.GLOBAL_EXTRACTOR_REGISTRY, "dir",
                        functools.partial(jx.make_dir, variables=v, depths=(1, 1, 1, 1)))
    base = ["--image_dir", str(tmp_path / "imgs")]
    assert t_gcli.main(base + ["--output", str(tmp_path / "t.npz"), "--device", "cpu",
                               "--weights", str(tmp_path / "dir.pth")]) == 3
    j_gcli.main(base + ["--output", str(tmp_path / "j.npz")])
    t, j = np.load(tmp_path / "t.npz"), np.load(tmp_path / "j.npz")
    assert list(t["names"]) == list(j["names"]) == names
    assert t["descriptors"].shape == (3, 2048)
    np.testing.assert_allclose(t["descriptors"], j["descriptors"], rtol=0, atol=1e-5)


def test_extract_global_cli_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    _write_images(tmp_path / "imgs", [(64, 64)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_gcli.main(["--image_dir", str(tmp_path / "imgs"), "--output", str(tmp_path / "g.npz")])
