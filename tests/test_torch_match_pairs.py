"""K4's plain version and the pair-matching pipeline against the JAX package.

``mutual_nn_ratio_match`` (sfd2_torch/ops/matching.py) is the contract the
CUDA kernel ``mutual_nn_ratio_match_cuda`` is held to: the Pallas kernel
``mutual_nn_ratio_match_pallas`` (max-equality mutuality, multiset top-2).
It is held against that kernel in interpret mode with identical matches
and scores within 1e-6 (both compute the same float32 products and pick
from them), and against the XLA path on tie-free inputs. ``match_pairs``
is held against the JAX ``match_pairs`` on the 6-camera scene of
``tests/test_map_building.py``: identical ``matches0`` for NNM and NNR.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from sfd2_torch.io.feature_store import FeatureStore, ImageFeatures, MatchStore, names_to_pair
from sfd2_torch.ops.matching import mutual_nn_ratio_match
from sfd2_torch.pipeline.match import MATCHER_CONFS, MatchConfig, match_pairs
from sfd2_tpu.geometry.cameras import canonicalize_params
from sfd2_tpu.io import feature_store as jfs
from sfd2_tpu.localization.engine import _np_project
from sfd2_tpu.ops import matching as jm
from sfd2_tpu.ops.pallas_match import mutual_nn_ratio_match_pallas
from sfd2_tpu.pipeline import match as jmatch

torch.set_num_threads(2)


def unit(rng, *shape):
    d = rng.normal(size=shape).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def _pair(rng, b, n1, n2, c=32, invalid=0.1):
    """Half of desc1's rows are noisy copies of desc0 rows (real matches),
    ~10 % invalid rows and columns."""
    d0, d1 = unit(rng, b, n1, c), unit(rng, b, n2, c)
    m = min(n1, n2) // 2
    d1[:, :m] = d0[:, rng.permutation(n1)[:m]] + 0.3 * unit(rng, b, m, c)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    return d0, d1, rng.random((b, n1)) > invalid, rng.random((b, n2)) > invalid


def _t(*a):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in a]


def _j(*a):
    return [jnp.asarray(x) for x in a]


@pytest.mark.parametrize("n", [128, 256])
@pytest.mark.parametrize("ratio", [0.8, 0.9])
def test_ratio_match_matches_pallas_interpret(rng, n, ratio):
    d0, d1, v0, v1 = _pair(rng, 2, n, n)
    m_t, s_t = mutual_nn_ratio_match(*_t(d0, d1), ratio, *_t(v0, v1))
    # block_m=64 splits the rows over several grid steps, so the column
    # top-2 is merged across row blocks as in the CUDA kernel.
    m_p, s_p = mutual_nn_ratio_match_pallas(*_j(d0, d1), ratio, *_j(v0, v1), block_m=64,
                                            interpret=True)
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_p))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_p), rtol=0, atol=1e-6)
    assert (m_t >= 0).sum() > 0


@pytest.mark.parametrize("b,n1,n2", [(1, 128, 128), (2, 96, 200), (3, 70, 33)])
def test_ratio_match_matches_xla_tie_free(rng, b, n1, n2):
    d0, d1, v0, v1 = _pair(rng, b, n1, n2)
    m_t, s_t = mutual_nn_ratio_match(*_t(d0, d1), 0.9, *_t(v0, v1))
    m_x, s_x = jax.vmap(lambda a, c, x, y: jm.mutual_nn_ratio_match(a, c, 0.9, x, y))(
        *_j(d0, d1, v0, v1))
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_x))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_x), atol=1e-5)
    assert (m_t.numpy()[~v0] == -1).all()


def test_ratio_tie_gives_equal_column_top2(rng):
    """Rows 0 and 64 identical, column 5 (a noisy copy of them) their common
    best: the column's multiset top-2 is (s, s), its distance ratio ≈ 1 >
    0.9, so neither row matches — as in the Pallas kernel. Without the
    duplicate row, row 0 matches 5."""
    d0 = unit(rng, 1, 128, 16)
    d1 = unit(rng, 1, 128, 16)
    d1[:, 5] = d0[:, 0] + 0.1 * unit(rng, 1, 16)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    m_single, _ = mutual_nn_ratio_match(*_t(d0, d1), 0.9)
    assert m_single[0, 0] == 5
    d0[:, 64] = d0[:, 0]
    m_t, _ = mutual_nn_ratio_match(*_t(d0, d1), 0.9)
    m_p, _ = mutual_nn_ratio_match_pallas(*_j(d0, d1), 0.9, None, None, block_m=64,
                                          interpret=True)
    assert m_t[0, 0] == -1 and m_t[0, 64] == -1
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_p))


# --- match_pairs on the 6-camera scene of tests/test_map_building.py --------

W, H = 640, 480
CAM8 = canonicalize_params("PINHOLE", [520.0, 520.0, 320.0, 240.0])


def scene_features(seed=11, n_pts=300, n_cams=6, desc_dim=64):
    """{name: ImageFeatures} of the fixture in tests/test_map_building.py."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-4, 4, n_pts), rng.uniform(-3, 3, n_pts),
                    rng.uniform(8, 14, n_pts)], 1)
    pdesc = rng.normal(size=(n_pts, desc_dim)).astype(np.float32)
    pdesc /= np.linalg.norm(pdesc, axis=1, keepdims=True)
    feats = {}
    for i in range(n_cams):
        r = Rotation.from_rotvec(rng.normal(size=3) * 0.04)
        q = r.as_quat()[[3, 0, 1, 2]]
        t = -r.as_matrix() @ np.array([i * 0.7 - 1.75, 0.0, 0.0])
        xy, depth = _np_project(pts, q, t, CAM8)
        vis = ((depth > 0) & (xy[:, 0] >= 5) & (xy[:, 0] < W - 5) & (xy[:, 1] >= 5)
               & (xy[:, 1] < H - 5) & (rng.random(n_pts) < 0.9))
        idx = np.nonzero(vis)[0]
        kp = xy[idx] + rng.normal(size=(len(idx), 2)) * 0.2
        de = pdesc[idx] + rng.normal(size=(len(idx), desc_dim)).astype(np.float32) * 0.04
        de /= np.linalg.norm(de, axis=1, keepdims=True)
        feats[f"db/{i + 1:04d}.jpg"] = (kp.astype(np.float32), de,
                                        rng.random(len(idx)).astype(np.float32))
    return feats


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    feats = scene_features()
    path = tmp_path_factory.mktemp("feats") / "feats.h5"
    with jfs.FeatureStore(path, "w") as fs:
        for name, (kp, de, sc) in feats.items():
            fs.write(name, jfs.ImageFeatures(kp, de, sc, None))
    port = FeatureStore()
    for name, (kp, de, sc) in feats.items():
        port.write(name, ImageFeatures(kp, de, sc, None))
    names = sorted(feats)
    pairs = [(a, b) for ai, a in enumerate(names) for b in names[ai + 1:]]
    return path, port, pairs


@pytest.mark.parametrize("matcher", ["NNM", "NNR"])
def test_match_pairs_matches_jax(stores, tmp_path, matcher):
    path, port, pairs = stores
    cfg = dict(matcher=matcher, max_keypoints=512, batch_size=4)
    with jfs.FeatureStore(path, "r") as fs, jfs.MatchStore(tmp_path / "m.h5", "w") as ms:
        assert jmatch.match_pairs(fs, pairs, ms, jmatch.MatchConfig(**cfg)) == len(pairs)
    store = MatchStore()
    assert match_pairs(port, pairs, store, MatchConfig(**cfg), device="cpu") == len(pairs)
    with jfs.MatchStore(tmp_path / "m.h5", "r") as ms:
        for n0, n1 in pairs:
            m_j, s_j = ms.read(n0, n1)
            m_t, s_t = store.read(n0, n1)
            np.testing.assert_array_equal(m_t, m_j)
            np.testing.assert_array_equal(s_t, s_j)  # both stored as float16
            assert (m_t >= 0).sum() > 20


def test_match_pairs_resumes_and_skips_reversed(stores):
    _, port, pairs = stores
    store = MatchStore()
    pairs2 = pairs[:3] + [(b, a) for a, b in pairs[:3]]
    assert match_pairs(port, pairs2, store, MatchConfig(max_keypoints=512), device="cpu") == 3
    assert match_pairs(port, pairs, store, MatchConfig(max_keypoints=512), device="cpu") \
        == len(pairs) - 3


def test_match_pairs_rejects_a_mesh(stores):
    """Anything but a ``parallel.mesh.Mesh`` is refused; over a mesh of
    three CPU entries (batches of 4 padded to 6) the store is the plain
    one."""
    from sfd2_torch.parallel import make_mesh

    _, port, pairs = stores
    with pytest.raises(TypeError, match="mesh"):
        match_pairs(port, pairs, MatchStore(), mesh=object(), device="cpu")
    cfg = MatchConfig(max_keypoints=512, batch_size=4)
    plain, sharded = MatchStore(), MatchStore()
    match_pairs(port, pairs, plain, cfg, device="cpu")
    assert match_pairs(port, pairs, sharded, cfg, mesh=make_mesh(devices=["cpu"] * 3)) \
        == len(pairs)
    for n0, n1 in pairs:
        for a, b in zip(plain.read(n0, n1), sharded.read(n0, n1)):
            np.testing.assert_array_equal(a, b)


def test_match_store_reads_reversed_pairs_like_jax(tmp_path):
    m = np.array([3, -1, 0, 2], np.int32)
    s = np.array([0.9, 0.0, 0.8, 0.7], np.float32)
    store = MatchStore()
    store.write("a/x.jpg", "b/y.jpg", m, s)
    with jfs.MatchStore(tmp_path / "m.h5", "w") as ms:
        ms.write("a/x.jpg", "b/y.jpg", m, s)
    with jfs.MatchStore(tmp_path / "m.h5", "r") as ms:
        for args in (("a/x.jpg", "b/y.jpg"), ("b/y.jpg", "a/x.jpg", 5), ("b/y.jpg", "a/x.jpg")):
            for got, ref in zip(store.read(*args), ms.read(*args)):
                np.testing.assert_array_equal(got, ref)
    assert store.has_pair("b/y.jpg", "a/x.jpg")
    assert names_to_pair("a/x.jpg", "b/y.jpg") == jfs.names_to_pair("a/x.jpg", "b/y.jpg")
    assert set(MATCHER_CONFS) == set(jmatch.MATCHER_CONFS)


@pytest.mark.parametrize("args", [("a/x.jpg", "b/y.jpg"), ("b/y.jpg", "a/x.jpg", 5),
                                  ("b/y.jpg", "a/x.jpg")])
@pytest.mark.parametrize("on_disk", [False, True])
def test_match_store_reads_matches_without_scores(tmp_path, args, on_disk):
    """``with_scores=False`` (two-view verification's read) gives the same
    matches, forward and reversed, and no scores."""
    m = np.array([3, -1, 0, 2], np.int32)
    s = np.array([0.9, 0.0, 0.8, 0.7], np.float32)
    path = tmp_path / "m.h5" if on_disk else None
    with MatchStore(path, "w") as store:
        store.write("a/x.jpg", "b/y.jpg", m, s)
    with MatchStore(path, "r") if on_disk else contextlib.nullcontext(store) as store:
        got, none = store.read(*args, with_scores=False)
        ref, _ = store.read(*args)
    assert none is None and got.dtype == np.int64
    np.testing.assert_array_equal(got, ref)
