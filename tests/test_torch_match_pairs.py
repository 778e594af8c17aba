"""K4's plain version and the pair-matching pipeline against the JAX package.

``mutual_nn_ratio_match`` (sfd2_torch/ops/matching.py) is the contract the
CUDA kernel ``mutual_nn_ratio_match_cuda`` is held to: the Pallas kernel
``mutual_nn_ratio_match_pallas`` (max-equality mutuality, multiset top-2).
It is held against that kernel in interpret mode with identical matches
and scores within 1e-6 (both compute the same float32 products and pick
from them), and against the XLA path on tie-free inputs. ``match_pairs``
is held against the JAX ``match_pairs`` on the 6-camera scene of
``tests/test_map_building.py``: identical ``matches0`` for NNM and NNR.
Its banks, staged on the device from the store's own [C, N] layout, give
stores byte-identical to those of banks padded on the host by
``read_padded`` (dict and HDF5 stores, float16 ones, images cut at K and
shorter than K, labels, a small device cache, a mesh).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from sfd2_torch.io.feature_store import FeatureStore, ImageFeatures, MatchStore, names_to_pair
from sfd2_torch.ops.matching import batch_matcher, mutual_nn_ratio_match
from sfd2_torch.ops import sharded_match
from sfd2_torch.ops.sharded_match import make_sharded_pair_matcher
from sfd2_torch.parallel import make_mesh
from sfd2_torch.pipeline import match as match_module
from sfd2_torch.pipeline.match import MATCHER_CONFS, MatchConfig, match_pairs
from sfd2_torch.utils.profiling import counter
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


# --- banks staged on the device from the store's own layout ---------------


@pytest.mark.parametrize("dtype", ["<f4", "<f2", ">f4"])
@pytest.mark.parametrize("layout", ["cn", "nc", "square"])
def test_read_stored_keeps_the_stored_array(rng, layout, dtype):
    """``read_stored`` hands back the stored array itself (dtype kept, no
    copy; a big-endian array, which ``h5file`` reads, in native order) and
    ``read``'s [C, N] / [N, C] decision: hloc's [C, N]; [N, C] as another
    writer may leave it; and C == N, which ``read`` takes as [N, C]."""
    n, c = {"cn": (40, 16), "nc": (40, 16), "square": (24, 24)}[layout]
    desc = unit(rng, n, c)
    stored = np.ascontiguousarray(desc if layout == "nc" else desc.T).astype(dtype)
    labels = rng.integers(0, 5, n).astype(np.int32)
    fs = FeatureStore()
    fs._groups["a.jpg"] = {"keypoints": rng.random((n, 2)).astype(np.float32),
                           "descriptors": stored, "scores": np.ones(n, np.float32),
                           "labels": labels}
    got = fs.read_stored("a.jpg", with_labels=True)
    assert got.descriptors.dtype == stored.dtype.newbyteorder("=") and got.num == n
    assert np.shares_memory(got.descriptors, stored) == stored.dtype.isnative
    assert got.channels_first == (layout == "cn")
    laid = got.descriptors.T if got.channels_first else got.descriptors
    np.testing.assert_array_equal(laid.astype(np.float32), fs.read("a.jpg").descriptors)
    np.testing.assert_array_equal(got.labels, labels)
    assert fs.read_stored("a.jpg").labels is None


def _recorded(make, launches):
    """`make` (a matcher factory) whose matchers append their arguments to
    `launches` before they run."""

    def build(*a, **kw):
        fn = make(*a, **kw)

        def run(*args):
            launches.append([t.cpu().clone() for t in args])
            return fn(*args)

        return run

    return build


def _read_padded_store(features, pairs, cfg, mesh=None, launches=None):
    """The store ``match_pairs`` wrote with banks padded on the host: each
    image through ``read_padded``, the batch stacked from the host arrays,
    the same batches and matcher. `pairs` holds no repeat and no reverse."""
    conf = MATCHER_CONFS[cfg.matcher]
    if mesh is None:
        fn, n_dev = _recorded(batch_matcher, launches)(conf["mode"], conf.get("ratio", 0.9)), 1
    else:
        fn = _recorded(make_sharded_pair_matcher, launches)(mesh, conf["mode"],
                                                            conf.get("ratio", 0.9))
        n_dev = mesh.shape["data"]
    fields = (1, 3, 4) if conf["mode"] == "nnml" else (1, 3)  # desc, valid, labels
    store = MatchStore()
    for i in range(0, len(pairs), cfg.batch_size):
        chunk = pairs[i: i + cfg.batch_size]
        pad = -(-len(chunk) // n_dev) * n_dev - len(chunk)
        sides = []
        for side in zip(*chunk):
            rows = [features.read_padded(n, cfg.max_keypoints, with_labels=True) for n in side]
            sides.append(rows + [tuple(np.zeros_like(a) for a in rows[0])] * pad)
        m, s = fn(*[torch.stack([torch.from_numpy(r[j]) for r in rows])
                    for j in fields for rows in sides])
        m, s = m.cpu().numpy(), s.cpu().numpy()
        for bi, (n0, n1) in enumerate(chunk):
            n = int(sides[0][bi][3].sum())
            store.write(n0, n1, m[bi, :n].astype(np.int32), s[bi, :n])
    return store


STAGED = {
    "dict": {},
    "h5": dict(on_disk=True),
    "half": dict(as_half=True),
    "h5_half": dict(on_disk=True, as_half=True),
    "cut_at_k": dict(cut=True),
    "nnml_labels": dict(matcher="NNML"),
    "nnml_h5_half_cut": dict(matcher="NNML", on_disk=True, as_half=True, cut=True),
    "nnr": dict(matcher="NNR"),
    "small_cache": dict(cache=3),
    "mesh": dict(mesh=3),
}


@pytest.mark.parametrize("case", list(STAGED))
def test_staged_banks_write_the_read_padded_store(tmp_path, monkeypatch, case):
    """Banks staged on the device from ``read_stored`` give the matcher
    bit for bit the launches (descriptors, zero padding, masks, labels)
    and the store that banks from ``read_padded`` give, and ``match_pairs``
    no longer reads a padded or transposed copy on the host. With every
    bank in the device cache each distinct image is staged once."""
    opt = STAGED[case]
    rng = np.random.default_rng(5)
    feats = scene_features(seed=13, n_pts=260, n_cams=7)
    names = sorted(feats)
    ns = sorted(len(feats[n][0]) for n in names)
    k = ns[len(ns) // 2] if opt.get("cut") else 512
    if opt.get("cut"):
        assert ns[0] < k < ns[-1]
    path = tmp_path / "f.h5" if opt.get("on_disk") else None
    with FeatureStore(path, "w") as fs:
        for name in names:
            kp, de, sc = feats[name]
            lb = rng.integers(0, 4, len(kp)).astype(np.int32)
            fs.write(name, ImageFeatures(kp, de, sc, None, lb), as_half=opt.get("as_half", False))
    fs = FeatureStore(path, "r") if path is not None else fs
    pairs = [(a, b) for ai, a in enumerate(names) for b in names[ai + 1:]]
    cfg = MatchConfig(matcher=opt.get("matcher", "NNM"), max_keypoints=k, batch_size=4)
    mesh = make_mesh(devices=["cpu"] * opt["mesh"]) if "mesh" in opt else None
    ref_launches, launches = [], []
    with fs:
        ref = _read_padded_store(fs, pairs, cfg, mesh, ref_launches)

        def refuse(*args, **kwargs):
            raise AssertionError("match_pairs read a host copy of the descriptors")

        monkeypatch.setattr(FeatureStore, "read_padded", refuse)
        monkeypatch.setattr(FeatureStore, "read", refuse)
        monkeypatch.setattr(match_module, "batch_matcher",
                            _recorded(match_module.batch_matcher, launches))
        monkeypatch.setattr(sharded_match, "make_sharded_pair_matcher",
                            _recorded(sharded_match.make_sharded_pair_matcher, launches))
        if "cache" in opt:
            monkeypatch.setattr(match_module, "_DEV_CACHE_IMAGES", opt["cache"])
        staged0, matched0 = counter("match.banks_staged"), counter("match.pairs_matched")
        got = MatchStore()
        assert match_pairs(fs, pairs, got, cfg, mesh=mesh, device="cpu") == len(pairs)
    staged = counter("match.banks_staged") - staged0
    assert counter("match.pairs_matched") - matched0 == len(pairs)
    assert staged > len(names) if "cache" in opt else staged == len(names)
    assert len(launches) == len(ref_launches) == -(-len(pairs) // cfg.batch_size)
    for args, ref_args in zip(launches, ref_launches):
        assert len(args) == len(ref_args)
        for a, b in zip(args, ref_args):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.numpy().tobytes() == b.numpy().tobytes()
    n_matched = 0
    for n0, n1 in pairs:
        key = names_to_pair(n0, n1)
        for field in ("matches0", "matching_scores0"):
            a, b = got._groups[key][field], ref._groups[key][field]
            assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
        assert len(got._groups[key]["matches0"]) == min(len(feats[n0][0]), k)
        n_matched += int((got._groups[key]["matches0"] >= 0).sum())
    assert n_matched > 20 * len(pairs)
