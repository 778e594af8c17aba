"""Sharded matching over a mesh against the JAX package's
``ops/sharded_match.py`` (``tests/test_sharded_match.py``).

The port's mesh is eight entries of the CPU (``["cpu"] * 8``), the JAX
package's the suite's eight host devices. The sharded calls are bit for
bit the single-device calls (pairs are independent), and equal the JAX
sharded programs: identical matches, scores within 1e-6 (the plain
versions on both sides; the kernels' bit-identity across shards is a card
check). ``match_pairs`` and ``LocalizationEngine`` with a mesh give
exactly what they give without one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfd2_torch.io.feature_store import FeatureStore, ImageFeatures, MatchStore
from sfd2_torch.localization.engine import LocalizationEngine, LocalizerConfig
from sfd2_torch.ops.matching import batch_matcher
from sfd2_torch.ops.sharded_match import make_sharded_pair_matcher, query_vs_sharded_bank
from sfd2_torch.parallel import make_mesh, put_batch, put_replicated
from sfd2_torch.pipeline.match import MatchConfig, match_pairs
from sfd2_torch.utils.synth import build_corridor_scene
from sfd2_tpu.io import feature_store as jfs
from sfd2_tpu.localization import engine as jengine
from sfd2_tpu.ops import sharded_match as jsm
from sfd2_tpu.parallel import mesh as jmesh
from sfd2_tpu.pipeline import match as jmatch
from sfd2_tpu.utils.synth import build_corridor_scene as jbuild_corridor_scene

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def meshes():
    return make_mesh(devices=["cpu"] * 8), jmesh.make_mesh(8, ("data",))


def _bank(rng, d=16, k=64, c=32):
    def unit(*shape):
        x = rng.normal(size=shape).astype(np.float32)
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    return unit(k, c), unit(d, k, c), rng.random(k) > 0.1, rng.random((d, k)) > 0.1


def test_mesh_helpers_match_jax_layout(meshes):
    mesh, jm = meshes
    assert mesh.shape == dict(jm.shape) == {"data": 8}
    two = make_mesh(devices=["cpu"] * 8, axis_names=("data", "model"), shape=(4, 2))
    assert two.shape == {"data": 4, "model": 2} and len(two.axis_devices("model")) == 2
    x = torch.arange(32).reshape(16, 2)
    shares = put_batch(mesh, {"x": x, "y": (x[:, 0],)})
    assert len(shares) == 8 and torch.equal(shares[3]["x"], x[6:8])
    assert torch.equal(shares[3]["y"][0], x[6:8, 0])
    with pytest.raises(ValueError, match="divisible"):
        put_batch(mesh, x[:10])
    copies = put_replicated(mesh, torch.nn.Linear(2, 2))
    assert len(copies) == 8 and copies[0] is not copies[1]
    assert torch.equal(copies[5].weight, copies[0].weight)


def test_put_replicated_over_one_axis():
    """A replica per device of an axis (what each share of a split batch
    runs on), or per device of the whole mesh."""
    two = make_mesh(devices=["cpu"] * 8, axis_names=("data", "model"), shape=(4, 2))
    model = torch.nn.Linear(2, 2)
    per_share = put_replicated(two, model, "data")
    assert len(per_share) == 4 and len(put_replicated(two, model)) == 8
    assert all(m is not model and torch.equal(m.weight, model.weight) for m in per_share)
    assert len(put_replicated(two, {"w": np.ones(3)}, "model")) == 2


@pytest.mark.parametrize("labels", [False, True])
def test_query_vs_sharded_bank_matches_single_device_and_jax(meshes, labels):
    mesh, jm = meshes
    rng = np.random.default_rng(1)
    q, bank, qv, bv = _bank(rng)
    ql = rng.integers(0, 3, size=q.shape[0]).astype(np.int32) if labels else None
    bl = rng.integers(0, 3, size=bank.shape[:2]).astype(np.int32) if labels else None
    t = (lambda a: None if a is None else torch.from_numpy(a))  # noqa: E731
    m, s = query_vs_sharded_bank(mesh, t(q), t(bank), t(qv), t(bv), t(ql), t(bl))
    d = bank.shape[0]
    args = [t(q)[None].expand(d, *q.shape), t(bank), t(qv)[None].expand(d, q.shape[0]), t(bv)]
    if labels:
        args += [t(ql)[None].expand(d, q.shape[0]), t(bl)]
    m0, s0 = batch_matcher("nnml" if labels else "nnm")(*args)
    assert torch.equal(m, m0) and torch.equal(s, s0)
    j = (lambda a: None if a is None else jnp.asarray(a))  # noqa: E731
    mj, sj = jsm.query_vs_sharded_bank(jm, j(q), j(bank), j(qv), j(bv), j(ql), j(bl))
    np.testing.assert_array_equal(m.numpy(), np.asarray(mj))
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), atol=1e-6)
    with pytest.raises(ValueError, match="not divisible"):
        query_vs_sharded_bank(mesh, t(q), t(bank[:10]), t(qv), t(bv[:10]))


@pytest.mark.parametrize("mode", ["nnm", "nnr", "onn", "nnml"])
def test_sharded_pair_matcher_matches_single_device_and_jax(meshes, mode):
    mesh, jm = meshes
    rng = np.random.default_rng(2)
    _, bank, _, bv = _bank(rng)
    _, bank0, _, bv0 = _bank(rng)
    bank0[:, :32] = bank[:, :32] + 0.05 * rng.normal(size=bank[:, :32].shape).astype(np.float32)
    bank0 /= np.linalg.norm(bank0, axis=-1, keepdims=True)
    arrays = [bank0, bank, bv0, bv]
    if mode == "nnml":
        arrays += [rng.integers(0, 3, size=bv.shape).astype(np.int32) for _ in range(2)]
    m, s = make_sharded_pair_matcher(mesh, mode)(*[torch.from_numpy(a) for a in arrays])
    m0, s0 = batch_matcher(mode)(*[torch.from_numpy(a) for a in arrays])
    assert torch.equal(m, m0) and torch.equal(s, s0)
    assert (m >= 0).sum() > 100
    mj, sj = jsm.make_sharded_pair_matcher(jm, mode)(*arrays)
    np.testing.assert_array_equal(m.numpy(), np.asarray(mj))
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), atol=1e-6)
    with pytest.raises(ValueError, match="not divisible"):
        make_sharded_pair_matcher(mesh, mode)(*[torch.from_numpy(a[:12]) for a in arrays])


@pytest.mark.parametrize("matcher", ["NNM", "NNR", "NNML"])
def test_match_pairs_with_mesh_writes_the_same_store(meshes, tmp_path, matcher):
    mesh, jm = meshes
    rng = np.random.default_rng(3)
    k, c = 48, 16
    names = [f"im{i}.jpg" for i in range(6)]
    store = FeatureStore()
    with jfs.FeatureStore(tmp_path / "f.h5", "w") as js:
        for n in names:
            de = rng.normal(size=(k - 4, c)).astype(np.float32)
            de /= np.linalg.norm(de, axis=1, keepdims=True)
            f = (rng.random((k - 4, 2)).astype(np.float32) * 100, de,
                 rng.random(k - 4).astype(np.float32), None,
                 rng.integers(0, 3, k - 4).astype(np.int32))
            store.write(n, ImageFeatures(*f))
            js.write(n, jfs.ImageFeatures(*f))
    pairs = [(a, b) for i, a in enumerate(names) for b in names[i + 1:]]  # 15: padded to 16
    cfg = MatchConfig(matcher=matcher, max_keypoints=k, batch_size=5)
    plain, sharded = MatchStore(), MatchStore()
    assert match_pairs(store, pairs, plain, cfg, device="cpu") == 15
    assert match_pairs(store, pairs, sharded, cfg, mesh=mesh) == 15
    with jfs.FeatureStore(tmp_path / "f.h5") as js, \
            jfs.MatchStore(tmp_path / "m.h5", "a") as jstore:
        jmatch.match_pairs(js, pairs, jstore, jmatch.MatchConfig(matcher=matcher,
                                                                 max_keypoints=k,
                                                                 batch_size=5), mesh=jm)
    with jfs.MatchStore(tmp_path / "m.h5") as jstore:
        for a, b in pairs:
            m0, s0 = plain.read(a, b)
            m1, s1 = sharded.read(a, b)
            np.testing.assert_array_equal(m0, m1)
            np.testing.assert_array_equal(s0, s1)
            mj, _ = jstore.read(a, b)
            np.testing.assert_array_equal(m1, mj)


QUICK = dict(ransac_thresh=8.0, opt_thresh=8.0, inlier_thresh=10, covisibility_frame=10,
             iters=2, radius=12.0, obs_thresh=3, max_keypoints=512, num_hypotheses=256,
             pnp_pad_floor=2048)


def test_engine_with_mesh_localizes_as_without(meshes, tmp_path):
    mesh, jm = meshes
    kw = dict(n_images=12, n_queries=2, n_points=1200, kp_per_image=500, kp_per_query=400,
              retrieval_k=9, seed=3)
    store = FeatureStore()
    scene = build_corridor_scene(store, **kw)
    cfg = LocalizerConfig(**QUICK)
    plain = LocalizationEngine(scene.map_index, store, cfg, device="cpu")
    sharded = LocalizationEngine(scene.map_index, store, cfg, device="cpu", mesh=mesh)
    for name, _, _, near in scene.queries:
        a = plain.localize(name, scene.qinfo, [[j] for j in near])
        b = sharded.localize(name, scene.qinfo, [[j] for j in near])
        assert a.source == b.source == "accepted" and a.num_inliers == b.num_inliers
        np.testing.assert_array_equal(a.qvec, b.qvec)
        np.testing.assert_array_equal(a.tvec, b.tvec)
    jscene = jbuild_corridor_scene(tmp_path / "f.h5", **kw)
    name, _, _, near = scene.queries[0]
    kp, desc, _, valid, labels = store.read_padded(name, 512, with_labels=True)
    m_t = sharded._match_query_to_dbs(torch.from_numpy(desc), torch.from_numpy(valid), near)
    np.testing.assert_array_equal(
        m_t, plain._match_query_to_dbs(torch.from_numpy(desc), torch.from_numpy(valid), near))
    with jfs.FeatureStore(jscene.feature_path, "r") as js:
        jeng = jengine.LocalizationEngine(jscene.map_index, js,
                                          jengine.LocalizerConfig(**QUICK), mesh=jm)
        m_j = jeng._match_query_to_dbs(desc, valid, near, labels)
    np.testing.assert_array_equal(m_t, m_j)
    assert (m_t >= 0).sum() > 500
