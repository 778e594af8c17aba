"""The port's native union-find (``sfd2_torch/native``, built from
``sfd2_torch/csrc/tracks.cpp``) against the Python rule it replaces.

Union by rank with path halving, the tie on equal ranks going to the
first edge end's root: the native roots must equal
``sfm/tracks.py::union_find_roots_plain``'s node for node, on random
graphs and on the verified edges of a small corridor map, so the tracks
(listed in root order) are identical. The library is built into
``sfd2_torch/_build/`` with the JAX helper's g++ flags, rebuilt when the
source is newer, and a failed build raises.
"""

import os

import numpy as np
import pytest

from sfd2_torch import native
from sfd2_torch.io.feature_store import FeatureStore, MatchStore
from sfd2_torch.pipeline.match import MatchConfig, match_pairs
from sfd2_torch.sfm import tracks as ttracks
from sfd2_torch.sfm.pairs import pairs_from_covisibility
from sfd2_torch.sfm.pipeline import TriangulationConfig, geometric_verification
from sfd2_torch.utils.synth import build_corridor_scene
from sfd2_tpu import native as jnative


@pytest.mark.parametrize("n,e,seed", [(1, 0, 0), (60, 40, 1), (1000, 3000, 2),
                                      (5000, 200, 3), (20000, 60000, 4)])
def test_native_roots_equal_the_python_rule(n, e, seed):
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, n, size=(e, 2))
    got = native.union_find_roots(n, edges)
    np.testing.assert_array_equal(got, ttracks.union_find_roots_plain(n, edges))
    assert got.dtype == np.int64


def test_native_roots_equal_the_jax_helper():
    """The same source and flags as the JAX package's helper, where that
    one builds."""
    if jnative.get_lib() is None:
        pytest.skip("the JAX package's helper did not build here")
    edges = np.random.default_rng(5).integers(0, 3000, size=(9000, 2))
    np.testing.assert_array_equal(native.union_find_roots(3000, edges),
                                  jnative.union_find_roots(3000, edges))
    assert native.GXX_FLAGS == ["-O3", "-std=c++17", "-shared", "-fPIC"]


def test_native_rejects_out_of_range_edges():
    with pytest.raises(IndexError):
        native.union_find_roots(10, np.array([[0, 10]]))


@pytest.fixture(scope="module")
def corridor_edges():
    store = FeatureStore()
    scene = build_corridor_scene(store, n_images=10, n_queries=0, n_points=800, desc_dim=64,
                                 kp_per_image=300, seed=3)
    mi = scene.map_index
    pairs = pairs_from_covisibility(mi, num_matched=5)
    matches = MatchStore()
    match_pairs(store, pairs, matches, MatchConfig(matcher="NNM", max_keypoints=512),
                device="cpu")
    verified = geometric_verification(store, matches, pairs, TriangulationConfig(),
                                      device="cpu")
    name_id = {im.name: iid for iid, im in mi.images.items()}
    nkp = {iid: len(store.read(im.name).keypoints) for iid, im in mi.images.items()}
    return nkp, [(name_id[a], name_id[b], m) for a, b, m in verified]


def test_corridor_tracks_equal_the_python_rule(corridor_edges, monkeypatch):
    nkp, vm = corridor_edges
    assert len(vm) > 10
    got = ttracks.build_tracks(nkp, vm)
    monkeypatch.setattr(ttracks, "union_find_roots", ttracks.union_find_roots_plain)
    assert got == ttracks.build_tracks(nkp, vm) and len(got) > 100


def test_tracks_arrays_equal_the_python_rule(monkeypatch):
    edges = np.random.default_rng(6).integers(0, 8 * 50, size=(600, 2))
    got = ttracks.build_tracks_arrays(8, 50, edges, 2)
    monkeypatch.setattr(ttracks, "union_find_roots", ttracks.union_find_roots_plain)
    ref = ttracks.build_tracks_arrays(8, 50, edges, 2)
    assert got[3] == ref[3]
    for a, b in zip(got[:3], ref[:3]):
        np.testing.assert_array_equal(a, b)


def test_build_rules(tmp_path, monkeypatch):
    """The library lands in the build directory, a newer source rebuilds
    it, and a failed build raises instead of falling back to Python."""
    src = tmp_path / "tracks.cpp"
    src.write_text(native.SRC.read_text())
    monkeypatch.setattr(native, "SRC", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "LIB_PATH", tmp_path / "_build" / "libsfd2_tracks.so")
    monkeypatch.setattr(native, "_lib", None)
    roots = native.union_find_roots(4, np.array([[0, 1], [2, 3], [1, 3]]))
    np.testing.assert_array_equal(roots, [0, 0, 0, 0])
    built = native.LIB_PATH.stat().st_mtime_ns
    os.utime(src, ns=(built + 10**9, built + 10**9))  # the source is newer
    monkeypatch.setattr(native, "_lib", None)
    native.get_lib()
    assert native.LIB_PATH.stat().st_mtime_ns > built

    src.write_text("this is not C++\n")
    os.utime(src, ns=(built + 10**10, built + 10**10))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.union_find_roots(4, np.array([[0, 1]]))
