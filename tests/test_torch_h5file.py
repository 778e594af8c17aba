"""``sfd2_torch/io/h5file.py`` against h5py, the independent reader and
writer: files cross both ways with bit-identical arrays and equal names, at
5,000+ groups in one parent (multi-level group B-trees), after appends and
overwrites by either side; unsupported files raise the named error."""

import ast
import os
import threading
from pathlib import Path

import h5py
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from sfd2_torch.io import h5file
from sfd2_torch.io.feature_store import FeatureStore, ImageFeatures, MatchStore

DTYPES = ["float32", "float16", "float64", "int8", "int16", "int32", "int64",
          "uint8", "uint16", "uint32", "uint64"]
NAMES = ["db/1.jpg", "db/2.jpg", "query/night/x.jpg", "query/day/y.png",
         "db-1.jpg_db-2.jpg", "query-night-x.jpg_db-1.jpg", "a", "Z9"]
DATASETS = ["keypoints", "descriptors", "scores", "image_size", "matches0",
            "matching_scores0"]


def h5py_tree(path) -> dict:
    """{dataset path: array} and the group paths, by h5py's walk."""
    out, groups = {}, []

    def walk(group, prefix):
        for k, v in group.items():
            full = f"{prefix}/{k}" if prefix else k
            if isinstance(v, h5py.Group):
                groups.append(full)
                walk(v, full)
            else:
                out[full] = v[()]

    with h5py.File(path, "r") as f:
        walk(f, "")
    return out, groups


def port_tree(path) -> tuple:
    out, groups = {}, []

    def walk(group, prefix):
        for k, v in group.items():
            full = f"{prefix}/{k}" if prefix else k
            if isinstance(v, h5file.Group):
                groups.append(full)
                walk(v, full)
            else:
                out[full] = v[()]

    with h5file.File(path, "r") as f:
        walk(f, "")
    return out, groups


def assert_same_tree(a, b):
    (da, ga), (db, gb) = a, b
    assert ga == gb
    assert list(da) == list(db)
    for k in da:
        assert da[k].dtype == db[k].dtype and da[k].shape == db[k].shape, k
        assert da[k].tobytes() == db[k].tobytes(), k


@st.composite
def trees(draw):
    """{group name: {dataset name: array}} with every store dtype, 1-D and
    2-D shapes and zero-element arrays."""
    out = {}
    for name in draw(st.lists(st.sampled_from(NAMES), min_size=1, max_size=5, unique=True)):
        members = {}
        for ds in draw(st.lists(st.sampled_from(DATASETS), min_size=1, max_size=3, unique=True)):
            dtype = np.dtype(draw(st.sampled_from(DTYPES)))
            shape = tuple(draw(st.lists(st.integers(0, 9), min_size=1, max_size=2)))
            seed = draw(st.integers(0, 2**32 - 1))
            raw = np.random.default_rng(seed).integers(0, 256, int(np.prod(shape)) * dtype.itemsize,
                                                       dtype=np.uint8)
            members[ds] = raw.view(dtype).reshape(shape)  # any bits, NaNs included
        out[name] = members
    return out


def write_tree(f, tree):
    for name, members in tree.items():
        grp = f.create_group(name)
        for ds, arr in members.items():
            grp.create_dataset(ds, data=arr)


SETTINGS = settings(max_examples=40, deadline=None,
                    suppress_health_check=[HealthCheck.function_scoped_fixture])


@pytest.mark.parametrize("writer", ["port", "h5py"])
@SETTINGS
@given(tree=trees())
def test_round_trip_both_ways(tmp_path_factory, writer, tree):
    path = tmp_path_factory.mktemp("rt") / "t.h5"
    with (h5file.File(path, "w") if writer == "port" else h5py.File(path, "w")) as f:
        write_tree(f, tree)
    ref, got = h5py_tree(path), port_tree(path)
    assert_same_tree(got, ref)
    for name, members in tree.items():
        for ds, arr in members.items():
            assert ref[0][f"{name}/{ds}"].tobytes() == arr.tobytes()
    with h5file.File(path) as f:
        assert f.keys() == sorted({n.split("/")[0] for n in tree})


def pair_name(i: int, n: int) -> str:
    return f"q{i * 7919 % n:05d}.jpg_db{i:05d}.jpg"


def many_groups(f, n):
    for i in range(n):
        f.create_group(pair_name(i, n)).create_dataset("matches0", data=np.array([i, -1], np.int32))


@pytest.mark.parametrize("writer", ["port", "h5py"])
def test_5000_groups_in_one_parent(tmp_path, writer):
    path = tmp_path / "big.h5"
    n = 5200
    with (h5file.File(path, "w") if writer == "port" else h5py.File(path, "w")) as f:
        many_groups(f, n)
    with h5file.File(path) as f:
        names = f.keys()
        assert len(names) == n and names == sorted(names)
        with h5py.File(path, "r") as g:
            assert names == list(g.keys())
            for name in names[::97]:
                assert f[name]["matches0"][()].tobytes() == g[name]["matches0"][()].tobytes()
    if writer == "port":  # the B-tree has more than one level
        data, levels = path.read_bytes(), set()
        pos = data.find(b"TREE")
        while pos >= 0:
            levels.add(data[pos + 5])
            pos = data.find(b"TREE", pos + 1)
        assert max(levels) >= 1


def appended(path, opener):
    """Add groups, overwrite one, unlink one, add a nested dataset."""
    with opener(path, "a") as f:
        for i in range(40):
            f.create_group(f"new{i:03d}").create_dataset("matches0", data=np.arange(i, dtype=np.int32))
        del f[pair_name(0, 300)]
        f.create_group(pair_name(0, 300)).create_dataset(
            "matches0", data=np.array([5, 6, 7], np.int32))
        del f[pair_name(1, 300)]
        f.create_dataset("db/deep/x.jpg/scores", data=np.linspace(0, 1, 5, dtype=np.float32))


@pytest.mark.parametrize("first", ["port", "h5py"])
@pytest.mark.parametrize("appender", ["port", "h5py"])
def test_append_and_overwrite(tmp_path, first, appender):
    path = tmp_path / "a.h5"
    with (h5file.File(path, "w") if first == "port" else h5py.File(path, "w")) as f:
        many_groups(f, 300)
    appended(path, h5file.File if appender == "port" else h5py.File)
    ref, got = h5py_tree(path), port_tree(path)
    assert_same_tree(got, ref)
    assert ref[0][f"{pair_name(0, 300)}/matches0"].tolist() == [5, 6, 7]
    assert f"{pair_name(1, 300)}/matches0" not in ref[0]
    assert ref[0][f"{pair_name(2, 300)}/matches0"].tolist() == [2, -1]
    assert len([g for g in ref[1] if "/" not in g]) == 300 + 40 - 1 + 1  # + "db"


def test_port_file_survives_a_killed_writer(tmp_path):
    """Until flush() or close(), the superblock points at the last flushed
    tree: a writer that dies leaves that tree."""
    path = tmp_path / "k.h5"
    with h5file.File(path, "w") as f:
        f.create_dataset("db/a/x", data=np.arange(3))
    f = h5file.File(path, "a")
    f.create_dataset("db/b/x", data=np.arange(4))
    f._flush_pending()  # the data reaches the file, the metadata does not
    f.flush()
    f.create_dataset("db/c/x", data=np.arange(5))
    f._flush_pending()
    os.close(f._fd)  # dies here: no close()
    f._fd = None
    ref, got = h5py_tree(path), port_tree(path)
    assert_same_tree(got, ref)
    assert sorted(ref[0]) == ["db/a/x", "db/b/x"]


def test_zero_keypoint_image_reads_back_empty(tmp_path):
    for path, opener in ((tmp_path / "h.h5", h5py.File), (tmp_path / "p.h5", h5file.File)):
        with opener(path, "w") as f:
            f.create_dataset("db/e.jpg/keypoints", data=np.zeros((0, 2), np.float32))
            f.create_dataset("db/e.jpg/descriptors", data=np.zeros((128, 0), np.float32))
            f.create_dataset("db/e.jpg/scores", data=np.zeros(0, np.float32))
        with FeatureStore(path) as store:
            feats = store.read("db/e.jpg")
            assert feats.keypoints.shape == (0, 2) and feats.descriptors.shape == (0, 128)
            kp, de, sc, va = store.read_padded("db/e.jpg", 8)
            assert not va.any() and de.shape == (8, 128)


def test_store_restarts_a_stub_and_keeps_a_valid_file(tmp_path):
    stub = tmp_path / "stub.h5"
    stub.write_bytes(b"\x00" * 100)  # a killed writer's leftovers, no signature
    with FeatureStore(stub, "a") as store:
        store.write("x.jpg", ImageFeatures(np.ones((2, 2), np.float32), np.ones((2, 4), np.float32),
                                           np.ones(2, np.float32), None))
    with FeatureStore(stub, "r") as store:
        assert store.keys() == ["x.jpg"]
    # A valid HDF5 file this module cannot read is never deleted: it raises.
    valid = tmp_path / "latest.h5"
    with h5py.File(valid, "w", libver="latest") as f:
        f.create_dataset("m/matches0", data=np.arange(3))
    size = valid.stat().st_size
    for mode in ("a", "r"):
        with pytest.raises(h5file.H5FileError, match="superblock version"):
            MatchStore(valid, mode)
    assert valid.stat().st_size == size
    with h5py.File(valid, "r") as f:
        assert f["m/matches0"][()].tolist() == [0, 1, 2]
    with pytest.raises(OSError):
        FeatureStore(tmp_path / "stub2.h5", "r")  # "r" never creates


def test_unsupported_files_raise_the_named_error(tmp_path):
    chunked = tmp_path / "chunked.h5"
    with h5py.File(chunked, "w") as f:
        f.create_dataset("g/x", data=np.arange(1000, dtype=np.float32), chunks=(100,),
                         compression="gzip")
        f.create_dataset("g/plain", data=np.arange(4))
    with h5file.File(chunked) as f:
        assert f["g/plain"][()].tolist() == [0, 1, 2, 3]  # the rest still reads
        with pytest.raises(h5file.H5FileError, match=r"chunked\.h5.*(filter|chunked)"):
            f["g/x"][()]
    latest = tmp_path / "latest.h5"
    with h5py.File(latest, "w", libver="latest") as f:
        f.create_dataset("x", data=np.arange(3))
    with pytest.raises(h5file.H5FileError, match=r"latest\.h5: superblock version"):
        h5file.File(latest)
    vlen = tmp_path / "vlen.h5"
    with h5py.File(vlen, "w") as f:
        f.create_dataset("s", data=np.array([b"a", b"bc"], dtype=object),
                         dtype=h5py.string_dtype())
    with h5file.File(vlen) as f, pytest.raises(h5file.H5FileError, match="datatype"):
        f["s"][()]
    with pytest.raises(TypeError):
        with h5file.File(tmp_path / "b.h5", "w") as f:
            f.create_dataset("b", data=np.ones(3, bool))
    linked = tmp_path / "soft.h5"
    with h5py.File(linked, "w") as f:
        f.create_dataset("g/x", data=np.arange(3))
        f["g/alias"] = h5py.SoftLink("/g/x")
    with h5file.File(linked) as f, pytest.raises(h5file.H5FileError, match="symbolic link"):
        f["g/alias"]
    with pytest.raises(h5file.H5FileError, match="symbolic link"):
        with h5file.File(linked, "a") as f:
            f.create_dataset("g/y", data=np.arange(2))  # the group must be rewritten
    with h5py.File(linked, "r") as f:  # the failed close left the file as it was
        assert sorted(f["g"].keys()) == ["alias", "x"]


def test_a_user_block_file_is_refused_and_kept(tmp_path):
    path = tmp_path / "ub.h5"
    with h5py.File(path, "w", userblock_size=512) as f:
        f.create_dataset("m/matches0", data=np.arange(3))
    assert h5file.is_hdf5(path)
    with pytest.raises(h5file.H5FileError, match="no signature at byte 0"):
        MatchStore(path, "a")
    with h5py.File(path, "r") as f:
        assert f["m/matches0"][()].tolist() == [0, 1, 2]


def test_concurrent_readers_share_one_file(tmp_path):
    path = tmp_path / "f.h5"
    rng = np.random.default_rng(0)
    feats = {f"db/{i}.jpg": ImageFeatures(rng.random((50, 2), np.float32),
                                          rng.random((50, 16), np.float32),
                                          rng.random(50, np.float32), np.array([640, 480]))
             for i in range(24)}
    with FeatureStore(path, "w") as store:
        for name, f in feats.items():
            store.write(name, f)
    errors = []
    with FeatureStore(path, "r") as store:
        def work(k):
            try:
                for name in list(feats)[k::2] * 3:
                    got = store.read(name)
                    assert np.array_equal(got.descriptors, feats[name].descriptors)
            except AssertionError as exc:  # pragma: no cover - reported below
                errors.append(exc)

        threads = [threading.Thread(target=work, args=(k % 2,)) for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads) and not errors


def test_module_imports_only_numpy_and_the_standard_library():
    import sys

    tree = ast.parse(Path(h5file.__file__).read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            roots.add((node.module or "").split(".")[0])
    roots.discard("__future__")
    assert roots - {"numpy"} <= set(sys.stdlib_module_names), roots
