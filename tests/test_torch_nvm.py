"""The port's NVM reader and ``colmap_from_nvm`` CLI against the JAX ones.

A two-camera, two-point NVM_V3 model (camera centres, per-observation
measurements; ``tests/test_nvm_and_viz.py``) read by both readers gives
identical cameras, images and points; both CLIs write the same model
files, with and without ``--database`` ids and ``--skip_points``.
"""

import sqlite3

import numpy as np
import pytest

from sfd2_torch.cli import colmap_from_nvm as t_cli
from sfd2_torch.geometry.np_pose import camera_center
from sfd2_torch.io.colmap_model import read_model
from sfd2_torch.io.nvm import read_intrinsics_list, read_nvm_model
from sfd2_tpu.cli import colmap_from_nvm as j_cli
from sfd2_tpu.io.nvm import read_nvm_model as jread_nvm_model


@pytest.fixture
def nvm_files(tmp_path):
    intr = tmp_path / "intr.txt"
    intr.write_text("a.jpg SIMPLE_RADIAL 640 480 500 320 240 0.0\n"
                    "b.jpg SIMPLE_RADIAL 640 480 510 320 240 0.0\n"
                    "c.jpg PINHOLE 800 600 700 710 400 300\n")
    q = np.array([0.9, 0.1, 0.2, 0.05])
    q /= np.linalg.norm(q)
    nvm = tmp_path / "model.nvm"
    nvm.write_text(
        "NVM_V3\n\n3\n"
        f"a.jpg 500 {q[0]} {q[1]} {q[2]} {q[3]} 1.0 2.0 3.0 0 0\n"
        "b.jpg 510 1 0 0 0 0 0 0 0 0\n"
        "c.jpg 700 0.8 0 0.6 0 -1 0.5 2 0 0\n\n"
        "3\n"
        "1.0 2.0 9.0 255 0 0 2 0 3 10.5 20.5 1 1 30.0 40.0\n"
        "-1.0 0.5 8.0 0 255 0 1 1 0 5.0 6.0\n"
        "0.5 0.5 7.0 0 0 255 3 0 0 1.5 2.5 1 4 7.0 8.0 2 2 100.0 200.0\n")
    return tmp_path, nvm, intr, q


def _same_model(a, b):
    (ca, ia, pa), (cb, ib, pb) = a, b
    assert ca.keys() == cb.keys() and ia.keys() == ib.keys() and pa.keys() == pb.keys()
    for k in ca:
        assert (ca[k].camera_id, ca[k].model, ca[k].width, ca[k].height) == \
            (cb[k].camera_id, cb[k].model, cb[k].width, cb[k].height)
        np.testing.assert_array_equal(ca[k].params, cb[k].params)
    for k in ia:
        assert (ia[k].image_id, ia[k].camera_id, ia[k].name) == \
            (ib[k].image_id, ib[k].camera_id, ib[k].name)
        for f in ("qvec", "tvec", "xys", "point3D_ids"):
            np.testing.assert_array_equal(getattr(ia[k], f), getattr(ib[k], f), err_msg=f)
    for k in pa:
        for f in ("xyz", "rgb", "image_ids", "point2D_idxs"):
            np.testing.assert_array_equal(getattr(pa[k], f), getattr(pb[k], f), err_msg=f)
        assert pa[k].error == pb[k].error


@pytest.mark.parametrize("ids", ["default", "given"])
@pytest.mark.parametrize("skip_points", [False, True])
def test_read_nvm_model_matches_jax(nvm_files, ids, skip_points):
    _, nvm, intr, q = nvm_files
    kw = dict(skip_points=skip_points)
    if ids == "given":
        kw.update(image_ids={"a.jpg": 7, "b.jpg": 3, "c.jpg": 5},
                  camera_ids={"a.jpg": 1, "b.jpg": 1, "c.jpg": 2})
    got, ref = read_nvm_model(nvm, intr, **kw), jread_nvm_model(nvm, intr, **kw)
    _same_model(got, ref)
    im_a = next(im for im in got[1].values() if im.name == "a.jpg")
    np.testing.assert_allclose(camera_center(im_a.qvec, im_a.tvec), [1.0, 2.0, 3.0], atol=1e-9)
    if not skip_points:
        assert im_a.point3D_ids[3] == 0 and len(got[2]) == 3


def test_intrinsics_list_rejects_a_wrong_parameter_count(tmp_path):
    bad = tmp_path / "intr.txt"
    bad.write_text("a.jpg PINHOLE 640 480 500 320 240\n")
    with pytest.raises(ValueError):
        read_intrinsics_list(bad)


@pytest.mark.parametrize("ext", [".bin", ".txt"])
@pytest.mark.parametrize("database", [False, True])
def test_colmap_from_nvm_cli_matches_jax(nvm_files, ext, database):
    base, nvm, intr, _ = nvm_files
    args = ["--nvm", str(nvm), "--intrinsics", str(intr), "--ext", ext]
    if database:
        db = base / "database.db"
        with sqlite3.connect(str(db)) as con:
            con.execute("CREATE TABLE images (image_id INTEGER, name TEXT, camera_id INTEGER)")
            con.executemany("INSERT INTO images VALUES (?, ?, ?)",
                            [(4, "a.jpg", 2), (9, "b.jpg", 1), (2, "c.jpg", 3)])
        args += ["--database", str(db)]
    t_cli.main(args + ["--output", str(base / "port")])
    j_cli.main(args + ["--output", str(base / "jax")])
    for name in ("cameras", "images", "points3D"):
        assert (base / "port" / f"{name}{ext}").read_bytes() == \
            (base / "jax" / f"{name}{ext}").read_bytes()
    cams, images, points = read_model(base / "port")
    assert len(cams) == 3 and len(images) == 3 and len(points) == 3
    if database:
        assert sorted(images) == [2, 4, 9]
