"""The port's localizer front end against the JAX package's.

The disk scene of ``tests/test_localizer_cli.py`` (5 DB images, 2 queries,
a COLMAP model, an HDF5 feature store and the query, retrieval and
ground-truth lists) goes through both ``run`` functions and both CLIs,
the port's with ``device="cpu"``. RANSAC draws other hypotheses in the
two packages (``torch.Generator`` against ``jax.random``), so poses agree
to the engine tests' noise floor (0.05°, 0.01 m,
``tests/test_torch_localization.py``); recall, the failed list and the
result names are identical. The pose helpers of ``geometry/pose.py`` are
held to the JAX ones in float64 (1e-12), the parsers and name mangling
exactly.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_localizer_cli import disk_scene  # noqa: F401  (module fixture)

from sfd2_torch.cli import localizer as t_cli
from sfd2_torch.geometry import pose as tpose
from sfd2_torch.geometry.np_pose import pose_error
from sfd2_torch.localization import localizer as tloc
from sfd2_torch.localization.engine import LocalizerConfig
from sfd2_torch.utils import profiling
from sfd2_tpu.cli import localizer as j_cli
from sfd2_tpu.geometry import pose as jpose
from sfd2_tpu.localization import engine as jengine
from sfd2_tpu.localization import localizer as jloc

torch.set_num_threads(2)

KNOBS = dict(ransac_thresh=8.0, opt_thresh=8.0, inlier_thresh=10, covisibility_frame=5,
             iters=2, radius=12.0, obs_thresh=2, max_keypoints=512, num_hypotheses=512)


def _poses(path):
    out = {}
    for line in path.read_text().splitlines():
        name, *vals = line.split(" ")
        out[name] = np.array(vals, float)
    return out


def _close_poses(port, ref, rot_deg=0.05, t_m=0.01):
    assert list(port) == list(ref)
    for name in port:
        a, b = port[name], ref[name]
        q_err, t_err = pose_error(a[:4], a[4:], b[:4], b[4:])
        assert q_err < rot_deg and t_err < t_m, (name, q_err, t_err)


@pytest.mark.parametrize("dataset", ["aachen", "aachen_v1.1", "robotcar", "ecmu", "generic"])
def test_result_name_matches_jax(dataset):
    names = ["query/day/x.jpg", "images/rear/123.jpg"]
    if dataset != "robotcar":  # RobotCar names carry a camera directory
        names.append("img_c0_123.jpg")
    for q in names:
        assert tloc.result_name(q, dataset) == jloc.result_name(q, dataset)


def test_load_gt_poses_matches_jax(disk_scene):  # noqa: F811
    base, _, _ = disk_scene
    a, b = tloc.load_gt_poses(base / "gt.txt"), jloc.load_gt_poses(base / "gt.txt")
    assert list(a) == list(b) == ["q0.jpg", "q1.jpg"]
    for k in a:
        for f in ("qvec", "tvec"):
            np.testing.assert_array_equal(a[k][f], b[k][f])


def test_ecmu_query_parser_matches_jax(tmp_path):
    from sfd2_torch.io.pairs import parse_img_lists_for_extended_cmu_seasons as tparse
    from sfd2_tpu.io.pairs import parse_img_lists_for_extended_cmu_seasons as jparse

    lst = tmp_path / "test-images-slice7.txt"
    lst.write_text("img_00122_c0_1303398475046031us.jpg\nimg_00123_c1_1303398475546123us.jpg\n")
    a, b = tparse(lst), jparse(lst)
    assert len(a) == len(b) == 2
    for (na, (ma, wa, ha, pa)), (nb, (mb, wb, hb, pb)) in zip(a, b):
        assert (na, ma, wa, ha) == (nb, mb, wb, hb)
        np.testing.assert_array_equal(pa, pb)


@pytest.mark.parametrize("init_type", ["sng", "clu"])
def test_run_matches_jax(disk_scene, init_type):  # noqa: F811
    base, fpath, model_dir = disk_scene
    out = {}
    for name, mod, engine_mod, kw in (("port", tloc, None, {"device": "cpu"}),
                                      ("jax", jloc, jengine, {})):
        cfg_cls = LocalizerConfig if engine_mod is None else engine_mod.LocalizerConfig
        run_cfg = mod.LocalizerRun(dataset="aachen_v1.1", init_type=init_type,
                                   config=cfg_cls(**KNOBS))
        res = base / f"run_{init_type}_{name}" / "poses.txt"
        stats = mod.run("aachen_v1.1", model_dir, base / "queries.txt", base / "retrieval.txt",
                        fpath, res, run_cfg, gt_pose_path=base / "gt.txt", **kw)
        out[name] = stats, res
    (st, rt), (sj, rj) = out["port"], out["jax"]
    assert st["recall"] == sj["recall"] == [1.0, 1.0, 1.0]
    assert {k: st[k] for k in ("num_queries", "num_localized", "num_failed", "num_gt")} == \
        {k: sj[k] for k in ("num_queries", "num_localized", "num_failed", "num_gt")}
    _close_poses(_poses(rt), _poses(rj))
    assert (rt.parent / "poses.txt.failed").read_text() == \
        (rj.parent / "poses.txt.failed").read_text()
    assert (rt.parent / "poses_full.log").exists()


def test_localizer_cli_matches_jax(disk_scene, tmp_path):  # noqa: F811
    base, fpath, model_dir = disk_scene
    common = ["--dataset", "aachen_v1.1", "--reference_sfm", model_dir, "--queries",
              base / "queries.txt", "--retrieval", base / "retrieval.txt", "--features", fpath,
              "--gt_pose_fn", base / "gt.txt", "--ransac_thresh", "8", "--opt_thresh", "8",
              "--covisibility_frame", "5", "--iters", "2", "--radius", "12", "--obs_thresh",
              "2", "--max_keypoints", "512"]
    common = [str(a) for a in common]
    st = t_cli.main(common + ["--results", str(tmp_path / "port" / "poses.txt"),
                              "--device", "cpu", "--profile_dir", str(tmp_path / "trace")])
    j_cli.main(common + ["--results", str(tmp_path / "jax" / "poses.txt")])
    assert st["recall"] == [1.0, 1.0, 1.0]
    _close_poses(_poses(tmp_path / "port" / "poses.txt"), _poses(tmp_path / "jax" / "poses.txt"))
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert trace["traceEvents"], "the profiler trace holds no event"


def test_localize_sfm_matches_jax(disk_scene, tmp_path):  # noqa: F811
    base, fpath, model_dir = disk_scene
    args = (model_dir, base / "queries.txt", base / "retrieval.txt", fpath)
    st = tloc.localize_sfm(*args, tmp_path / "port.txt", ransac_thresh=8.0, device="cpu")
    sj = jloc.localize_sfm(*args, tmp_path / "jax.txt", ransac_thresh=8.0)
    assert st["num_localized"] == sj["num_localized"] == 2
    _close_poses(_poses(tmp_path / "port.txt"), _poses(tmp_path / "jax.txt"))


def test_missing_query_features_marks_failed(disk_scene):  # noqa: F811
    """A query absent from the store gets the top retrieved frame's pose
    and is listed as failed, as in the JAX package."""
    base, fpath, model_dir = disk_scene
    q2 = base / "queries_extra_port.txt"
    q2.write_text((base / "queries.txt").read_text()
                  + "query/day/missing.jpg PINHOLE 640 480 500 500 320 240\n")
    r2 = base / "retrieval_extra_port.txt"
    r2.write_text((base / "retrieval.txt").read_text() + "query/day/missing.jpg db/0001.jpg\n")
    cfg = tloc.LocalizerRun(config=LocalizerConfig(max_keypoints=512, num_hypotheses=256,
                                                   ransac_thresh=8.0))
    stats = tloc.run("aachen_v1.1", model_dir, q2, r2, fpath, base / "out_port" / "poses.txt",
                     cfg, gt_pose_path=base / "gt.txt", device="cpu")
    assert (stats["num_queries"], stats["num_localized"], stats["num_failed"]) == (3, 3, 1)
    assert stats["recall"] == [1.0, 1.0, 1.0]
    assert "missing.jpg" in (base / "out_port" / "poses.txt.failed").read_text()


def _pose_inputs(seed, n=16):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(2, n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t = rng.normal(size=(2, n, 3)) * 3
    return q, t


@pytest.mark.parametrize("fn", ["invert_pose", "camera_center", "pose_error"])
def test_pose_helpers_match_jax_float64(fn):
    q, t = _pose_inputs(3)
    if fn == "pose_error":
        targs = [torch.from_numpy(a) for a in (q[0], t[0], q[1], t[1])]
        jargs = [q[0], t[0], q[1], t[1]]
    else:
        targs = [torch.from_numpy(q[0]), torch.from_numpy(t[0])]
        jargs = [q[0], t[0]]
    with jax.enable_x64(True):
        got, ref = getattr(tpose, fn)(*targs), getattr(jpose, fn)(*[jnp.asarray(a) for a in jargs])
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for a, b in zip(got, ref):
        assert a.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-12)


def test_recall_at_thresholds_matches_jax():
    rng = np.random.default_rng(4)
    q_err, t_err = rng.uniform(0, 12, 200), rng.uniform(0, 6, 200)
    got = tpose.recall_at_thresholds(torch.from_numpy(q_err), torch.from_numpy(t_err))
    with jax.enable_x64(True):
        ref = jpose.recall_at_thresholds(jnp.asarray(q_err), jnp.asarray(t_err))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref, np.float32))


def test_stage_timer_and_device_time(tmp_path):
    timer = profiling.StageTimer()
    for _ in range(3):
        with timer.stage("a"):
            pass
    timer.dump(tmp_path / "t.json")
    summary = json.loads((tmp_path / "t.json").read_text())
    assert summary["a"]["count"] == 3 and summary["a"]["total_s"] >= 0
    calls = []
    assert profiling.device_time(lambda x: calls.append(x) or x, 1, iters=5) >= 0
    assert len(calls) == 6  # one warm-up, five timed
