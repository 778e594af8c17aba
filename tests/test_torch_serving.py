"""The port's serving stack on the CPU: the engine's throughput paths
(``localize_many``, ``localize_throughput``, ``_batched_match``,
``inject_db_features``), ``LocalizationService`` behind ``make_server``, and
``cli/serve.py`` — ports of ``tests/test_serving.py``, plus the JAX engine's
``localize_throughput`` on a scene drawn from the same seed.

``localize_many`` must be bit-identical to the sequential loop;
``localize_throughput`` draws its hypotheses per query from ``fold_seed``
generators, so it is held to the sequential sources and to poses within
0.5° / 0.1 m of the truth.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from sfd2_torch.cli import serve as cli_serve
from sfd2_torch.geometry.np_pose import pose_error
from sfd2_torch.io.colmap_model import write_model
from sfd2_torch.io.feature_store import FeatureStore
from sfd2_torch.localization import graphs
from sfd2_torch.localization.engine import LocalizationEngine, LocalizerConfig
from sfd2_torch.localization.graphs import program_key
from sfd2_torch.serving import server as server_mod
from sfd2_torch.serving.server import LocalizationService, make_server
from sfd2_torch.utils import profiling
from sfd2_torch.utils.synth import build_corridor_scene
from sfd2_tpu.io.feature_store import FeatureStore as JFeatureStore
from sfd2_tpu.localization import engine as jengine
from sfd2_tpu.utils.synth import build_corridor_scene as jbuild_corridor_scene

torch.set_num_threads(2)

SCENE = dict(n_images=20, n_queries=3, n_points=1200, kp_per_image=400, kp_per_query=350,
             retrieval_k=6, seed=5)
CFG = dict(ransac_thresh=8.0, opt_thresh=8.0, inlier_thresh=10, covisibility_frame=6, iters=2,
           radius=12.0, obs_thresh=3, max_keypoints=512, num_hypotheses=512)


@pytest.fixture(scope="module")
def served_scene():
    store = FeatureStore()
    scene = build_corridor_scene(store, **SCENE)
    service = LocalizationService(scene.map_index, store, LocalizerConfig(**CFG), device="cpu")
    warm_s = service.warmup()
    server = make_server(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield scene, store, service, server, warm_s
    server.shutdown()
    server.server_close()
    thread.join(timeout=30)


def _url(server, path):
    return f"http://{server.server_address[0]}:{server.server_address[1]}{path}"


def _post(server, path, body, raw=None):
    data = raw if raw is not None else json.dumps(body).encode()
    req = urllib.request.Request(_url(server, path), data, {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _body(scene, qi=0):
    qname, _, _, near = scene.queries[qi]
    return {"query_name": qname, "db_ids": [int(i) for i in near],
            "camera": {"model": scene.cam_model, "width": scene.width, "height": scene.height,
                       "params": scene.cam_params}}


def _jobs(scene):
    return [(qname, scene.qinfo, [[int(i)] for i in near]) for qname, _, _, near in scene.queries]


def test_healthz_and_localize(served_scene):
    scene, _, service, server, warm_s = served_scene
    with urllib.request.urlopen(_url(server, "/healthz"), timeout=30) as r:
        health = json.loads(r.read())
    assert health["ok"] and health["images"] == 20 and health["points3d"] > 0
    _, q_gt, t_gt, near = scene.queries[0]
    code, res = _post(server, "/localize", _body(scene))
    assert code == 200, res
    assert res["source"] == "accepted"
    qe, te = pose_error(np.array(res["qvec"]), np.array(res["tvec"]), q_gt, t_gt)
    assert qe < 0.5 and te < 0.1, (qe, te)
    assert warm_s > 0.0 and res["ms"] > 0.0
    # The engine gives the same answer directly.
    direct = service.engine.localize(*_jobs(scene)[0])
    assert res["qvec"] == [float(v) for v in direct.qvec]
    assert res["num_inliers"] == direct.num_inliers
    # Addressing by names resolves to the same frames.
    body = _body(scene)
    body["db_names"] = [scene.map_index.images[i].name for i in body.pop("db_ids")]
    code2, res2 = _post(server, "/localize", body)
    assert code2 == 200 and res2["qvec"] == res["qvec"]


def test_concurrent_requests_deterministic(served_scene):
    scene, _, _, server, _ = served_scene
    results = [None] * 4

    def go(i):
        results[i] = _post(server, "/localize", _body(scene))

    threads = [threading.Thread(target=go, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert all(r is not None and r[0] == 200 for r in results), results
    first = results[0][1]
    for _, res in results[1:]:
        assert res["qvec"] == first["qvec"] and res["tvec"] == first["tvec"]
        assert res["num_inliers"] == first["num_inliers"]


def test_requests_overlap_not_serialise(served_scene):
    """Up to max_concurrent requests are in flight at once: with the engine
    replaced by a sleep that returns its real answer, four simultaneous
    requests overlap."""
    scene, _, service, server, _ = served_scene
    in_flight, peak = [0], [0]
    gate = threading.Lock()
    real = service.engine.localize
    answer = real(*_jobs(scene)[0])

    def slow_localize(*a, **kw):
        with gate:
            in_flight[0] += 1
            peak[0] = max(peak[0], in_flight[0])
        time.sleep(0.25)
        with gate:
            in_flight[0] -= 1
        return answer

    service.engine.localize = slow_localize
    try:
        results = [None] * 4
        threads = [threading.Thread(target=lambda i=i: results.__setitem__(
            i, _post(server, "/localize", _body(scene)))) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        service.engine.localize = real
    assert all(r is not None and r[0] == 200 for r in results), results
    assert all(r[1]["qvec"] == [float(v) for v in answer.qvec] for r in results)
    assert peak[0] >= 2, f"requests never overlapped (peak={peak[0]})"


def test_malformed_requests_do_not_kill_server(served_scene):
    scene, _, _, server, _ = served_scene
    code, res = _post(server, "/localize", {"query_name": "nope"})
    assert code == 400 and "error" in res  # no camera: a client error
    code, res = _post(server, "/nothing", {})
    assert code == 404
    code, res = _post(server, "/localize", None, raw=b"")
    assert code == 400
    code, res = _post(server, "/localize", ["not", "an", "object"])
    assert code == 400 and "error" in res
    code, res = _post(server, "/localize", dict(_body(scene), db_ids=["x"]))
    assert code == 400
    code, res = _post(server, "/localize", _body(scene, 1))
    assert code == 200 and res["source"] == "accepted"


def test_localize_many_matches_sequential(served_scene):
    scene, _, service, _, _ = served_scene
    eng = service.engine
    jobs = _jobs(scene) + _jobs(scene)[:1]  # four jobs, one repeated
    seq = [eng.localize(*j) for j in jobs]
    par = eng.localize_many(jobs, workers=4)
    assert len(par) == len(seq)
    for a, b in zip(seq, par):
        np.testing.assert_array_equal(a.qvec, b.qvec)
        np.testing.assert_array_equal(a.tvec, b.tvec)
        assert (a.num_inliers, a.source, a.log) == (b.num_inliers, b.source, b.log)


def test_localize_throughput_matches_sequential(served_scene):
    scene, _, service, _, _ = served_scene
    eng = service.engine
    jobs = _jobs(scene)
    seq = [eng.localize(*j) for j in jobs]
    with profiling.recording() as recs:
        bat = eng.localize_throughput(jobs)
    assert len(bat) == len(seq)
    names = {r.name for r in recs}
    for phase in ("engine.query_feats", "engine.batched_match.dispatch",
                  "engine.batched_match.fetch", "engine.assemble", "engine.batched_pnp.dispatch",
                  "engine.batched_pnp.fetch", "engine.frames", "engine.refine"):
        assert phase in names, (phase, names)
    assert all(r.t1 >= r.t0 for r in recs)
    assert sum(r.tags["mb"] for r in recs if r.name == "engine.batched_match.fetch") > 0.0
    for (qname, q_gt, t_gt, _), a, b in zip(scene.queries, seq, bat):
        assert a.source == b.source == "accepted", (qname, a.source, b.source)
        qe, te = pose_error(b.qvec, b.tvec, q_gt, t_gt)
        assert qe < 0.5 and te < 0.1, (qname, qe, te)
        assert "covis refine" in b.log and "iter 1" in b.log


def test_localize_throughput_matches_jax_engine(served_scene, tmp_path):
    """One correspondence bucket (pnp_pad_floor 512) keeps JAX's compiles few."""
    scene, store, _, _, _ = served_scene
    cfg = dict(CFG, pnp_pad_floor=512)
    jscene = jbuild_corridor_scene(tmp_path / "f.h5", **SCENE)
    jobs = _jobs(scene)
    eng = LocalizationEngine(scene.map_index, store, LocalizerConfig(**cfg), device="cpu")
    bat = eng.localize_throughput(jobs)
    with JFeatureStore(jscene.feature_path, "r") as js:
        jeng = jengine.LocalizationEngine(jscene.map_index, js, jengine.LocalizerConfig(**cfg))
        ref = jeng.localize_throughput([(n, jscene.qinfo, c) for n, _, c in jobs])
    assert [r.source for r in bat] == [r.source for r in ref]
    for a, b in zip(bat, ref):
        qe, te = pose_error(a.qvec, a.tvec, b.qvec, b.tvec)
        assert qe < 0.5 and te < 0.1


def test_batched_match_chunking_matches_direct(served_scene):
    """Beyond 128 (query, bank) pairs the flattened axis is chunked; every
    query's rows equal the per-query matcher's."""
    scene, store, service, _, _ = served_scene
    eng = service.engine
    ids = [int(i) for i in list(scene.map_index.images)[:10]]
    banks = [ids * 3 for _ in range(5)]  # 5 queries × 30 banks = 150 > 128
    q_feats = [eng._query_feats(scene.queries[i % 3][0])[1:] for i in range(5)]
    with profiling.recording() as recs:
        got = eng._batched_match(q_feats, banks)
    fetched = [r.tags["mb"] for r in recs if r.name == "engine.batched_match.fetch"]
    assert got.shape == (5, 30, 512) and len(fetched) == 1 and fetched[0] > 0
    for qi in range(5):
        ref = eng._match_query_to_dbs(q_feats[qi][0], q_feats[qi][1], banks[qi])
        np.testing.assert_array_equal(got[qi], ref)
    assert (got >= 0).sum() > 1000


def _injected(scene, store, cfg, labels_of=None, dtype=torch.float32):
    """An engine with every DB bank injected from the store's rows."""
    eng = LocalizationEngine(scene.map_index, store, cfg, device="cpu")
    for iid in scene.map_index.image_ids:
        name = scene.map_index.images[int(iid)].name
        kp, desc, _, valid, labels = store.read_padded(name, cfg.max_keypoints, with_labels=True)
        eng.inject_db_features(int(iid), kp, torch.from_numpy(desc).to(dtype), valid,
                               labels if labels_of is None else labels_of(labels))
    return eng


def test_inject_db_features_matches_store_path_and_survives_a_small_lru(served_scene):
    scene, store, service, _, _ = served_scene
    cfg = LocalizerConfig(**dict(CFG, db_cache_images=2))  # 20 banks injected
    eng = _injected(scene, store, cfg)
    jobs = _jobs(scene)
    for job, ref in zip(jobs, [service.engine.localize(*j) for j in jobs]):
        got = eng.localize(*job)
        np.testing.assert_array_equal(got.qvec, ref.qvec)
        assert (got.num_inliers, got.source) == (ref.num_inliers, ref.source)
    assert not eng._db_dev_cache and not eng._db_cache  # pinned, outside the LRU
    iid = int(scene.map_index.image_ids[0])
    assert eng._db_feats(iid)[1] is None and eng._db_feats_dev(iid)[0].shape == (512, 64)
    _, kq, _, vq, _ = store.read_padded(scene.queries[0][0], 512, with_labels=True)
    near = scene.queries[0][3]
    np.testing.assert_array_equal(
        eng._match_query_to_dbs(torch.from_numpy(kq), torch.from_numpy(vq), near),
        service.engine._match_query_to_dbs(torch.from_numpy(kq), torch.from_numpy(vq), near))


def test_inject_db_features_casts_to_one_bank_dtype(served_scene):
    """A bf16 bank injected beside store-fed banks is cast to float32, the
    dtype of every bank; the round's banks stack into one launch."""
    scene, store, service, _, _ = served_scene
    eng = LocalizationEngine(scene.map_index, store, LocalizerConfig(**CFG), device="cpu")
    near = scene.queries[0][3]
    for iid in near[::2]:  # every other retrieved bank injected as bf16
        kp, desc, _, valid = store.read_padded(scene.map_index.images[iid].name, 512)
        eng.inject_db_features(iid, kp, torch.from_numpy(desc).to(torch.bfloat16), valid)
    assert {eng._db_feats_dev(i)[0].dtype for i in near} == {torch.float32}
    assert eng._dev_zero(64)[0].dtype == torch.float32
    res = eng.localize(*_jobs(scene)[0])
    ref = service.engine.localize(*_jobs(scene)[0])
    assert res.source == ref.source == "accepted"
    qe, te = pose_error(res.qvec, res.tvec, ref.qvec, ref.tvec)
    assert qe < 0.5 and te < 0.05  # bf16 rounding may flip a borderline match


def test_inject_db_features_keeps_labels_under_nnml(served_scene):
    scene, store, _, _, _ = served_scene
    rng = np.random.default_rng(0)
    labelled = FeatureStore()
    for name in store.keys():
        f = store.read(name)
        labelled.write(name, f._replace(labels=rng.integers(0, 3, len(f.keypoints))))
    cfg = LocalizerConfig(**dict(CFG, matcher="nnml"))
    ref = LocalizationEngine(scene.map_index, labelled, cfg, device="cpu")
    eng = _injected(scene, labelled, cfg)
    blind = _injected(scene, labelled, cfg, labels_of=np.zeros_like)
    iid = int(scene.map_index.image_ids[3])
    _, _, _, _, want = labelled.read_padded(scene.map_index.images[iid].name, 512,
                                            with_labels=True)
    np.testing.assert_array_equal(eng._db_feats(iid)[4], want)
    np.testing.assert_array_equal(eng._db_feats_dev(iid)[2].numpy(), want)
    kq, dq, vq, lq = ref._query_feats(scene.queries[0][0])
    near = scene.queries[0][3]
    m_ref = ref._match_query_to_dbs(dq, vq, near, lq)
    np.testing.assert_array_equal(eng._match_query_to_dbs(dq, vq, near, lq), m_ref)
    assert not np.array_equal(blind._match_query_to_dbs(dq, vq, near, lq), m_ref)
    with pytest.raises(ValueError, match="labels"):
        LocalizationEngine(scene.map_index, labelled, cfg, device="cpu").inject_db_features(
            iid, np.zeros((512, 2)), torch.zeros(512, 64), np.ones(512, bool))
    with pytest.raises(ValueError, match=r"\[512, C\]"):
        eng.inject_db_features(iid, np.zeros((512, 2)), torch.zeros(100, 64),
                               np.ones(512, bool), np.zeros(512))


def test_cli_serve_help_and_arguments():
    import subprocess
    import sys

    out = subprocess.run([sys.executable, "-m", "sfd2_torch.cli.serve", "--help"],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "--pnp_pad_floor" in out.stdout and "--device" in out.stdout
    args = cli_serve.parse_args(["--reference_sfm", "m", "--features", "f.h5", "--iters", "3",
                                 "--radius", "12", "--pnp_pad_floor", "512"])
    assert args.device == "cuda" and args.port == 8008
    cfg = cli_serve.config_from_args(args)
    assert (cfg.iters, cfg.radius, cfg.pnp_pad_floor, cfg.max_keypoints) == (3, 12.0, 512, 4096)
    with pytest.raises(SystemExit):
        cli_serve.parse_args(["--features", "f.h5"])  # --reference_sfm is required


def test_cli_serve_runs_on_disk_model(tmp_path, monkeypatch):
    """The CLI end to end on the CPU: read the model and an HDF5 store, warm
    up, serve /healthz and one /localize, stop."""
    with FeatureStore(tmp_path / "f.h5", "w") as fs:
        scene = build_corridor_scene(fs, **dict(SCENE, n_queries=1))
    mi = scene.map_index
    write_model(mi.cameras, mi.images, mi.points3d, tmp_path / "model")
    seen = {}

    def make(service, host, port):
        srv = server_mod.make_server(service, host, 0)
        run = srv.serve_forever

        def once():
            thread = threading.Thread(target=run, daemon=True)
            thread.start()
            with urllib.request.urlopen(_url(srv, "/healthz"), timeout=30) as r:
                seen["health"] = json.loads(r.read())
            seen["localize"] = _post(srv, "/localize", _body(scene))
            srv.shutdown()
            thread.join(timeout=30)

        srv.serve_forever = once
        return srv

    monkeypatch.setattr(cli_serve, "make_server", make)
    cli_serve.main(["--reference_sfm", str(tmp_path / "model"), "--features",
                    str(tmp_path / "f.h5"), "--device", "cpu", "--max_keypoints", "512",
                    "--ransac_thresh", "8", "--opt_thresh", "8", "--covisibility_frame", "6",
                    "--iters", "2", "--radius", "12", "--pnp_pad_floor", "512"])
    assert seen["health"]["images"] == 20
    code, res = seen["localize"]
    assert code == 200 and res["source"] == "accepted"


WARM_SCENE = dict(n_images=60, n_queries=2, n_points=3000, kp_per_image=256, kp_per_query=256,
                  retrieval_k=50, seed=7)
WARM_CFG = dict(CFG, covisibility_frame=50, max_keypoints=256, pnp_pad_floor=64,
                num_hypotheses=128)


def test_warmup_covers_a_request_of_the_retrieval_size(monkeypatch):
    """A fresh service after ``warmup()``: a request with the scene's 50
    retrieved frames runs no program at a padded shape (PnP-RANSAC's or the
    refinement's correspondence bucket) and no matcher launch at a frame
    bucket that the warm-up did not already run; on the card each new
    program key is a graph capture inside the request. The reference's
    4-singleton warm-up leaves the request's buckets to the request."""
    store = FeatureStore()
    scene = build_corridor_scene(store, **WARM_SCENE)
    service = LocalizationService(scene.map_index, store, LocalizerConfig(**WARM_CFG),
                                  device="cpu")
    programs, frame_buckets = set(), set()
    run = graphs.run

    def recorded(program):
        programs.add(program_key(program))
        return run(program)

    monkeypatch.setattr(graphs, "run", recorded)
    matcher = service.engine._matcher

    def recorded_matcher(d0, *args):
        frame_buckets.add(d0.shape[0])
        return matcher(d0, *args)

    service.engine._matcher = recorded_matcher
    misses = profiling.counter("engine.bank_misses")  # bank uploads from the store
    service.warmup()
    warm_programs, warm_frames = set(programs), set(frame_buckets)
    uploads = profiling.counter("engine.bank_misses") - misses
    for qi in range(len(scene.queries)):
        qname, q_gt, t_gt, near = scene.queries[qi]
        assert len(near) == 50
        res = service.localize(_body(scene, qi))
        assert res["source"] == "accepted"
    assert {k[0][0] for k in programs} == {"pnp", "refine"}
    assert programs <= warm_programs, sorted(programs - warm_programs)
    assert frame_buckets <= warm_frames, sorted(frame_buckets - warm_frames)
    assert 64 in warm_frames
    # The warm-up uploaded the banks of the frames a request near the
    # first image retrieves; later requests upload the rest once.
    assert uploads >= 50
    assert profiling.counter("engine.bank_misses") - misses <= len(scene.map_index.images)


def test_warmup_without_a_frame_limit_localizes_against_four_frames():
    """``covisibility_frame`` ≤ 0 sets no frame limit, so no request size
    is known: the warm-up falls back to the reference's 4 singletons
    instead of matching every map image in one launch."""
    store = FeatureStore()
    scene = build_corridor_scene(store, **WARM_SCENE)
    service = LocalizationService(scene.map_index, store,
                                  LocalizerConfig(**dict(WARM_CFG, covisibility_frame=0)),
                                  device="cpu")
    seen, localize = [], service.engine.localize

    def recorded(qname, qinfo, clusters):
        seen.append(clusters)
        return localize(qname, qinfo, clusters)

    service.engine.localize = recorded
    service.warmup()
    assert len(seen) == 1 and len(seen[0]) == 4 and all(len(c) == 1 for c in seen[0])
