"""The localization service under closed-loop clients over HTTP.

Set-up, all from the seed: the corridor scene (``portbench/scene.py``)
with the configuration's DB images, query pool, keypoints and descriptor
width; the map from its ground-truth observations
(``MapIndex.from_arrays``); a feature store that holds every DB image
and query as the preset writes them; ``LocalizationService`` with the
configuration's knobs, warmed up (``warmup``: banks, PnP and refinement
graphs at every bucket), behind ``make_server``'s HTTP handler; one
request over HTTP. The store is an in-memory ``FeatureStore`` read
through the engine's bank caches at their configured size, as
``cli/serve.py`` reads its HDF5 store.

Window: ``clients`` threads, each sending its next request when the last
is answered; the queries come in a seeded order and none repeats; each
request names the query's ``retrieval_topk`` nearest DB images as
singleton clusters (``init_type sng``). Requests sent before the window
closes are waited for.

Check, once the window has closed and the service is freed: for a
sample of the answered requests drawn from the seed, with the slowest
among them, every match the engine's matcher returned for the request
(``match_gap``, ``reference/match.py``) and the pose the reply holds
against the reference pose (``pose_t_gap_m``, ``pose_r_gap_deg``,
``reference/localize.py``). The cell's limits name the numbers compared;
the others are printed beside them, with the replies' ``source`` counts.
"""

from __future__ import annotations

import collections
import gc
import http.client
import json
import threading
import time

import numpy as np
import torch

from portbench.reference.localize import correspondences, reference_pose
from portbench.reference.match import bank_valid, match_gap, similarities
from portbench.reference.pose import pose_gap
from portbench.scene import SceneSize, make_scene, map_arrays, retrieval, sub_seed
from portbench.trace import DeviceTrace, Spans

BANK_BLOCK = 8


def db_name(row: int) -> str:
    return f"db/{row:05d}.jpg"


def query_name(row: int) -> str:
    return f"query/{row:04d}.jpg"


def scene_size(config: dict) -> SceneSize:
    m = config["map"]
    return SceneSize(n_db=m["n_db"], n_q=m["n_queries"], kp=m["keypoints"],
                     c=m["descriptor_dim"], points_per_image=m["points_per_db_image"],
                     width=m["width"], height=m["height"], focal=m["focal"])


def build_service(config: dict, scene, prow, point_xyz, track_len, device):
    """The store, the map index and the service, as ``cli/serve.py`` holds them."""
    from sfd2_torch.geometry.cameras import Camera
    from sfd2_torch.io.colmap_model import Image
    from sfd2_torch.io.feature_store import FeatureStore, ImageFeatures
    from sfd2_torch.localization.engine import LocalizerConfig
    from sfd2_torch.serving.server import LocalizationService
    from sfd2_torch.sfm.map_index import MapIndex

    size = scene.size
    store = FeatureStore()
    scores = np.linspace(1.0, 0.5, size.kp, dtype=np.float32)
    wh = np.array([size.width, size.height])
    for rows, desc, kp, nv, name in ((range(size.n_db), scene.db_desc, scene.db_kp, scene.db_nv,
                                      db_name),
                                     (range(size.n_q), scene.q_desc, scene.q_kp, scene.q_nv,
                                      query_name)):
        for i in rows:
            n = int(nv[i])  # [C, n] rows are stored as they are: no copy
            store.write(name(i), ImageFeatures(kp[i, :n], desc[i][:, :n].T, scores[:n], wh))
    cameras = {1: Camera(1, "PINHOLE", size.width, size.height, np.array(size.cam_params))}
    images = {i + 1: Image(i + 1, scene.db_q[i], scene.db_t[i], 1, db_name(i),
                           np.zeros((0, 2)), None) for i in range(size.n_db)}
    mi = MapIndex.from_arrays(cameras, images, {i + 1: prow[i] for i in range(size.n_db)},
                              point_xyz, track_len)
    knobs = {k: v for k, v in config["localizer"].items()
             if k in LocalizerConfig.__dataclass_fields__}
    return LocalizationService(mi, store, LocalizerConfig(**knobs),
                               max_concurrent=config["localizer"]["max_concurrent"],
                               device=device)


def instrument(engine, spans: Spans, recorded: dict):
    """Spans around the engine's layers; every match the matcher returns,
    kept per query for the check."""
    local = threading.local()
    inner_localize = engine.localize

    def localize(qname, qinfo, clusters):
        local.q = qname
        t0 = time.perf_counter_ns()
        try:
            return inner_localize(qname, qinfo, clusters)
        finally:
            spans.add("engine.localize", t0, time.perf_counter_ns())

    engine.localize = localize
    inner_match = engine._match_query_to_dbs

    def match(q_desc, q_valid, db_ids, q_labels=None):
        t0 = time.perf_counter_ns()
        m = inner_match(q_desc, q_valid, db_ids, q_labels)
        spans.add("engine.match", t0, time.perf_counter_ns(), len(db_ids))
        recorded.setdefault(getattr(local, "q", None), []).append(
            (list(db_ids), m.astype(np.int32)))
        return m

    engine._match_query_to_dbs = match
    spans.wrap(engine, "_run_pnp", "engine.pnp")
    spans.wrap(engine, "_refine_batch", "engine.refine")


def _post(port: int, body: bytes):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("POST", "/localize", body, {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def run(ctx: dict) -> dict:
    cell, seed, seconds, device = ctx["cell"], ctx["seed"], ctx["seconds"], ctx["device"]
    config, mix = cell.config, cell.mix
    loc = config["localizer"]
    from sfd2_torch.serving.server import make_server

    stages = {"start": time.time() - ctx["t_process"]}
    size = scene_size(config)
    scene = make_scene(size, seed, device)
    stages["scene"] = time.time() - ctx["t_process"]
    prow, point_xyz, track_len = map_arrays(scene)
    stages["map_arrays"] = time.time() - ctx["t_process"]
    service = build_service(config, scene, prow, point_xyz, track_len, device)
    stages["store_and_map_index"] = time.time() - ctx["t_process"]
    spans, recorded = Spans(), {}
    instrument(service.engine, spans, recorded)
    service.warmup()
    stages["warmup"] = time.time() - ctx["t_process"]
    server = make_server(service, "127.0.0.1", 0)
    port = server.server_address[1]
    serving = threading.Thread(target=server.serve_forever, daemon=True)
    serving.start()

    retr = retrieval(scene, loc["retrieval_topk"])
    order = np.random.default_rng(sub_seed(seed, 3)).permutation(size.n_q)
    camera = {"model": "PINHOLE", "width": size.width, "height": size.height,
              "params": size.cam_params}

    def body(q):
        return json.dumps({"query_name": query_name(q), "camera": camera,
                           "db_ids": [int(r) + 1 for r in retr[q]]}).encode()

    status, _ = _post(port, body(order[-1]))  # the HTTP path, once, in set-up
    if status != 200:
        raise RuntimeError(f"warm-up request answered {status}")
    if device != "cpu":
        torch.cuda.synchronize()
    recorded.clear()

    lock = threading.Lock()
    requests = []  # (index, query, t0, t1, status, reply)
    state = {"next": 0}
    t_start = time.perf_counter()
    t_end = t_start + seconds
    setup_s = time.time() - ctx["t_process"]

    def client():
        while True:
            with lock:
                i = state["next"]
                if time.perf_counter() >= t_end or i >= len(order) - 1:
                    return
                state["next"] = i + 1
            q = int(order[i])
            t0 = time.perf_counter()
            try:
                st, data = _post(port, body(q))
            except (OSError, http.client.HTTPException) as e:
                st, data = -1, str(e).encode()
            t1 = time.perf_counter()
            with lock:
                requests.append((i, q, t0, t1, st, data))

    threads = [threading.Thread(target=client) for _ in range(mix["clients"])]
    for t in threads:
        t.start()
    trace = None
    if ctx["trace"]:
        time.sleep(seconds * mix["trace_from"])
        trace = DeviceTrace()
        trace.start()
        time.sleep(seconds * mix["trace_share"])
        trace.stop()
    for t in threads:
        t.join()
    t_closed = time.perf_counter()
    server.shutdown()
    server.server_close()
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    del service, server
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()

    requests.sort()
    answered = [r for r in requests if r[4] == 200]
    lat_ms = np.array([(r[3] - r[2]) * 1e3 for r in answered])
    e2e = {"queries_per_s": sum(1 for r in answered if r[3] <= t_end) / seconds,
           "query_ms_p95": float(np.percentile(lat_ms, 95)) if len(lat_ms) else None,
           "setup_s": setup_s}
    replies = {r[0]: json.loads(r[5]) for r in answered}

    torch.backends.cuda.matmul.allow_tf32 = False  # the reference runs in full precision
    torch.backends.cudnn.allow_tf32 = False
    t_check = time.perf_counter()
    numbers = verify(ctx, scene, prow, point_xyz, track_len, retr, answered, replies, recorded)
    numbers["setup_stages_s"] = stages
    numbers["reply_sources"] = dict(collections.Counter(r["source"] for r in replies.values()))
    numbers["check_s"] = time.perf_counter() - t_check
    layer_ctx = dict(window=(t_start, t_end, t_closed), spans=spans, requests=[
        dict(client_ms=(r[3] - r[2]) * 1e3, reply_ms=replies[r[0]]["ms"], t0=r[2], t1=r[3])
        for r in answered])
    if trace is not None:
        layer_ctx["trace"] = trace.summary(spans)
        # K2's work as the requests need it: the real DB banks of every
        # match call made in the traced part (the engine pads a call's
        # banks to a bucket with all-invalid banks, which need none).
        layer_ctx["k2_work"] = [(r[4], size.kp, size.kp, size.c) for r in spans.records
                                if r[0] == "engine.match" and r[2] >= trace.t0
                                and r[3] <= trace.t1]
    return dict(e2e=e2e, numbers=numbers, attempted=len(requests),
                failed=len(requests) - len(answered), memory_peak_bytes=int(peak),
                layer_ctx=layer_ctx, trace=layer_ctx.get("trace"))


def sample_requests(answered, seed: int, n: int) -> list:
    """A seeded sample of `n` answered requests, with the slowest in it."""
    if not answered:
        return []
    rng = np.random.default_rng(sub_seed(seed, 4))
    pick = set(rng.choice(len(answered), min(n, len(answered)), replace=False).tolist())
    pick.add(int(np.argmax([r[3] - r[2] for r in answered])))
    return [answered[i] for i in sorted(pick)]


def verify(ctx, scene, prow, point_xyz, track_len, retr, answered, replies, recorded) -> dict:
    """The compared numbers over the sampled requests."""
    cell, device = ctx["cell"], ctx["device"]
    loc = cell.config["localizer"]
    dev = torch.device(device)
    size = scene.size
    gaps, t_gaps, r_gaps = [0.0], [0.0], [0.0]
    for idx, q, *_ in sample_requests(answered, ctx["seed"], cell.mix["check_requests"]):
        qd = torch.from_numpy(np.ascontiguousarray(scene.q_desc[q].T)).to(dev)
        qv = torch.arange(size.kp, device=dev) < int(scene.q_nv[q])
        calls = recorded.get(query_name(q), [])
        if not calls:
            gaps.append(float("inf"))
        for db_ids, m in calls:
            rows = np.asarray(db_ids) - 1
            for lo in range(0, len(rows), BANK_BLOCK):
                r = rows[lo:lo + BANK_BLOCK]
                banks = torch.from_numpy(np.ascontiguousarray(
                    scene.db_desc[r].transpose(0, 2, 1))).to(dev)
                bv = torch.from_numpy(bank_valid(scene.db_nv[r], prow[r])).to(dev)
                s = similarities(qd, banks, qv, bv)
                gaps.append(match_gap(s, torch.from_numpy(m[lo:lo + BANK_BLOCK])))
        uv, xyz = correspondences(scene.q_desc[q], scene.q_nv[q], scene.q_kp[q],
                                  scene.db_desc[retr[q]], scene.db_nv[retr[q]], prow[retr[q]],
                                  point_xyz, track_len, loc["obs_thresh"], "float64", device)
        rq, rt, _ = reference_pose(scene.q_q[q], scene.q_t[q], uv, xyz, size.cam_params,
                                   loc["opt_thresh"], device=device)
        rep = replies[idx]
        dt, dr = pose_gap(rep["qvec"], rep["tvec"], rq, rt)
        t_gaps.append(dt)
        r_gaps.append(dr)
    return {"match_gap": max(gaps), "pose_t_gap_m": max(t_gaps), "pose_r_gap_deg": max(r_gaps),
            "requests_checked": len(t_gaps) - 1}
