"""The program's spans and counters (``sfd2_torch/utils/profiling.py``) on
the CPU: nothing kept while recording is off; recording under
``torch.profiler`` (threads started after it included) and under
``recording()``; request ids and parents through the HTTP service with
four concurrent clients; ``waited``; exact counters under threads; the
spans on the profiler's clock; and ``extract_batch``'s spans in order.
"""

import json
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench.trace import DeviceTrace, _events
from sfd2_torch.cli.extract_features import seeded_state_dict
from sfd2_torch.io.feature_store import FeatureStore
from sfd2_torch.localization.engine import LocalizerConfig
from sfd2_torch.pipeline.extract import ExtractionConfig, Extractor
from sfd2_torch.serving.server import LocalizationService, make_server
from sfd2_torch.utils import profiling
from sfd2_torch.utils.synth import build_corridor_scene

torch.set_num_threads(2)


def _all_threads_profiler():
    config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    return profile(activities=[ProfilerActivity.CPU], experimental_config=config)


def _in_thread(fn):
    out = []
    t = threading.Thread(target=lambda: out.append(fn()))
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    return out[0]


def _one_span(name):
    with profiling.span(name):
        pass


def test_nothing_is_kept_while_recording_is_off():
    n = len(profiling.records())
    lock = threading.Lock()
    with profiling.request(), profiling.span("off", k=1) as s:
        s.set(k=2)
        profiling.count("tracing.off", tag="n")
        with profiling.waited(lock, "off.wait"):
            pass
    assert profiling.span("a") is profiling.span("b", k=1)  # one shared do-nothing span
    assert len(profiling.records()) == n
    assert profiling.counter("tracing.off") == 1  # counters are always on


@pytest.mark.parametrize("mode", ["profiler", "recording"])
def test_recording_on_under_the_profiler_and_recording(mode):
    """Spans are kept on the main thread and on a thread started after the
    profiler (or the block); the profiler sets the flag the recorder reads,
    on both threads, where ``torch.autograd._profiler_enabled()`` does not."""
    scope = _all_threads_profiler() if mode == "profiler" else profiling.recording()
    with scope:
        with profiling.span(f"main.{mode}", k=1) as s:
            s.set(n=2)
        _in_thread(lambda: _one_span(f"worker.{mode}"))
        flags = (torch.autograd.profiler._is_profiler_enabled,
                 _in_thread(lambda: torch.autograd.profiler._is_profiler_enabled))
    assert flags == ((True, True) if mode == "profiler" else (False, False))
    recs = {r.name: r for r in profiling.records()[-2:]}
    assert recs[f"main.{mode}"].tags == {"k": 1, "n": 2}
    assert recs[f"worker.{mode}"].thread != recs[f"main.{mode}"].thread
    assert all(r.t1 >= r.t0 and r.parent is None for r in recs.values())


def test_parents_tags_and_the_record_cap(monkeypatch):
    with profiling.recording() as recs:
        with profiling.request() as rid, profiling.span("outer", lookups=0) as outer:
            with profiling.span("inner"):
                pass
            profiling.count("tracing.lookups", 3, tag="lookups")
        monkeypatch.setattr(profiling, "MAX_RECORDS", len(profiling.records()))
        dropped = profiling.counter("profiling.dropped")
        with profiling.span("dropped"):
            pass
    inner, outer_rec = recs
    assert (inner.name, outer_rec.name) == ("inner", "outer")
    assert inner.parent == outer.id == outer_rec.id and inner.request == outer_rec.request == rid
    assert outer_rec.tags == {"lookups": 3}
    assert profiling.counter("profiling.dropped") == dropped + 1


def test_waited_records_only_a_contended_acquire():
    lock, rlock = threading.Lock(), threading.RLock()
    with profiling.recording() as recs:
        with profiling.waited(rlock, "rlock.wait"):
            with profiling.waited(rlock, "rlock.wait"):  # re-entered, as before
                pass
        with profiling.waited(lock, "lock.wait"):
            pass
        held, release = threading.Event(), threading.Event()

        def holder():
            with lock:
                held.set()
                release.wait(timeout=60)

        t = threading.Thread(target=holder)
        t.start()
        assert held.wait(timeout=60)
        threading.Timer(0.05, release.set).start()
        with profiling.waited(lock, "lock.wait"):
            assert lock.locked()
        t.join(timeout=60)
        assert not t.is_alive()
    assert not lock.locked() and rlock.acquire(blocking=False)
    rlock.release()
    waits = [r for r in recs if r.name.endswith(".wait")]
    assert [r.name for r in waits] == ["lock.wait"]
    assert waits[0].t1 - waits[0].t0 >= 40e6  # the 50 ms the holder kept the lock


def test_counters_are_exact_under_eight_threads():
    before = profiling.counter("tracing.threads")
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [profiling.count("tracing.threads", 2)
                                                    for _ in range(5000)]) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert profiling.counter("tracing.threads") - before == 8 * 5000 * 2


def test_spans_on_the_profilers_clock():
    """A span's ``perf_counter_ns`` interval, moved onto the profiler's clock
    by ``portbench/trace.py``'s marker, matches its range among the
    profiler's events within 100 µs, on the main thread and on a worker thread (the
    median of five spans each: a preemption between a range's end and the
    clock's read is the scheduler's, not the mapping's)."""
    def work(prefix):
        for i in range(5):
            with profiling.span(f"{prefix}.{i}"):
                torch.ones(256, 256) @ torch.ones(256, 256)
                time.sleep(0.002)

    # The marker (a record_function) is the process's first unless one ran
    # before it; the first pays the op's one-time lookup inside it, which
    # shifts the mapping.
    with torch.autograd.profiler.record_function("clock.warm"):
        pass
    trace = DeviceTrace()
    trace.start()
    work("clock.main")
    _in_thread(lambda: work("clock.worker"))
    trace.stop()
    events = {e[0]: e for e in _events(trace.prof)}
    offset = events["portbench.mark"][2] - trace.mark
    recs = {r.name: r for r in profiling.records() if r.name.startswith("clock.")}
    for prefix in ("clock.main", "clock.worker"):
        errs = [max(abs(r.t0 + offset - ev[2]), abs(r.t1 + offset - ev[3]))
                for r, ev in ((recs[f"{prefix}.{i}"], events[f"{prefix}.{i}"])
                              for i in range(5))]
        assert np.median(errs) <= 100_000, (prefix, errs)
    # Not user annotations: the profiler would copy those onto the device's
    # timeline, where the benchmark reads device time.
    ranges = [e for e in trace.prof.profiler.kineto_results.events()
              if e.name().startswith("clock.m") or e.name().startswith("clock.w")]
    assert len(ranges) == 10 and not any(e.is_user_annotation() for e in ranges)


SCENE = dict(n_images=12, n_queries=4, n_points=900, kp_per_image=300, kp_per_query=250,
             retrieval_k=5, seed=3)
CFG = dict(ransac_thresh=8.0, opt_thresh=8.0, inlier_thresh=10, covisibility_frame=5, iters=2,
           radius=12.0, obs_thresh=3, max_keypoints=512, num_hypotheses=256,
           db_cache_images=4)


def test_request_ids_and_parents_through_the_service():
    """Four concurrent HTTP clients: every span of a request carries its
    request id, runs on its handler's thread and nests under its
    ``serve.request``; the engine's layers are all there."""
    store = FeatureStore()
    scene = build_corridor_scene(store, **SCENE)
    service = LocalizationService(scene.map_index, store, LocalizerConfig(**CFG), device="cpu",
                                  max_concurrent=2)
    service.warmup()
    server = make_server(service, port=0)
    serving = threading.Thread(target=server.serve_forever, daemon=True)
    serving.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/localize"

    def post(i):
        qname, _, _, near = scene.queries[i]
        body = {"query_name": qname, "db_ids": [int(j) for j in near],
                "camera": {"model": scene.cam_model, "width": scene.width,
                           "height": scene.height, "params": list(scene.cam_params)}}
        req = urllib.request.Request(url, json.dumps(body).encode(),
                                     {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status

    n = len(profiling.records())
    try:
        with profiling.recording():
            clients = [threading.Thread(target=post, args=(i,)) for i in range(4)]
            for t in clients:
                t.start()
            for t in clients:
                t.join(timeout=300)
        assert not any(t.is_alive() for t in clients)
        # A handler closes its serve.request just after its client has the
        # reply: wait for the four roots.
        deadline = time.monotonic() + 60
        while True:
            recs = profiling.records()[n:]
            roots = [r for r in recs if r.name == "serve.request"]
            if len(roots) == 4 or time.monotonic() > deadline:
                break
            time.sleep(0.01)
    finally:
        server.shutdown()
        server.server_close()
        serving.join(timeout=60)
    assert len(roots) == 4 and len({r.request for r in roots}) == 4
    assert all(r.parent is None for r in roots)
    by_id = {r.id: r for r in recs}
    for root in roots:
        mine = [r for r in recs if r.request == root.request and r is not root]
        assert {"engine.localize", "engine.query_feats", "engine.match", "engine.assemble",
                "engine.pnp", "graphs.run", "graphs.eager"} <= {r.name for r in mine}
        for r in mine:
            assert r.thread == root.thread and root.t0 <= r.t0 <= r.t1 <= root.t1
            up = r
            while up.parent is not None:
                up = by_id[up.parent]
            assert up is root
    assert {r.request for r in recs} == {r.request for r in roots}
    # The gate of 2 kept two of the four waiting; the small caches missed.
    assert any(r.name == "service.gate_wait" for r in recs)
    matches = [r for r in recs if r.name == "engine.match"]
    assert sum(r.tags["misses"] for r in matches) > 0
    assert all(0 <= r.tags["misses"] <= r.tags["lookups"] == r.tags["real_banks"]
               for r in matches)
    assert all(r.tags["captured"] == 0 for r in recs if r.name == "graphs.run")


def test_extract_batch_spans_in_order():
    ex = Extractor(seeded_state_dict(0), ExtractionConfig(max_keypoints=32, bf16=False),
                   device="cpu")
    images = [np.random.default_rng(i).random((64, 96, 3), dtype=np.float32) for i in range(2)]
    with profiling.recording() as recs:
        feats = ex.extract_batch(images)
    assert len(feats) == 2
    root = recs[-1]
    assert (root.name, root.parent, root.tags) == ("extract.batch", None, {"images": 2})
    inner = [r for r in recs if r.parent == root.id]
    assert [r.name for r in inner] == ["extract.round", "extract.upload", "extract.launch",
                                       "extract.fetch"]
    assert all(a.t1 <= b.t0 for a, b in zip(inner, inner[1:]))
