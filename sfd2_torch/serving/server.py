"""Long-lived localization service: warm graphs and banks, HTTP API.

Port of ``sfd2_tpu/serving/server.py``. The reference ships offline
scripts only; a deployment wants a resident service that pays its set-up
once and then answers queries at device speed. This wraps the
localization engine (``sfd2_torch.localization.engine``) behind a
threaded HTTP server:

  GET  /healthz   → {"ok": true, "images": N, "points3d": M}
  POST /localize  → body {"query_name": str,           # in the feature store
                          "db_names": [str, ...]       # retrieved frames
                          | "db_ids": [int, ...],
                          "camera": {"model": str, "width": int,
                                     "height": int, "params": [..]},
                          "cluster_mode": "sng"|"one"}  # default sng
                    → {"qvec": [w,x,y,z], "tvec": [x,y,z],
                       "num_inliers": n, "source": ..., "ms": t}

Client errors (missing fields, a body that is not a JSON object) answer
400, unknown paths 404, faults of the server 500; none stops the server.
Up to ``max_concurrent`` requests are in flight at once: the engine is
thread-safe (lock-guarded caches; the PnP and refinement graphs replay
one call at a time), and one query's host work overlaps another's device
work. ``warmup`` localizes a throwaway query shaped like a request of the
configured retrieval size (``covisibility_frame`` singleton frames), which
uploads those frames' banks, and captures the PnP and refinement graphs of
every correspondence bucket a query of up to 2 × ``max_keypoints``
correspondences takes: a request then replays graphs and captures none.

Each POST is a ``request()`` of ``utils/profiling.py`` under a span
``serve.request``; a wait for the gate is a span ``service.gate_wait``.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from sfd2_torch.io.feature_store import FeatureStore
from sfd2_torch.localization.engine import LocalizationEngine, LocalizerConfig
from sfd2_torch.sfm.map_index import MapIndex
from sfd2_torch.utils import profiling

log = logging.getLogger(__name__)


class LocalizationService:
    """Engine wrapper with name resolution and a concurrency gate."""

    def __init__(self, map_index: MapIndex, feature_store: FeatureStore,
                 config: LocalizerConfig | None = None, max_concurrent: int = 4,
                 device: str = "cuda"):
        self.map = map_index
        self.engine = LocalizationEngine(map_index, feature_store, config or LocalizerConfig(),
                                         device=device)
        # Bounded admission, not mutual exclusion: it keeps the stacked banks'
        # device memory and the host memory in check under load spikes.
        self._gate = threading.BoundedSemaphore(max(1, max_concurrent))

    def resolve_db_ids(self, body: dict):
        if "db_ids" in body:
            return [int(i) for i in body["db_ids"]]
        return [self.map.name_to_image_id[n] for n in body["db_names"]]

    def localize(self, body: dict) -> dict:
        cam = body["camera"]
        qinfo = (cam["model"], cam["width"], cam["height"], np.asarray(cam["params"], np.float64))
        db_ids = self.resolve_db_ids(body)
        clusters = [db_ids] if body.get("cluster_mode") == "one" else [[i] for i in db_ids]
        t0 = time.perf_counter()
        with profiling.waited(self._gate, "service.gate_wait"):
            res = self.engine.localize(body["query_name"], qinfo, clusters)
        return {"qvec": [float(v) for v in res.qvec], "tvec": [float(v) for v in res.tvec],
                "num_inliers": int(res.num_inliers), "source": res.source,
                "ms": round((time.perf_counter() - t0) * 1e3, 1)}

    def warmup(self) -> float:
        """Localize a throwaway query as a request of the configured
        retrieval size would: the first DB image against
        ``covisibility_frame`` singleton frames of the map (4 when
        ``covisibility_frame`` sets no limit), led by the frame that shares
        the fewest points with it (so the first cluster misses and the other
        frames are matched in one launch, at a request's frame bucket) and
        then its covisible frames, most shared points first; this uploads
        their banks and runs PnP and the covisibility refinement. Then
        ``engine.warmup_programs()`` captures the PnP and refinement graphs
        of every bucket in ``engine.warm_buckets()`` on the card.

        A request then captures no graph while its clusters give at most
        2 × ``max_keypoints`` correspondences, and one of
        ``covisibility_frame`` frames meets the frame bucket the warm-up
        ran; a request of another size runs the matcher at another frame
        bucket, which captures no graph either. The reference
        localizes against 4 singletons; the answers of later requests are
        the same either way. Returns seconds."""
        t0 = time.perf_counter()
        iid = int(self.map.image_ids[0])
        image = self.map.images[iid]
        cam = self.map.cameras[image.camera_id]
        qinfo = (cam.model, cam.width, cam.height, np.asarray(cam.params))
        ids = [int(i) for i in self.map.image_ids]
        n = self.engine.cfg.covisibility_frame
        n = min(n if n > 0 else 4, len(ids))  # no frame limit: the reference's 4 singletons
        shared = self.map.covisibility_counts(self.map.observed_point_rows(iid))
        far = min(ids, key=lambda i: shared.get(i, 0))
        frames = [f for f in self.map.covis_frames_obs(iid, covisibility_frame=n) if f != far]
        seen = set(frames) | {far}
        frames = [far] + frames + [i for i in ids if i not in seen]
        with self._gate:
            self.engine.localize(image.name, qinfo, [[i] for i in frames[:n]])
            self.engine.warmup_programs()
        return time.perf_counter() - t0


def make_server(service: LocalizationService, host: str = "127.0.0.1",
                port: int = 0) -> ThreadingHTTPServer:
    """Build (not start) the HTTP server; port 0 picks a free port."""

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, payload: dict):
            data = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"ok": True, "images": len(service.map.images),
                                  "points3d": len(service.map.points3d)})
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            with profiling.request(), profiling.span("serve.request"):
                self._post()

        def _post(self):
            if self.path != "/localize":
                self._reply(404, {"error": f"unknown path {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n))
                if not isinstance(body, dict):
                    raise json.JSONDecodeError("body must be an object", "", 0)
                self._reply(200, service.localize(body))
            except (KeyError, json.JSONDecodeError, ValueError, TypeError) as e:
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})
            except Exception as e:  # a fault of the server must not stop it
                log.exception("localize failed")
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, fmt, *args):  # through logging, not stderr
            log.debug("http: " + fmt, *args)

    return ThreadingHTTPServer((host, port), Handler)
