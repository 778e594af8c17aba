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
work. ``warmup`` localizes a throwaway query and captures the PnP and
refinement graphs of the configured ``pnp_pad_floor`` bucket, so the first
real request replays them.
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
        with self._gate:
            res = self.engine.localize(body["query_name"], qinfo, clusters)
        return {"qvec": [float(v) for v in res.qvec], "tvec": [float(v) for v in res.tvec],
                "num_inliers": int(res.num_inliers), "source": res.source,
                "ms": round((time.perf_counter() - t0) * 1e3, 1)}

    def warmup(self) -> float:
        """Localize the first DB image against its first neighbours (loads
        the matcher, uploads banks), then ``engine.warmup_programs()``,
        which captures the PnP and refinement graphs of the
        ``pnp_pad_floor`` bucket on the card. Returns seconds."""
        t0 = time.perf_counter()
        iid = int(self.map.image_ids[0])
        image = self.map.images[iid]
        cam = self.map.cameras[image.camera_id]
        qinfo = (cam.model, cam.width, cam.height, np.asarray(cam.params))
        near = [int(i) for i in self.map.image_ids[:4]]
        with self._gate:
            self.engine.localize(image.name, qinfo, [[i] for i in near])
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
