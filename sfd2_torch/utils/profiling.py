"""Profiling and stage timing.

Port of ``sfd2_tpu/utils/profiling.py``:
* ``StageTimer`` — accumulating wall-clock per named stage, JSON export;
* ``trace`` — a ``torch.profiler`` context (CUDA activity too when the
  device is CUDA) that writes a Chrome trace into `log_dir`;
* ``device_time`` — the median wall-clock of a call, fenced by
  ``torch.cuda.synchronize`` so queued device work is counted.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict

import torch


class StageTimer:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, dict]:
        return {k: {"total_s": round(self.totals[k], 4), "count": self.counts[k],
                    "mean_ms": round(1e3 * self.totals[k] / max(self.counts[k], 1), 3)}
                for k in self.totals}

    def dump(self, path):
        Path(path).write_text(json.dumps(self.summary(), indent=2))


@contextlib.contextmanager
def trace(log_dir, device="cuda"):
    """Profile the body with ``torch.profiler`` and write a Chrome trace
    (``trace.json``, open in chrome://tracing or Perfetto) into `log_dir`.
    CUDA activity is recorded when `device` is a CUDA device."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(str(log_dir / "trace.json"))


def _fence(out):
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return out


def device_time(fn, *args, fence=None, iters: int = 3):
    """Median wall-clock seconds of `fn(*args)` after one warm-up call; the
    fence (default: ``torch.cuda.synchronize`` when CUDA is in use) waits
    for the call's device work."""
    fence = fence or _fence
    fence(fn(*args))
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fence(fn(*args))
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]
