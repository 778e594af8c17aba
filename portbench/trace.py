"""Spans from the benchmark's own wrappers, and the device trace.

``Spans`` records (name, thread, start, end) in ``time.perf_counter_ns``
around calls into the program's layers; ``DeviceTrace`` runs
``torch.profiler`` over a part of the window and reduces its events to
busy time, kernel time by name, and the longest idle gaps of the device,
each named by the innermost span that was open on the host at the gap's
middle.
"""

from __future__ import annotations

import bisect
import collections
import threading
import time

import torch


class Spans:
    def __init__(self):
        self._lock = threading.Lock()
        self.records = []  # (name, thread id, t0_ns, t1_ns, tag)

    def add(self, name: str, t0: int, t1: int, tag=None):
        with self._lock:
            self.records.append((name, threading.get_ident(), t0, t1, tag))

    def wrap(self, obj, attr: str, name: str):
        """Replace obj.attr by a wrapper that records a span per call."""
        inner = getattr(obj, attr)

        def wrapper(*args, **kwargs):
            t0 = time.perf_counter_ns()
            try:
                return inner(*args, **kwargs)
            finally:
                self.add(name, t0, time.perf_counter_ns())

        setattr(obj, attr, wrapper)


def _events(prof):
    """(name, is_device, start_ns, end_ns) of the profiler's raw events."""
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = e.device_type() == torch.autograd.DeviceType.CUDA
        start = e.start_ns()
        out.append((e.name(), dev, start, start + e.duration_ns()))
    return out


class DeviceTrace:
    """torch.profiler (CPU and CUDA activities) started and stopped by hand;
    ``summary`` reduces it. A marker op on the starting thread maps the
    trace's clock onto ``time.perf_counter_ns``."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        # Kernels launched from threads that start after the profiler (the
        # HTTP server's, one per request) are recorded only with this.
        config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
        self.prof = profile(activities=acts, experimental_config=config)
        self.t0 = self.t1 = None

    def start(self):
        self.prof.__enter__()
        with torch.profiler.record_function("portbench.mark"):
            self.mark = time.perf_counter_ns()
        self.t0 = time.perf_counter_ns()

    def stop(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1 = time.perf_counter_ns()
        self.prof.__exit__(None, None, None)

    def summary(self, spans: Spans) -> dict:
        events = _events(self.prof)
        marks = [e for e in events if e[0] == "portbench.mark"]
        offset = (marks[0][2] - self.mark) if marks else 0
        lo, hi = self.t0 + offset, self.t1 + offset
        dev = sorted((max(s, lo), min(t, hi), n) for n, d, s, t in events
                     if d and t > lo and s < hi)
        by_name = collections.Counter()
        busy, cur_s, cur_t = 0, None, None
        gaps = []
        prev_end = lo
        for s, t, n in dev:
            by_name[n] += (t - s) / 1e9
            if cur_t is None or s > cur_t:
                if cur_t is not None:
                    busy += cur_t - cur_s
                cur_s, cur_t = s, t
            else:
                cur_t = max(cur_t, t)
            if s > prev_end:
                gaps.append((s - prev_end, prev_end, s))
            prev_end = max(prev_end, t)
        if cur_t is not None:
            busy += cur_t - cur_s
        if hi > prev_end:
            gaps.append((hi - prev_end, prev_end, hi))
        window_s = (self.t1 - self.t0) / 1e9
        gaps.sort(reverse=True)
        named = collections.Counter()
        recs = sorted(spans.records, key=lambda r: r[2])
        starts = [r[2] for r in recs]
        for length, a, b in gaps[:200]:
            mid = (a + b) // 2 - offset
            i = bisect.bisect_right(starts, mid)
            inner = None
            for r in reversed(recs[max(0, i - 2000):i]):
                if r[3] >= mid and (inner is None or r[2] > inner[2]):
                    inner = r
            named["host: " + (inner[0] if inner else "outside the program's calls")] += \
                length / 1e9
        return dict(busy_s=busy / 1e9, window_s=window_s, kernels=dict(by_name),
                    device_ops=[[n, s] for n, s in by_name.most_common(10)],
                    idle_gaps=[[n, s] for n, s in named.most_common(10)])


def kernel_seconds(summary: dict, *parts: str) -> float:
    """Device seconds of the kernels whose names contain any of `parts`."""
    return sum(s for n, s in summary["kernels"].items() if any(p in n for p in parts))
