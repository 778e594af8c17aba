"""Profiling and stage timing.

Port of ``sfd2_tpu/utils/profiling.py``:
* ``StageTimer`` — accumulating wall-clock per named stage, JSON export;
* ``trace`` — a ``torch.profiler`` context (CUDA activity too when the
  device is CUDA) that writes a Chrome trace into `log_dir`;
* ``device_time`` — the median wall-clock of a call, fenced by
  ``torch.cuda.synchronize`` so queued device work is counted.

The program's own spans and counters (no JAX counterpart):
* ``span(name, **tags)`` — a named interval on ``time.perf_counter_ns``,
  kept in memory (``records()``) while recording is on, with its thread,
  the span open around it on that thread (``parent``), the id of the
  ``request()`` it ran under, and tags; while a ``torch.profiler`` session
  runs it is also a range of the profiler's own (a ``RecordFunction``), so
  the profiler's events (and ``trace``'s Chrome trace) carry it on the
  device events' clock. The range is a CPU op, not a ``record_function``
  user annotation: the profiler copies each user annotation onto the
  device's timeline as a span over the kernels launched inside it, which
  would read as device time;
* ``request()`` — the scope of one request: the spans opened inside it
  carry a fresh request id;
* ``count(name, n)`` — process-wide counters, always on (read with
  ``counter``); with ``tag`` the count is also added to that tag of the
  innermost span open on the thread, so a reader can count only what a
  traced window did;
* ``waited(lock, name)`` — ``with lock:`` that records a span `name` for
  the wait only when the lock was taken.

Recording is on while a ``torch.profiler`` session runs (any thread, with
``profile_all_threads``) or inside ``recording()``. Off, a span is one flag
check and a shared do-nothing context manager. At most ``MAX_RECORDS``
records are kept for the life of the process; later spans are counted as
``profiling.dropped``.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import threading
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, NamedTuple, Optional

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _ap


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


# --- the program's spans and counters --------------------------------------

MAX_RECORDS = 10**6


class Record(NamedTuple):
    """A closed span; times in ``time.perf_counter_ns``."""

    id: int
    name: str
    thread: int
    t0: int
    t1: int
    parent: Optional[int]  # id of the span open around it on its thread
    request: Optional[int]  # id of the request() it ran under
    tags: dict


_records: list = []
_counters: collections.Counter = collections.Counter()
_lock = threading.Lock()
_span_ids = itertools.count(1)
_request_ids = itertools.count(1)
_local = threading.local()  # .stack: open spans; .request: the request id
_forced = 0  # recording() blocks open


class _Null:
    """The span while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **tags):
        pass


_NULL = _Null()


class _Span:
    __slots__ = ("name", "tags", "id", "parent", "request", "t0", "_range")

    def __init__(self, name: str, tags: dict):
        self.name, self.tags = name, tags

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1].id if stack else None
        self.request = getattr(_local, "request", None)
        self.id = next(_span_ids)
        self._range = None
        if _ap._is_profiler_enabled:
            self._range = _RecordFunctionFast(self.name)
            self._range.__enter__()
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        # t0 follows the range's start and t1 its end, as near as each can.
        if self._range is not None:
            self._range.__exit__(None, None, None)
        t1 = time.perf_counter_ns()
        _local.stack.pop()
        if len(_records) < MAX_RECORDS:
            _records.append(Record(self.id, self.name, threading.get_ident(), self.t0, t1,
                                   self.parent, self.request, self.tags))
        else:
            count("profiling.dropped")
        return False

    def set(self, **tags):
        """Set tags after the span opened (counts of its own work)."""
        self.tags.update(tags)


def span(name: str, **tags):
    """``with span(name, **tags) as s:`` records the body as one span while
    recording is on; ``s.set(**tags)`` adds tags."""
    if not (_forced or _ap._is_profiler_enabled):
        return _NULL
    return _Span(name, tags)


class request:
    """``with request():`` gives the spans opened inside a fresh request id."""

    __slots__ = ("_prev",)

    def __enter__(self) -> int:
        self._prev = getattr(_local, "request", None)
        _local.request = rid = next(_request_ids)
        return rid

    def __exit__(self, *exc):
        _local.request = self._prev
        return False


class waited:
    """``with waited(lock, name):`` holds `lock` as ``with lock:`` does; a
    blocking acquire is timed as a span `name`, taken only when a
    non-blocking one failed."""

    __slots__ = ("_lock", "_name")

    def __init__(self, lock, name: str):
        self._lock, self._name = lock, name

    def __enter__(self):
        if not self._lock.acquire(blocking=False):
            with span(self._name):
                self._lock.acquire()
        return self._lock

    def __exit__(self, *exc):
        self._lock.release()
        return False


def count(name: str, n=1, tag: Optional[str] = None) -> None:
    """Add `n` to the process counter `name`; with `tag`, also to that tag of
    the innermost span open on this thread, if one is recording."""
    with _lock:
        _counters[name] += n
    stack = getattr(_local, "stack", None) if tag is not None else None
    if stack:
        tags = stack[-1].tags
        tags[tag] = tags.get(tag, 0) + n


def counter(name: str):
    """The process counter `name` (0 before its first count)."""
    with _lock:
        return _counters[name]


def records() -> list:
    """Every record kept so far, in the order the spans closed."""
    return list(_records)


@contextlib.contextmanager
def recording():
    """Record spans in the body as while a profiler runs; yields a list that
    holds the records closed in the body once it ends."""
    global _forced
    with _lock:
        _forced += 1
    start, out = len(_records), []
    try:
        yield out
    finally:
        with _lock:
            _forced -= 1
        out.extend(_records[start:])
