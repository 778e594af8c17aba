"""CUDA graphs of the localization programs, captured once per shape and
replayed for every later call.

The JAX engine runs PnP-RANSAC and the iterative LM refinement as jitted
programs (``sfd2_tpu/localization/engine.py:57-136``). Eagerly, the port's
versions launch thousands of small kernels per query. Here each is a
``Program``: fixed inputs and a list of segments, each a function of the
inputs and of the state the previous segment left. A captured segment
launches the same kernels on every call and never waits for the host; an
eager segment may (``torch.linalg.svd``, which checks its result on the
host, in the LO refit of PnP-RANSAC). A segment's last state is a tuple
holding one packed result tensor.

``run`` on CPU tensors runs the segments eagerly (``run_eager``). On CUDA
tensors the first call for a key — the program's name and static
parameters, the device, and every input's shape and dtype — runs the
program once eagerly on a side stream (module loads, cuBLAS's workspace
for that stream), then captures each captured segment into a
``torch.cuda.CUDAGraph`` over static copies of the inputs and of the
state entering it. Every call then copies its inputs into the static
inputs, replays the graphs in order with the eager segments between them
(their results copied into the next graph's static state) and returns a
copy of the packed result. A capture that fails raises: nothing runs
eagerly on the card in its place. Before a capture,
``release_cache_for_capture`` returns the caching allocator's unused
blocks to the driver when they hold more of the card than is free.

The graphs are kept for the life of the process and share one memory
pool per device. One lock serialises every capture and replay, so the
static buffers and the shared pool are never used by two calls at once:
``localize_many``'s workers and the server's request threads replay the
same graphs in turn, and a capture (``capture_error_mode="thread_local"``)
is not disturbed by another thread's kernels, which run on other streams.

Each ``run`` is a span ``graphs.run`` (tag ``captured``: the graphs this
call captured), each eager segment a span ``graphs.eager``, and a wait for
the lock a span ``graphs.lock_wait``; the counters ``graphs.captures``,
``graphs.replays`` and ``graphs.capture_ns`` (the host time of warm-up and
capture) run for the life of the process (``utils/profiling.py``).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, NamedTuple, Tuple

import torch

from sfd2_torch.utils.profiling import count, span, waited


class Program(NamedTuple):
    """name: what the program computes and its static parameters; segments:
    ((captured, fn(inputs, state) -> state), ...); inputs: tensors."""

    name: tuple
    segments: Tuple[Tuple[bool, Callable], ...]
    inputs: Tuple[torch.Tensor, ...]


def run_eager(program: Program) -> torch.Tensor:
    """Every segment eagerly on the inputs' device; the packed result."""
    state = ()
    for captured, fn in program.segments:
        if captured:
            state = fn(program.inputs, state)
        else:
            with span("graphs.eager"):
                state = fn(program.inputs, state)
    return state[0]


def release_cache_for_capture(dev) -> None:
    """``torch.cuda.empty_cache()`` when the caching allocator's unused
    blocks hold more of the card than the driver has free. While a capture
    runs the allocator cannot hand them back, so a capture that needs fresh
    memory would fail with the card's memory cached but unused; when the
    card has room, the cache stays (emptying it costs every later
    allocation a cudaMalloc)."""
    free, _ = torch.cuda.mem_get_info(dev)
    if free < torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev):
        torch.cuda.empty_cache()


class _Captured:
    """One program's graphs over static inputs and states."""

    def __init__(self, program: Program, pool):
        self.inputs = tuple(t.clone() for t in program.inputs)
        entering, state = [], ()
        for captured, fn in program.segments:  # the eager warm-up
            if captured:
                entering.append(state)
            state = fn(self.inputs, state)
        self.graphs = []
        captured_fns = [fn for captured, fn in program.segments if captured]
        release_cache_for_capture(self.inputs[0].device)
        for fn, state in zip(captured_fns, entering):
            static = tuple(t.clone() for t in state)
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                out = fn(self.inputs, static)
            finally:
                graph.capture_end()
            self.graphs.append((graph, static, out))

    def replay(self, program: Program) -> torch.Tensor:
        for dst, src in zip(self.inputs, program.inputs):
            dst.copy_(src)
        state, g = (), 0
        for captured, fn in program.segments:
            if captured:
                graph, static, out = self.graphs[g]
                g += 1
                for dst, src in zip(static, state):
                    dst.copy_(src)
                graph.replay()
                state = out
            else:
                with span("graphs.eager"):
                    state = fn(self.inputs, state)
        return state[0].clone()


_lock = threading.Lock()
_programs: dict = {}  # key → _Captured
_streams: dict = {}  # device index → side stream of every capture and replay
_pools: dict = {}  # device index → the memory pool all graphs share


def program_key(program: Program) -> tuple:
    return (program.name, str(program.inputs[0].device),
            tuple((tuple(t.shape), t.dtype) for t in program.inputs))


def captured_keys() -> list:
    """The keys of the programs captured so far."""
    with _lock:
        return list(_programs)


def run(program: Program) -> torch.Tensor:
    """The program's packed result: eagerly on CPU tensors, replayed from
    its CUDA graphs (captured on the key's first call) on CUDA tensors."""
    with span("graphs.run", captured=0) as run_span:
        dev = program.inputs[0].device
        if dev.type == "cpu":
            return run_eager(program)
        if dev.type != "cuda":
            raise ValueError(f"localization programs run on cuda or cpu tensors, not {dev}")
        key = program_key(program)
        n_graphs = sum(captured for captured, _ in program.segments)
        with waited(_lock, "graphs.lock_wait"), torch.cuda.device(dev):
            caller = torch.cuda.current_stream(dev)
            if dev.index not in _streams:
                _streams[dev.index] = torch.cuda.Stream(dev)
                _pools[dev.index] = torch.cuda.graph_pool_handle()
            side = _streams[dev.index]
            side.wait_stream(caller)
            with torch.cuda.stream(side):
                prog = _programs.get(key)
                if prog is None:
                    t0 = time.perf_counter_ns()
                    prog = _Captured(program, _pools[dev.index])
                    side.synchronize()
                    count("graphs.capture_ns", time.perf_counter_ns() - t0)
                    count("graphs.captures", n_graphs)
                    run_span.set(captured=n_graphs)
                    _programs[key] = prog
                out = prog.replay(program)
                count("graphs.replays", n_graphs)
            caller.wait_stream(side)
            out.record_stream(caller)
        return out
