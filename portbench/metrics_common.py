"""Arithmetic that several per-layer readers share."""

from __future__ import annotations


def per_request_ms(ctx: dict, names: tuple) -> float | None:
    """Milliseconds of the named spans per ``engine.localize`` span, over
    the spans that started inside the window."""
    spans, window = ctx.get("spans"), ctx.get("window")
    if spans is None or window is None:
        return None
    lo, hi = int(window[0] * 1e9), int(window[1] * 1e9)
    inside = [r for r in spans.records if lo <= r[2] < hi]
    n = sum(1 for r in inside if r[0] == "engine.localize")
    if not n:
        return None
    return sum(r[3] - r[2] for r in inside if r[0] in names) / 1e6 / n


def idle_share(ctx: dict) -> float | None:
    trace = ctx.get("trace")
    if not trace or trace["window_s"] <= 0 or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
