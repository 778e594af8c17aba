"""The program's own spans of the segment cells (``segment.*`` in
``sfd2_torch/models/upernet.py``), for the per-layer readers: the
``segment.batch`` roots inside the interval of the run's own
``segment.batch`` records in ``ctx["spans"]``, and the spans right below
them. Against a program that records no such spans every function
returns None."""

from __future__ import annotations


def calls(ctx: dict):
    """(segment.batch roots, the records right below them), or None."""
    spans = ctx.get("spans")
    if spans is None:
        return None
    from sfd2_torch.utils import profiling

    read = getattr(profiling, "records", None)
    recs = read() if read is not None else None
    window = [r for r in spans.records if r[0] == "segment.batch"]
    if recs is None or not window:
        return None
    lo, hi = min(r[2] for r in window), max(r[3] for r in window)
    roots = [r for r in recs if r.name == "segment.batch" and r.parent is None
             and lo <= r.t0 and r.t1 <= hi]
    if not roots:
        return None
    ids = {r.id for r in roots}
    return roots, [r for r in recs if r.parent in ids]


def per_call_ms(ctx: dict, name: str) -> float | None:
    """Milliseconds of the spans `name` per ``segment_batch`` call."""
    got = calls(ctx)
    if got is None:
        return None
    roots, recs = got
    return sum(r.t1 - r.t0 for r in recs if r.name == name) / 1e6 / len(roots)
