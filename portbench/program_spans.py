"""The program's own spans (``sfd2_torch/utils/profiling.py``) inside a
run's window, for the per-layer readers that read them.

Serve cells: the ``serve.request`` roots that opened inside
``ctx["window"]`` (the program records spans only while the profiler
runs, so these are the traced part's requests) and every span of those
requests, joined by request id. Extraction: the ``extract.batch`` roots
inside the interval of the run's own ``extract.batch`` records in
``ctx["spans"]``, and the spans below them. Against a program that records
no spans every function returns None.
"""

from __future__ import annotations


def _records():
    from sfd2_torch.utils import profiling

    read = getattr(profiling, "records", None)
    return read() if read is not None else None


def requests(ctx: dict):
    """(roots, their requests' records), or None."""
    window, recs = ctx.get("window"), _records()
    if window is None or recs is None:
        return None
    lo, hi = int(window[0] * 1e9), int(window[-1] * 1e9)
    roots = [r for r in recs if r.name == "serve.request" and r.parent is None
             and lo <= r.t0 <= hi]
    if not roots:
        return None
    ids = {r.request for r in roots}
    return roots, [r for r in recs if r.request in ids]


def per_request_ms(ctx: dict, name: str) -> float | None:
    """Milliseconds of the spans `name` per request."""
    got = requests(ctx)
    if got is None:
        return None
    roots, recs = got
    return sum(r.t1 - r.t0 for r in recs if r.name == name) / 1e6 / len(roots)


def tag_sum(ctx: dict, name: str, tag: str) -> float | None:
    """The sum of the tag `tag` over the requests' spans `name`."""
    got = requests(ctx)
    if got is None:
        return None
    return sum(r.tags.get(tag, 0) for r in got[1] if r.name == name)


def calls(ctx: dict):
    """(extract.batch roots, the records below them), or None."""
    spans, recs = ctx.get("spans"), _records()
    if spans is None or recs is None:
        return None
    window = [r for r in spans.records if r[0] == "extract.batch"]
    if not window:
        return None
    lo, hi = min(r[2] for r in window), max(r[3] for r in window)
    roots = [r for r in recs if r.name == "extract.batch" and r.parent is None
             and lo <= r.t0 and r.t1 <= hi]
    if not roots:
        return None
    ids = {r.id for r in roots}
    return roots, [r for r in recs if r.parent in ids]


def per_call_ms(ctx: dict, name: str) -> float | None:
    """Milliseconds of the spans `name` per ``extract_batch`` call."""
    got = calls(ctx)
    if got is None:
        return None
    roots, recs = got
    return sum(r.t1 - r.t0 for r in recs if r.name == name) / 1e6 / len(roots)
