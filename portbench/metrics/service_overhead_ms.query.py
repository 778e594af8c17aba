"""The service's share of a request: the median over answered requests of
the client's time minus the time the reply reports (``ms``: the engine's
localize, the 4-request gate's wait included), in ms. Covers HTTP,
JSON and the server's threads."""

import numpy as np


def read(ctx):
    reqs = ctx.get("requests") or []
    if not reqs:
        return None
    return float(np.median([r["client_ms"] - r["reply_ms"] for r in reqs]))
