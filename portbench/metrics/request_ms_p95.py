"""The 95th percentile of the client's time over the window's answered
requests, in ms. The serve cells' clients are closed loops, which keep
the service at capacity: there the tail swings with the order in which
requests queue behind the engine's locks and the host's speed from run
to run, so it is read here beside the end-to-end throughput."""

import numpy as np


def read(ctx):
    reqs = ctx.get("requests") or []
    if not reqs:
        return None
    return float(np.percentile([r["client_ms"] for r in reqs], 95))
