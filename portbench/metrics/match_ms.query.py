"""Host wall time inside ``LocalizationEngine._match_query_to_dbs`` per
request (bank reads and uploads on cache misses, the K2 launch, the
fetch), summed over the window's calls and divided by its requests, in ms."""

from portbench.metrics_common import per_request_ms


def read(ctx):
    return per_request_ms(ctx, ("engine.match",))
