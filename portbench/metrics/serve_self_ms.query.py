"""The service's own time in a request: ``serve.request`` (the HTTP
handler: reading and parsing the body, the reply) less its child spans
(the gate's wait, ``engine.localize``), per request of the traced part,
in ms. The in-program twin of ``service_overhead_ms.query``."""

from portbench.program_spans import requests


def read(ctx):
    got = requests(ctx)
    if got is None:
        return None
    roots, recs = got
    ids = {r.id for r in roots}
    children = sum(r.t1 - r.t0 for r in recs if r.parent in ids)
    return (sum(r.t1 - r.t0 for r in roots) - children) / 1e6 / len(roots)
