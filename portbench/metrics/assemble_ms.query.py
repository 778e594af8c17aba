"""Host time of 2D-3D assembly (``engine.assemble``: matches to 3D points,
dedup, track and radius gates), per request of the traced part, in ms."""

from portbench.program_spans import per_request_ms


def read(ctx):
    return per_request_ms(ctx, "engine.assemble")
