"""Host time of bank reads on a host-cache miss (``engine.bank_read``: the
store's ``read_padded`` and the 3D-point mask), per request of the
traced part, in ms."""

from portbench.program_spans import per_request_ms


def read(ctx):
    return per_request_ms(ctx, "engine.bank_read")
