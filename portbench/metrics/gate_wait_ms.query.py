"""The wait of a request for a place at the service's gate of
``max_concurrent`` requests (``service.gate_wait``, only when the gate is
full), per request of the traced part, in ms."""

from portbench.program_spans import per_request_ms


def read(ctx):
    return per_request_ms(ctx, "service.gate_wait")
