"""Host time of bank uploads on a device-cache miss (``engine.bank_upload``:
the pageable copy of a [K, C] float32 bank and its masks), per request
of the traced part, in ms."""

from portbench.program_spans import per_request_ms


def read(ctx):
    return per_request_ms(ctx, "engine.bank_upload")
