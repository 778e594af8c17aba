"""The wait for the lock that serialises every graph capture and replay
(``graphs.lock_wait``, only when another request holds it), per request
of the traced part, in ms."""

from portbench.program_spans import per_request_ms


def read(ctx):
    return per_request_ms(ctx, "graphs.lock_wait")
