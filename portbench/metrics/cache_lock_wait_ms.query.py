"""The wait for the engine's bank-cache lock (``engine.cache_lock_wait``,
only when another request holds it: a miss holds it through its bank
read and upload), per request of the traced part, in ms."""

from portbench.program_spans import per_request_ms


def read(ctx):
    return per_request_ms(ctx, "engine.cache_lock_wait")
