"""Host time of the packed result's copy back (``extract.fetch``: the
device's queued work for the call, then the copy), per
``extract_batch`` call of the traced part, in ms."""

from portbench.program_spans import per_call_ms


def read(ctx):
    return per_call_ms(ctx, "extract.fetch")
