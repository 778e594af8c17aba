"""Host time of the labels' copy back (``segment.fetch``: the device's queued
work for the call, then the copy), per ``segment_batch`` call of the traced
part, in ms."""

from portbench.program_spans_segment import per_call_ms


def read(ctx):
    return per_call_ms(ctx, "segment.fetch")
