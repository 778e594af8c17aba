"""Host time of enqueueing the keep-ratio resize, the normalisation, the pad
and the crops on the device (``segment.prep``), per ``segment_batch`` call
of the traced part, in ms."""

from portbench.program_spans_segment import per_call_ms


def read(ctx):
    return per_call_ms(ctx, "segment.prep")
