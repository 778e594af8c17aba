"""Host time of enqueueing the network's forward over every crop of the call
under float16 autocast (``segment.forward``), per ``segment_batch`` call of
the traced part, in ms."""

from portbench.program_spans_segment import per_call_ms


def read(ctx):
    return per_call_ms(ctx, "segment.forward")
