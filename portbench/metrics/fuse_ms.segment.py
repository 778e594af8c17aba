"""Host time of enqueueing the tail kernel: slide average, resize back and
argmax (``segment.fuse``), per ``segment_batch`` call of the traced part, in
ms."""

from portbench.program_spans_segment import per_call_ms


def read(ctx):
    return per_call_ms(ctx, "segment.fuse")
