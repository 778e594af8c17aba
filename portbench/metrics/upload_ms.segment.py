"""Host time of the images' copies to the device (``segment.upload``: one
pageable copy per uint8 image into the batch), per ``segment_batch`` call of
the traced part, in ms."""

from portbench.program_spans_segment import per_call_ms


def read(ctx):
    return per_call_ms(ctx, "segment.upload")
