"""Host time of enqueueing the quantisation of the float32 images on the
device into the padded uint8 batch (``extract.round``: one
``clamp(round(x * 255))`` per image, launched, not waited for), per
``extract_batch`` call of the traced part, in ms."""

from portbench.program_spans import per_call_ms


def read(ctx):
    return per_call_ms(ctx, "extract.round")
