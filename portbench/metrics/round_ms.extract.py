"""Host time of rounding the float32 images into the padded uint8 batch
(``extract.round``: ``np.rint``, clip, ``astype``), per ``extract_batch``
call of the traced part, in ms."""

from portbench.program_spans import per_call_ms


def read(ctx):
    return per_call_ms(ctx, "extract.round")
