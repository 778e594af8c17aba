"""Host time of enqueueing the device program (``extract.launch``:
normalisation, K1, the trunk, keypoint selection), per ``extract_batch``
call of the traced part, in ms."""

from portbench.program_spans import per_call_ms


def read(ctx):
    return per_call_ms(ctx, "extract.launch")
