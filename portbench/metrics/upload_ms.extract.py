"""Host time of the float32 images' copies to the device
(``extract.upload``: one pageable ``.to(device)`` per image, in its own
dtype), per ``extract_batch`` call of the traced part, in ms."""

from portbench.program_spans import per_call_ms


def read(ctx):
    return per_call_ms(ctx, "extract.upload")
