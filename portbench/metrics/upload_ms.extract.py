"""Host time of the uint8 batch's copy to the device (``extract.upload``,
from pageable memory), per ``extract_batch`` call of the traced part, in
ms."""

from portbench.program_spans import per_call_ms


def read(ctx):
    return per_call_ms(ctx, "extract.upload")
