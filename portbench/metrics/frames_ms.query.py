"""Host time of the choice of covisible frames for the refinement
(``engine.frames``), per request of the traced part, in ms."""

from portbench.program_spans import per_request_ms


def read(ctx):
    return per_request_ms(ctx, "engine.frames")
