"""Host time of the eager segments between graph replays (``graphs.eager``:
PnP-RANSAC's LO refit with its SVDs, which wait for the device), per
request of the traced part, in ms."""

from portbench.program_spans import per_request_ms


def read(ctx):
    return per_request_ms(ctx, "graphs.eager")
