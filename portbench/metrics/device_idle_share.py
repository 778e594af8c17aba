"""The share of the traced part of the window in which no kernel, copy or
memset ran on the card, in %."""

from portbench.metrics_common import idle_share


def read(ctx):
    return idle_share(ctx)
