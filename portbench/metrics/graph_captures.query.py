"""CUDA graphs captured inside the traced part's requests: the sum of the
``captured`` tags of their ``graphs.run`` spans (the warm-up should leave
none to capture)."""

from portbench.program_spans import tag_sum


def read(ctx):
    return tag_sum(ctx, "graphs.run", "captured")
