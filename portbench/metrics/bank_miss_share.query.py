"""The share of device bank-cache lookups that missed (each miss reads the
bank from the store and uploads it), over the ``engine.match`` spans of
the traced part's requests: the sum of their ``misses`` tags over the
sum of their ``lookups`` tags, in %."""

from portbench.program_spans import tag_sum


def read(ctx):
    lookups = tag_sum(ctx, "engine.match", "lookups")
    if not lookups:
        return None
    return 100.0 * tag_sum(ctx, "engine.match", "misses") / lookups
