"""Host wall time inside ``match_pairs`` (the store's lookups, bank reads
and uploads, K2's launches, one fetch per batch, the store's writes) per
call of the window, from the benchmark's wrapper, in ms."""


def read(ctx):
    spans = ctx.get("spans")
    ms = [(r[3] - r[2]) / 1e6 for r in spans.records if r[0] == "mapbuild.match"] if spans else []
    return sum(ms) / len(ms) if ms else None
