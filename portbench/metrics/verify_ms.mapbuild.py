"""Host wall time inside ``geometric_verification`` (reading each pair's
matches and keypoints, batched F-RANSAC on the device, one fetch per
batch) per call of the window, from the benchmark's wrapper, in ms."""


def read(ctx):
    spans = ctx.get("spans")
    ms = [(r[3] - r[2]) / 1e6 for r in spans.records if r[0] == "mapbuild.verify"] if spans else []
    return sum(ms) / len(ms) if ms else None
