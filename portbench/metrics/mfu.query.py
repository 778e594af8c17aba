"""The query path's share of the card's peak: K2's operations (2·N1·N2·C
per real DB bank of every match call in the traced part of the window)
over that part's wall time, over 495 TFLOP/s (TF32, the rate for the
float32 banks), in %. The query path runs no network: matching is its
only dense arithmetic."""

from portbench.flops import PEAK_FLOPS, match_cost


def read(ctx):
    trace, work = ctx.get("trace"), ctx.get("k2_work")
    if not trace or not work or trace["window_s"] <= 0:
        return None
    flops = sum(match_cost(b, n1, n2, c, broadcast=True)[0] for b, n1, n2, c in work)
    return 100.0 * flops / trace["window_s"] / PEAK_FLOPS["tf32"]
