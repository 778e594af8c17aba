"""The map build's share of the card's peak: K2's operations (2·K·K·C per
pair the matcher wrote in the traced part of the window) over that
part's wall time, over 495 TFLOP/s (TF32, the rate for the float32
banks), in %. F-RANSAC's arithmetic is not counted: its 8-point fits and
Sampson errors are element-wise work of no fixed peak."""

from portbench.flops import PEAK_FLOPS, match_cost


def read(ctx):
    trace, work = ctx.get("trace"), ctx.get("k2_work")
    if not trace or not work or trace["window_s"] <= 0 or not sum(w[0] for w in work):
        return None
    flops = sum(match_cost(b, n1, n2, c, broadcast=False)[0] for b, n1, n2, c in work)
    return 100.0 * flops / trace["window_s"] / PEAK_FLOPS["tf32"]
