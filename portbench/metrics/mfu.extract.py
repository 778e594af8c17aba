"""The extraction step's share of the card's peak: ResSegNetV2's
operations at each image's true size (``flops.network_flops``, the
frozen table), over the window's images and wall time, over 989
TFLOP/s (bf16, the trunk's stated precision), in %. The window's time
leaves out the seconds in which the profiler's start held the loop."""

from portbench.flops import PEAK_FLOPS, network_flops


def read(ctx):
    done = ctx.get("images_done")
    if not done or ctx["window_s"] <= 0:
        return None
    flops = done * network_flops(1, ctx["height"], ctx["width"])
    return 100.0 * flops / ctx["window_s"] / PEAK_FLOPS["bf16"]
