"""The segmentation step's share of the card's peak: the network's
operations on each image's slide crops (``flops_segment.image_flops``:
two 512² crops of a 1600×1200 image resized into 2048×512), over the
window's images and wall time, over 989 TFLOP/s (float16 on the tensor
cores, the forward's stated precision), in %. The window's time leaves
out the seconds in which the profiler's start held the loop."""

from portbench.flops_segment import PEAK_FP16, image_flops


def read(ctx):
    done, config = ctx.get("images_done"), ctx.get("config")
    if not done or not config or ctx.get("window_s", 0) <= 0:
        return None
    flops = done * image_flops(config, ctx["height"], ctx["width"])
    return 100.0 * flops / ctx["window_s"] / PEAK_FP16
