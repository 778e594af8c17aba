"""K1's share of its roofline in the traced part of the window: the least
time of its launches there (conv1a and conv1b's operations over 495
TFLOP/s, the rate for float32 operands, against the float32 image in,
the weights and out1c out in the trunk's dtype over 3.35 TB/s, the
larger) over the profiler's time of ``stem_kernel``, in %."""

from portbench.flops import roofline_share, stem_cost
from portbench.trace import kernel_seconds


def read(ctx):
    trace, launches = ctx.get("trace"), ctx.get("k1_launches")
    if not trace or not launches:
        return None
    flops = nbytes = 0.0
    for (b, h, w), n in launches.items():
        f, by = stem_cost(b, h, w)
        flops, nbytes = flops + n * f, nbytes + n * by
    return roofline_share(flops, nbytes, kernel_seconds(trace, "stem_kernel"), "tf32")
