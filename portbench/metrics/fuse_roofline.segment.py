"""The tail kernel's share of its roofline in the traced part of the
window: the least time of its label launches there (``flops_segment
.tail_cost``: the two bilinear stages, the average and the argmax on the
CUDA cores at 67 TFLOP/s, against the float32 logits in and the uint8
labels out at 3.35 TB/s, the larger) over the profiler's time of
``_segment_tail_kernel``, in %."""

from portbench.flops_segment import roofline_share, tail_cost
from portbench.trace import kernel_seconds


def read(ctx):
    trace, launches = ctx.get("trace"), ctx.get("tail_launches")
    if not trace or not launches:
        return None
    flops = nbytes = 0.0
    for key, n in launches.items():
        if key[-1]:  # label launches: the timed path's
            f, by = tail_cost(*key[:-1])
            flops, nbytes = flops + n * f, nbytes + n * by
    return roofline_share(flops, nbytes, kernel_seconds(trace, "segment_tail"))
