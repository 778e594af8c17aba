"""K2's share of its roofline in the traced part of the window: the least
time of the pairs the matcher wrote there (for each, 2·K·K·C over 495
TFLOP/s, the rate for float32 operands on the tensor cores, against both
banks, both masks and the outputs once over 3.35 TB/s, the larger; banks
of distinct images, as ``match_pairs`` batches them) over the profiler's
time of K2's kernels (``prep_kernel``, ``nn_tc_kernel``,
``match_epilogue``: no other matcher runs in a map build's NNM), in %."""

from portbench.flops import match_cost, roofline_share
from portbench.trace import kernel_seconds

K2_KERNELS = ("prep_kernel", "nn_tc_kernel", "match_epilogue")


def read(ctx):
    trace, work = ctx.get("trace"), ctx.get("k2_work")
    if not trace or not work or not sum(w[0] for w in work):
        return None
    flops = nbytes = 0.0
    for b, n1, n2, c in work:
        f, by = match_cost(b, n1, n2, c, broadcast=False)
        flops, nbytes = flops + f, nbytes + by
    return roofline_share(flops, nbytes, kernel_seconds(trace, *K2_KERNELS), "tf32")
