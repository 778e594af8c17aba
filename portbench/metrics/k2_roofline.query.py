"""K2's share of its roofline in the traced part of the window: the least
time of the match calls made there (for each, 2·N1·N2·C per real DB bank
over 495 TFLOP/s, the rate for float32 operands on the tensor cores,
against the broadcast query, the banks, both masks and the outputs once
over 3.35 TB/s, the larger) over the profiler's time of K2's kernels
(``prep_kernel``, ``nn_tc_kernel``, ``match_epilogue``: no other matcher
runs on the query path), in %. The engine's all-invalid padding banks
are not counted: they need no work."""

from portbench.flops import match_cost, roofline_share
from portbench.trace import kernel_seconds

K2_KERNELS = ("prep_kernel", "nn_tc_kernel", "match_epilogue")


def read(ctx):
    trace, work = ctx.get("trace"), ctx.get("k2_work")
    if not trace or not work:
        return None
    flops = nbytes = 0.0
    for b, n1, n2, c in work:
        f, by = match_cost(b, n1, n2, c, broadcast=True)
        flops, nbytes = flops + f, nbytes + by
    return roofline_share(flops, nbytes, kernel_seconds(trace, *K2_KERNELS), "tf32")
