"""Host wall time inside ``LocalizationEngine._run_pnp`` (PnP-RANSAC from
its graphs, ending in a fetch) and ``_refine_batch`` (the refinement's
re-selection and LM, ending in a fetch) per request, in ms."""

from portbench.metrics_common import per_request_ms


def read(ctx):
    return per_request_ms(ctx, ("engine.pnp", "engine.refine"))
