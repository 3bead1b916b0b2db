"""Device time of the stage ``fft`` per field, in ms: the forward and
inverse transforms of the three components with their slab copies. The
work on the card from each ``cg_stage_fft`` mark to the next mark, copies
to the host left out, over the complete mark sequences (one a field) of the
calls traced with device activity alone (``portbench.yardstick.stages``)."""

from portbench.yardstick import stages


def read(ctx):
    return stages.stage_ms_per_call(ctx.events, ctx.span, "fft")
