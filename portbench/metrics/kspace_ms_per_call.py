"""Device time of the stage ``kspace`` per field, in ms: the spectrum's
shaping, the power sums, the projection with its rescale and the vector
potential. The work on the card from each ``cg_stage_kspace`` mark to the
next mark, copies to the host left out, over the complete mark sequences
(one a field) of the calls traced with device activity alone
(``portbench.yardstick.stages``)."""

from portbench.yardstick import stages


def read(ctx):
    return stages.stage_ms_per_call(ctx.events, ctx.span, "kspace")
