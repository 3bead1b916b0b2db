"""Device time of the stage ``noise`` per field, in ms: the white noise
drawn into the field program's buffer before its replay. The work on the
card from each ``cg_stage_noise`` mark to the next mark, copies to the host
left out, over the complete mark sequences (one a field) of the calls
traced with device activity alone (``portbench.yardstick.stages``)."""

from portbench.yardstick import stages


def read(ctx):
    return stages.stage_ms_per_call(ctx.events, ctx.span, "noise")
