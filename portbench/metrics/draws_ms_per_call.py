"""Device time of the stage ``draws`` per program call, in ms: the particle
draws, the gas mixing and the output assembly. The work on the card from
each ``cg_stage_draws`` mark that the program records to the next mark,
copies to the host left out, over the complete mark sequences of the calls
traced with device activity alone (``portbench.yardstick.stages``)."""

from portbench.yardstick import stages


def read(ctx):
    return stages.stage_ms_per_call(ctx.events, ctx.span, "draws")
