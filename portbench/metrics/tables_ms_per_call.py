"""Device time of the stage ``tables`` per program call, in ms: the speed
tables with K1, the radius and joint tables. The work on the card from
each ``cg_stage_tables`` mark that the program records to the next mark,
copies to the host left out, over the complete mark sequences of the calls
traced with device activity alone (``portbench.yardstick.stages``)."""

from portbench.yardstick import stages


def read(ctx):
    return stages.stage_ms_per_call(ctx.events, ctx.span, "tables")
