"""Device time of the stage ``models`` per program call, in ms: the model
build of every halo or cluster (``build_one_cluster``, the merger's and
the batch's models), the DFs inside it left out. The work on the card from
each ``cg_stage_models`` mark that the program records to the next mark,
copies to the host left out, over the complete mark sequences of the calls
traced with device activity alone (``portbench.yardstick.stages``)."""

from portbench.yardstick import stages


def read(ctx):
    return stages.stage_ms_per_call(ctx.events, ctx.span, "models")
