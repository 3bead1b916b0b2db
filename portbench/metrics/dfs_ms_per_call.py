"""Device time of the stage ``dfs`` per program call, in ms: Eddington's DFs,
their Abel sums (``virial.compute_df``, ``om_extended_df``). The work on
the card from each ``cg_stage_dfs`` mark that the program records to the
next mark, copies to the host left out, over the complete mark sequences
of the calls traced with device activity alone
(``portbench.yardstick.stages``)."""

from portbench.yardstick import stages


def read(ctx):
    return stages.stage_ms_per_call(ctx.events, ctx.span, "dfs")
