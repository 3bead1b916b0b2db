"""Device time of the IC scene's stage ``dfs`` per IC, in ms: the halos' DM
and stellar DFs (``VirialEquilibrium``'s Abel sums). The work on the
card from each ``cg_stage_dfs`` mark to the next mark, copies to the
host left out, over the complete mark sequences (one an IC) of the calls
traced with device activity alone."""

from portbench.yardstick import scene


def read(ctx):
    return scene.stage_ms(ctx, "dfs")
