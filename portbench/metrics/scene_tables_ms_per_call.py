"""Device time of the IC scene's stage ``tables`` per IC, in ms: each
halo's and species' draw tables (radius nodes, speed table with K1,
joint table). The work on the card from each ``cg_stage_tables`` mark to
the next mark, copies to the host left out, over the complete mark
sequences (one an IC) of the calls traced with device activity alone."""

from portbench.yardstick import scene


def read(ctx):
    return scene.stage_ms(ctx, "tables")
