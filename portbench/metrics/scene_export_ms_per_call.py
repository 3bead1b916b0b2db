"""Device time of the IC scene's stage ``export`` per IC, in ms: the Gadget
blocks: in-box selection, unit scaling, float32 casts, IDs. The work on
the card from each ``cg_stage_export`` mark to the next mark, copies to
the host left out, over the complete mark sequences (one an IC) of the
calls traced with device activity alone."""

from portbench.yardstick import scene


def read(ctx):
    return scene.stage_ms(ctx, "export")
