"""Device time of the IC scene's stage ``mix`` per IC, in ms: the scene's
combine: the moves to the centers, the sum and the gas mixing
(``_mix_gas``). The work on the card from each ``cg_stage_mix`` mark to
the next mark, copies to the host left out, over the complete mark
sequences (one an IC) of the calls traced with device activity alone."""

from portbench.yardstick import scene


def read(ctx):
    return scene.stage_ms(ctx, "mix")
