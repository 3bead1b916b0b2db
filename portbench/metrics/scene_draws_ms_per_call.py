"""Device time of the IC scene's stage ``draws`` per IC, in ms: each halo's
and species' draws at their capacity classes, the containers joined. The
work on the card from each ``cg_stage_draws`` mark to the next mark,
copies to the host left out, over the complete mark sequences (one an
IC) of the calls traced with device activity alone."""

from portbench.yardstick import scene


def read(ctx):
    return scene.stage_ms(ctx, "draws")
