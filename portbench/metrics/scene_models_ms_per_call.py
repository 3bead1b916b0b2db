"""Device time of the IC scene's stage ``models`` per IC, in ms: the halos'
model builds with their profile set-up
(``ClusterModel.from_dens_and_tden``, ``find_radius_mass``), the DFs
left out. The work on the card from each ``cg_stage_models`` mark to the
next mark, copies to the host left out, over the complete mark sequences
(one an IC) of the calls traced with device activity alone."""

from portbench.yardstick import scene


def read(ctx):
    return scene.stage_ms(ctx, "models")
