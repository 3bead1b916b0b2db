"""Reads of device values by the host per call: the port's
``cg.wait.read`` spans (a model field's host copy, a scene's generator
seeds, the Gadget blocks' in-box counts) over the calls traced with host
activity."""

from portbench.yardstick import scene


def read(ctx):
    return scene.reads_per_call(ctx)
