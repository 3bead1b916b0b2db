"""Programs the port captured per call (``core.compiled.captures`` before
and after the calls traced with device activity alone, as the driver
counts them): a capture in the measured calls is a count that fell in a
capacity class set-up did not capture, or a program released for room."""

from portbench.yardstick import scene


def read(ctx):
    return scene.captures_per_call(ctx)
