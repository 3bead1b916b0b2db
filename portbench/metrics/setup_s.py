"""Seconds from the start of the run to its first timed call."""


def read(ctx):
    return ctx.setup_s
