"""Device time of the copies to the host, per call of the traced window,
in ms."""

from portbench.yardstick import trace as T


def read(ctx):
    us = T.copy_us(ctx.events, ctx.span, "DtoH")
    return us / 1e3 / ctx.n_calls if us and ctx.n_calls else None
