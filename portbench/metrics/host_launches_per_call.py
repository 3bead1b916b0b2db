"""Host calls that put work on a stream (kernel launches, graph launches,
asynchronous copies and fills), per call of the window traced with the
host's activity."""

from portbench.yardstick import trace as T


def read(ctx):
    if ctx.host_span is None:
        return None
    n = T.host_launches(ctx.host_events, ctx.host_span)
    return n / ctx.host_calls if n and ctx.host_calls else None
