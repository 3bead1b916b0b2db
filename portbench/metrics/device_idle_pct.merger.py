"""Share of the merger calls' time in which no kernel, copy or fill ran on
the card, in percent.  Even the device's activity alone stretches a merger
call under the profiler (a graph launch of some thousand kernels takes
tens of ms), so the time is that of the same calls run with no profiler,
each from its start to its arrays on the host; the busy time is the
device's from the traced calls."""

from portbench.yardstick import trace as T


def read(ctx):
    if not ctx.events or ctx.untraced_s <= 0:
        return None
    busy = T.busy_us(ctx.events, ctx.span)
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / (ctx.untraced_s * 1e6))
