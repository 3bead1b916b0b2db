"""Share of the window in which no kernel, copy or fill ran on the card, in
percent: over the calls traced with the device's activity alone, their
busy time against their length on the host clock."""

from portbench.yardstick import trace as T


def read(ctx):
    if not ctx.events or ctx.traced_s <= 0:
        return None
    busy = T.busy_us(ctx.events, ctx.span)
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / (ctx.traced_s * 1e6))
