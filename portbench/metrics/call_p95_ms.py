"""95th percentile (nearest rank) of every call of the window, in ms: one
IC from its call to its arrays on the host, or one batch from its enqueue
to its arrays handed over on the host."""

from portbench.yardstick.stats import percentile


def read(ctx):
    if not ctx.records:
        return None
    return 1e3 * percentile([te - ts for ts, te, _ in ctx.records], 95)
