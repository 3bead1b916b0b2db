"""K1's share of its roofline: the least time its bytes take at the card's
memory rate over K1's device time in the traced window.  The bytes of a
launch come from its shapes (``portbench.yardstick.kernels``); the calls
launch one per species, so the mean over the species' shapes times the
launches counted is the bytes moved."""

from portbench.yardstick import kernels, peaks
from portbench.yardstick import trace as T


def read(ctx):
    pk = peaks.peaks(ctx.device_name)
    us, count = T.kernel_us(ctx.events, ctx.span, kernels.K1_NAME)
    if pk is None or not count or us <= 0:
        return None
    per_launch = (sum(kernels.k1_bytes(*s) for s in ctx.k1_shapes)
                  / len(ctx.k1_shapes))
    least_us = count * per_launch / pk["hbm_bytes_per_s"] * 1e6
    return 100.0 * least_us / us
