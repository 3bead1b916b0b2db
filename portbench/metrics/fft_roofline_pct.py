"""The transforms' share of their roofline, in percent: the least time
their bytes take at the card's memory rate over the device time of the
stage ``fft`` per field.  The bytes are six transforms of the call's grid,
each reading its input once and writing its output once
(``portbench.yardstick.field_bytes``)."""

from portbench.yardstick import field_bytes, peaks, stages


def read(ctx):
    pk = peaks.peaks(ctx.device_name)
    grid = field_bytes.grid_of(ctx)
    ms = stages.stage_ms_per_call(ctx.events, ctx.span, "fft")
    if pk is None or grid is None or not ms:
        return None
    least_ms = field_bytes.fft_bytes(*grid) / pk["hbm_bytes_per_s"] * 1e3
    return 100.0 * least_ms / ms
