"""The k-space stage's share of its roofline, in percent: the least time
its bytes take at the card's memory rate over the device time of the stage
``kspace`` per field.  The bytes are the three half spectra read once and
written once (``portbench.yardstick.field_bytes``), whatever implements the
stage."""

from portbench.yardstick import field_bytes, peaks, stages


def read(ctx):
    pk = peaks.peaks(ctx.device_name)
    grid = field_bytes.grid_of(ctx)
    ms = stages.stage_ms_per_call(ctx.events, ctx.span, "kspace")
    if pk is None or grid is None or not ms:
        return None
    least_ms = field_bytes.kspace_bytes(*grid) / pk["hbm_bytes_per_s"] * 1e3
    return 100.0 * least_ms / ms
