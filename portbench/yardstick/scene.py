"""The IC scene's per-layer readings: each stage's device time per IC from
the port's marks, the programs captured per call from the driver's count,
and the host's reads per call from the port's ``cg.wait.read`` spans."""

from __future__ import annotations

from . import stages

READ = "cg.wait.read"


def stage_ms(ctx, stage):
    """Device milliseconds of ``stage`` per IC (one mark sequence each)."""
    return stages.stage_ms_per_call(ctx.events, ctx.span, stage)


def captures_per_call(ctx):
    """Programs captured per call of the device-traced window, or ``None``
    where the driver counts none."""
    n = getattr(ctx.records, "captures", None)
    if n is None or not ctx.records:
        return None
    return n / len(ctx.records)


def reads_per_call(ctx):
    """The host's reads of device values per call: its ``cg.wait.read``
    spans over the host-traced calls."""
    if ctx.host_span is None or not ctx.host_calls:
        return None
    return len(stages.spans(ctx.host_events, ctx.host_span, READ)) \
        / ctx.host_calls
