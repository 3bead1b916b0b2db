"""Host time of the program's own work per call, in ms: the ``cg.host.*``
spans the port records while a profiler runs (its inputs, the copies into
the static buffers, the uniforms, the output clones, the staging copies
enqueued, the host arrays unpacked), summed over the calls traced with
host activity.  Waits (``cg.wait.*``) and the graph's launch
(``cg.launch``) are left out.  Read under the CPU profiler, which adds its
own cost to each operator."""

from portbench.yardstick import stages


def read(ctx):
    if ctx.host_span is None or not ctx.host_calls:
        return None
    ms = stages.host_ms(ctx.host_events, ctx.host_span)
    return ms / ctx.host_calls if ms else None
