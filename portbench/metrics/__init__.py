"""One reader per metric, found by the metric's name: ``read(ctx)`` returns
the value, or ``None`` when the run holds nothing to read it from.  ``ctx``
carries the run's calls (``records``: host-clock ``(start, end, units)``),
``window_s``, ``setup_s``, ``unit``, ``peak_bytes``, ``k1_shapes``,
``device_name``, ``n_calls`` and, in a traced run, the length of the
traced calls run with no profiler (``untraced_s``), the device's events of
the same calls traced with device activity alone (``events`` inside
``span``, ``traced_s`` long), and the events of the same calls traced with
host activity too (``host_events`` inside ``host_span``, over
``host_calls`` calls)."""
