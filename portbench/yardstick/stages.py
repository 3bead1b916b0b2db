"""The program's own marks and spans in a trace: device time by stage,
host time by span.

The port marks the stages of its program bodies on the card's stream with
empty kernels named ``cg_stage_<stage>`` (``models``, ``dfs``, ``tables``,
``draws``) and ``cg_stage_end``: a stage's device work is everything from
its mark to the next mark, and a stage nested in another hands back to it
by a mark of the outer stage.  A sequence is the marks from one ``end``
(or the window's start) to the next ``end``; one closed by ``end`` inside
the window is complete.  A window has to begin between two sequences, as
the harness's does (its span begins at the first traced call's first
device event); a sequence that the window's end cuts is left out.  Each
program call holds each of its stages in one complete sequence.

Its host work is named by spans (``record_function`` ranges) that never
nest: ``cg.host.*`` the host's own work, ``cg.wait.*`` waits, ``cg.launch``
the graph's launch.
"""

from __future__ import annotations

import bisect

from . import trace as T

MARK = "cg_stage_"
SPAN = "cg."
HOST = "cg.host."
# kinds of the host's own events (``cpu_op`` where PyTorch gives no
# activity type); a span's mirror on the device's timeline is neither
HOST_KINDS = ("user_annotation", "cpu_op")


def stage_of(name):
    """The stage a mark kernel's name carries (``end`` too), else
    ``None``."""
    i = name.find(MARK)
    if i < 0:
        return None
    rest = name[i + len(MARK):]
    j = 0
    while j < len(rest) and (rest[j].isalnum() or rest[j] == "_"):
        j += 1
    return rest[:j] or None


def marks(events, window):
    """The mark kernels that start inside ``window``, in order:
    ``[(start_us, stage)]``."""
    lo, hi = window
    return sorted((e.start_us, stage_of(e.name)) for e in events
                  if e.kind == "kernel" and stage_of(e.name) is not None
                  and lo <= e.start_us <= hi)


def sequences(events, window):
    """The complete sequences of marks inside ``window``, each a list of
    ``(start_us, stage)`` closed by ``end``."""
    out, cur = [], []
    for m in marks(events, window):
        cur.append(m)
        if m[1] == "end":
            out.append(cur)
            cur = []
    return out


def work(events):
    """The device's work other than the marks and the copies to the host
    (which run on a stream of their own, beside the stages): kernels,
    fills, other copies."""
    return [e for e in events if e.kind in T.DEVICE_KINDS
            and stage_of(e.name) is None
            and not (e.kind == "gpu_memcpy" and "DtoH" in e.name)]


def stretches(events, window):
    """Each stage's stretches of the complete sequences: ``[(sequence,
    stage, start_us, end_us)]``, from a mark of the stage to the next
    mark."""
    return [(i, stage, a, b)
            for i, seq in enumerate(sequences(events, window))
            for (a, stage), (b, _) in zip(seq, seq[1:])]


def _busy_between(merged, starts, a, b):
    """Microseconds of the merged intervals inside ``[a, b)``."""
    i = max(0, bisect.bisect_right(starts, a) - 1)
    total = 0.0
    while i < len(merged) and merged[i][0] < b:
        s, t = merged[i]
        total += max(0.0, min(t, b) - max(s, a))
        i += 1
    return total


def stage_us(events, window):
    """Device microseconds of each stage over the complete sequences, and
    how many complete sequences hold a mark of it: ``{stage: (us,
    sequences)}``."""
    merged = T.union((e.start_us, e.end_us)
                     for e in T.within(work(events), window))
    starts = [s for s, _ in merged]
    us, held = {}, {}
    for i, stage, a, b in stretches(events, window):
        us[stage] = us.get(stage, 0.0) + _busy_between(merged, starts, a, b)
        held.setdefault(stage, set()).add(i)
    return {stage: (t, len(held[stage])) for stage, t in us.items()}


def stage_ms_per_call(events, window, stage):
    """Device milliseconds of ``stage`` per complete sequence that holds
    it (one program call each), or ``None`` where no complete sequence
    does."""
    us, n = stage_us(events, window).get(stage, (0.0, 0))
    return us / 1e3 / n if n else None


def spans(events, window, prefix=SPAN):
    """The host's spans named ``prefix...`` inside ``window``, clipped."""
    return [e for e in T.within(events, window, HOST_KINDS)
            if e.name.startswith(prefix)]


def host_ms(events, window):
    """Milliseconds of the host's own work in ``window``: its ``cg.host.*``
    spans (waits, the graph's launch and set-up left out), or ``None``
    where there are none."""
    found = spans(events, window, HOST)
    return sum(e.dur_us for e in found) / 1e3 if found else None
