"""The profiler's events as plain records, and the arithmetic on them that
the per-layer readers share: device busy time as a union of intervals, the
host calls that put work on a stream, copies by direction, kernel time by
name, and the idle gaps of the device.

An event is ``Event(kind, name, start_us, dur_us)``.  ``kind`` is the
profiler's activity type: ``kernel``, ``gpu_memcpy``, ``gpu_memset``
(device work), ``cuda_runtime`` / ``cuda_driver`` (host calls into CUDA),
``cpu_op``, ``user_annotation`` (spans the harness records), and others
that no reader uses.  Times are microseconds on the profiler's clock, which
host and device events share.
"""

from __future__ import annotations

import re
from typing import NamedTuple

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")

# host calls that enqueue work on a stream (kernels, graphs, copies, fills)
HOST_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                 "cudaMemsetAsync")


RUNTIME = re.compile(r"^cuda[A-Z]")
DRIVER = re.compile(r"^cu[A-Z]")


class Event(NamedTuple):
    kind: str
    name: str
    start_us: float
    dur_us: float

    @property
    def end_us(self):
        return self.start_us + self.dur_us


def _kind(e):
    """The activity type of a profiler event, or, where this PyTorch does
    not give it, the same worked out from the device and the name."""
    if hasattr(e, "activity_type"):
        return str(e.activity_type())
    name = e.name()
    if str(e.device_type()).endswith("CUDA"):
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    if RUNTIME.match(name):
        return "cuda_runtime"
    if DRIVER.match(name):
        return "cuda_driver"
    return "cpu_op"


def events_of(prof):
    """Every event a finished ``torch.profiler.profile`` recorded.  A span
    the host annotated is mirrored on the device's timeline under the same
    name; that mirror is no device work, and is kept as an annotation."""
    out = [Event(_kind(e), e.name(), e.start_ns() / 1e3,
                 e.duration_ns() / 1e3)
           for e in prof.profiler.kineto_results.events()]
    host = {e.name for e in out if e.kind not in DEVICE_KINDS}
    return [e._replace(kind="gpu_user_annotation")
            if e.kind in DEVICE_KINDS and e.name in host else e for e in out]


def span(events, name):
    """``(start_us, end_us)`` of the host span ``name`` (the longest)."""
    found = [e for e in events if e.name == name
             and e.kind not in DEVICE_KINDS]
    if not found:
        return None
    e = max(found, key=lambda e: e.dur_us)
    return e.start_us, e.end_us


def extent(events):
    """``(first start, last end)`` of ``events`` in microseconds; ``(0,
    0)`` when there are none."""
    if not events:
        return 0.0, 0.0
    return (min(e.start_us for e in events), max(e.end_us for e in events))


def within(events, window, kinds=None):
    """The events of ``kinds`` that overlap ``window``, clipped to it."""
    lo, hi = window
    out = []
    for e in events:
        if kinds is not None and e.kind not in kinds:
            continue
        s, t = max(e.start_us, lo), min(e.end_us, hi)
        if t > s or (t == s and e.dur_us == 0 and lo <= s <= hi):
            out.append(Event(e.kind, e.name, s, t - s))
    return out


def union(intervals):
    """Merged ``[(start, end)]``, sorted, of possibly overlapping ones."""
    merged = []
    for s, t in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if t > merged[-1][1]:
                merged[-1][1] = t
        else:
            merged.append([s, t])
    return [(s, t) for s, t in merged]


def busy_us(events, window):
    """Microseconds of ``window`` in which a kernel, a copy or a fill ran
    on the device."""
    dev = within(events, window, DEVICE_KINDS)
    return sum(t - s for s, t in union((e.start_us, e.end_us) for e in dev))


def idle_gaps(events, window):
    """The stretches of ``window`` with no device work, longest first, each
    ``(start_us, end_us)``."""
    lo, hi = window
    busy = union((e.start_us, e.end_us)
                 for e in within(events, window, DEVICE_KINDS))
    gaps, cur = [], lo
    for s, t in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, t)
    if hi > cur:
        gaps.append((cur, hi))
    return sorted(gaps, key=lambda g: g[0] - g[1])


def host_launches(events, window):
    """Host calls in ``window`` that put work on a stream."""
    return sum(1 for e in within(events, window, ("cuda_runtime",
                                                  "cuda_driver"))
               if e.name in HOST_LAUNCHES)


def copy_us(events, window, direction="DtoH"):
    """Device microseconds of the copies of ``direction`` (``DtoH``,
    ``HtoD``, ``DtoD``) in ``window``."""
    return sum(e.dur_us for e in within(events, window, ("gpu_memcpy",))
               if direction in e.name)


def kernel_us(events, window, match):
    """``(device microseconds, count)`` of the kernels whose name contains
    ``match``."""
    ks = [e for e in within(events, window, ("kernel",)) if match in e.name]
    return sum(e.dur_us for e in ks), len(ks)


def device_ops(events, window, top=10):
    """The device operations that took most time: ``[(name, seconds)]``."""
    tot = {}
    for e in within(events, window, DEVICE_KINDS):
        tot[e.name] = tot.get(e.name, 0.0) + e.dur_us
    ranked = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
    return [[name[:200], us / 1e6] for name, us in ranked]


def gap_causes(events, window, top=10):
    """The longest idle gaps of the device, each named by what the host
    was doing then: the host event (a CUDA call, an operator, an
    annotation other than the window's) that covers most of the gap."""
    host = [e for e in events if e.kind in ("cuda_runtime", "cuda_driver",
                                            "cpu_op", "user_annotation")]
    out = []
    for s, t in idle_gaps(events, window)[:top]:
        best, cover = "host", 0.0
        for e in host:
            c = min(e.end_us, t) - max(e.start_us, s)
            if c > cover and (t - s) > 0 and not (
                    e.start_us <= window[0] and e.end_us >= window[1]):
                best, cover = e.name, c
        out.append([best[:200], (t - s) / 1e6])
    return out
