"""Stage timers, profiler traces and allocator statistics.

* :func:`stage`: a wall-clock timer around a stage that waits for the
  tensors the stage produced, each on its own device, before it stops
  (CUDA work is asynchronous: without the wait the timer measures the
  enqueue);
* :func:`trace`: ``torch.profiler`` over CPU and CUDA activities, written
  as a Chrome trace into a directory;
* :func:`device_memory_stats`: the caching allocator's statistics of
  every visible card.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch

from .logging import mylog

__all__ = ["stage", "StageTimes", "trace", "device_memory_stats"]


@dataclass
class StageTimes:
    """Accumulated per-stage wall times (seconds)."""

    times: dict = field(default_factory=dict)

    def add(self, name: str, dt: float):
        self.times[name] = self.times.get(name, 0.0) + dt

    def report(self):
        for name, dt in sorted(self.times.items(), key=lambda kv: -kv[1]):
            mylog.info("stage %-30s %8.3f s", name, dt)
        return dict(self.times)


def _tensors(obj):
    """Every tensor in ``obj``: a tensor, or a (nested) list, tuple or
    dict of them."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


def _wait_for(result_holder):
    """Synchronize each CUDA device that holds a tensor of the holder."""
    devices = {t.device for r in result_holder for t in _tensors(r)
               if t.device.type == "cuda"}
    for d in devices:
        torch.cuda.synchronize(d)


@contextlib.contextmanager
def stage(name: str, result_holder=None, accumulate: StageTimes | None = None,
          log: bool = True):
    """Time a pipeline stage, waiting for its device work.

    Usage::

        holder = []
        with stage("eddington", holder):
            holder.append(compute_df(ee, pden))

    Before the timer stops, every CUDA device that holds a tensor appended
    to ``result_holder`` (or nested in a list, tuple or dict appended to
    it) is synchronized, so asynchronous launches cannot hide the cost.
    """
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if result_holder:
            _wait_for(result_holder)
        dt = time.perf_counter() - t0
        if accumulate is not None:
            accumulate.add(name, dt)
        if log:
            mylog.info("stage %s: %.3f s", name, dt)


@contextlib.contextmanager
def trace(logdir: str):
    """``torch.profiler`` over CPU and (with a card) CUDA activities; on
    exit the Chrome trace ``trace.json`` is written into ``logdir``
    (created if needed; view it in ``chrome://tracing`` or Perfetto).
    Yields the profiler, whose ``key_averages()`` sums by op and kernel."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(path)
    mylog.info("profiler trace written to %s", path)


def device_memory_stats():
    """Per-card allocator statistics (bytes and counts,
    ``torch.cuda.memory_stats``), keyed ``"cuda:<index>"``.  With no card
    the CPU is the one device, and it reports nothing: ``{"cpu": None}``."""
    if not torch.cuda.is_available():
        return {"cpu": None}
    return {f"cuda:{i}": torch.cuda.memory_stats(i)
            for i in range(torch.cuda.device_count())}
