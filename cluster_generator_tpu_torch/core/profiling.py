"""Stage timers, stage marks, host spans, profiler traces and allocator
statistics.

* :func:`stage`: a wall-clock timer around an eager stage that waits for
  the tensors the stage produced, each on its own device, before it stops
  (CUDA work is asynchronous: without the wait the timer measures the
  enqueue);
* :func:`device_stage`: marks where a stage of a program body begins and
  ends on the card's stream, by an empty kernel named after the stage
  (``cg_stage_models``, ``cg_stage_dfs``, ``cg_stage_tables``,
  ``cg_stage_draws``, ``cg_stage_mix``, ``cg_stage_export``, the random
  fields' ``cg_stage_noise``, ``cg_stage_fft`` and ``cg_stage_kspace``,
  and ``cg_stage_end``; ``ops/csrc/stage_marks.cu``).  Inside a captured
  program the marks are recorded into the graph, so a device trace of a
  replay splits its kernels by stage, where :func:`stage` sees only the
  whole replay; eager paths (the class path, an IC scene) mark the same
  way around their program calls, and :func:`device_sequence` makes the
  stages of a whole product (one IC) one sequence closed by one ``end``;
  :func:`device_mark` opens a stage that the next mark closes (a field's
  white noise, drawn on the stream just before its program's replay);
* :func:`span`: a named range of host work on the profiler's clock, the
  timeline of the card's kernels and copies, recorded only while a
  profiler runs (one flag check otherwise);
* :func:`trace`: ``torch.profiler`` over CPU and CUDA activities, written
  as a Chrome trace into a directory: kernels, marks and spans together;
* :func:`device_memory_stats`: the caching allocator's statistics of
  every visible card.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import os
import threading
import time
from dataclasses import dataclass, field

import torch
import torch.autograd.profiler as _autograd_profiler

from .logging import mylog

__all__ = ["stage", "StageTimes", "device_stage", "device_sequence",
           "device_mark", "STAGES", "span", "trace", "device_memory_stats"]

#: the stages a program body or an eager path marks, and ``end``, in the
#: order of the mark kernels' C entry point (``cg_stage_mark``): the
#: random fields' stages after ``end``, so that the others keep their
#: numbers
STAGES = ("models", "dfs", "tables", "draws", "mix", "export", "end",
          "noise", "fft", "kspace")


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
    """Time an eager pipeline stage, waiting for its device work.

    It times stages run eagerly, one call each.  Inside a captured
    program (every main path on the card) the stages run as one graph
    replay, which this cannot split: there :func:`device_stage` marks
    each stage on the device, and a device trace of the replay times it.

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


_local = threading.local()


def _open_stages() -> list:
    """The stages open on this thread, outermost first; ``None`` for an
    open :func:`device_sequence`."""
    stack = getattr(_local, "stages", None)
    if stack is None:
        stack = _local.stages = []
    return stack


@functools.lru_cache(maxsize=None)
def _mark_kernel():
    """The mark kernels' C entry point, built and bound once."""
    from ..ops.build import load_library

    fn = load_library("stage_marks").cg_stage_mark
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _stage_name(name: str) -> str:
    """``name`` if it is a stage that can be marked (any of
    :data:`STAGES` but ``end``), else a ``ValueError``."""
    if name == "end" or name not in STAGES:
        raise ValueError(f"stage must be one of "
                         f"{tuple(s for s in STAGES if s != 'end')}, got "
                         f"{name!r}")
    return name


def _mark(name: str, device: torch.device) -> None:
    """Launch the mark kernel of stage ``name`` on ``device``'s current
    stream (recorded into the graph while one is captured there); on any
    other device than a card, nothing."""
    if device.type != "cuda":
        return
    fn = _mark_kernel()
    which = STAGES.index(name)
    with torch.cuda.device(device):
        err = fn(which, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"stage mark {name!r}: launch failed, "
                           f"cudaError_t {err}")


@contextlib.contextmanager
def device_stage(name: str, like: torch.Tensor):
    """Mark stage ``name`` (any of :data:`STAGES` but ``end``) of the work
    enqueued inside, on the current stream of ``like``'s card.

    Entering marks ``name``; leaving marks the enclosing stage again,
    nothing directly inside a :func:`device_sequence` (the next stage's
    mark, or the sequence's ``end``, closes it), or ``end`` at the
    outermost level.  So a stage's device work is everything on the stream
    from its mark to the next mark, and stages nest: a DF computed inside
    the model build hands back to ``models`` afterwards.
    Each mark is one empty one-thread kernel named ``cg_stage_<name>``;
    inside a program's capture it becomes a node of the graph, which each
    replay runs with no host call.  On the CPU nothing is launched.  A
    stage left by an exception marks nothing more."""
    _stage_name(name)
    device = like.device
    stack = _open_stages()
    _mark(name, device)
    stack.append(name)
    try:
        yield
    finally:
        stack.pop()
    _close(stack, device)


def _close(stack, device):
    """The mark that hands back from a stage or sequence just left."""
    outer = stack[-1] if stack else "end"
    if outer is not None:
        _mark(outer, device)


def device_mark(name: str, like: torch.Tensor) -> None:
    """Mark the start of stage ``name`` (any of :data:`STAGES` but
    ``end``) on the current stream of ``like``'s card, handing nothing
    back: the next mark closes it.  For work enqueued just before a
    program's replay, outside its graph, whose body's first mark follows
    it on the stream: a field's white noise, drawn into the program's
    buffer before each replay, is stage ``noise`` up to the body's first
    transform.  On the CPU nothing is launched."""
    _mark(_stage_name(name), like.device)


@contextlib.contextmanager
def device_sequence(device):
    """Make the stages marked inside (:func:`device_stage`) one sequence on
    ``device``'s current stream, closed by one ``end`` when it is left:
    a stage left directly inside it marks nothing, so the next stage's
    mark closes it.  For a product made by several eager calls, each of
    which marks its own stages (an IC scene: the models and DFs of each
    halo, the draw tables and draws of each species, the gas mixing, the
    Gadget blocks), so that a device trace reads each stage once per
    product.  Inside a stage it hands back to that stage.  On the CPU
    nothing is launched; left by an exception it marks nothing more."""
    device = torch.device(device)
    stack = _open_stages()
    stack.append(None)
    try:
        yield
    finally:
        stack.pop()
    _close(stack, device)


_NO_SPAN = contextlib.nullcontext()


class _Span:
    """A profiler range that is a leaf: none opens while another is open
    on the same thread."""

    __slots__ = ("name", "rf")

    def __init__(self, name):
        self.name = name
        self.rf = None

    def __enter__(self):
        if getattr(_local, "span", False):
            return self
        _local.span = True
        self.rf = _autograd_profiler.record_function(self.name)
        self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
            self.rf = None
            _local.span = False
        return False


def span(name: str):
    """A context manager naming the host work inside ``name`` on the
    profiler's clock.  With no profiler recording it is one flag check and
    a shared null context.  While one records it is a ``record_function``
    range, so it lands on the timeline of the card's kernels and copies;
    a span opened inside another is not recorded, so that the spans of a
    trace never nest and each names the host work it holds alone."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Span(name)


@contextlib.contextmanager
def trace(logdir: str):
    """``torch.profiler`` over CPU and (with a card) CUDA activities, with
    the program's stage marks (:func:`device_stage`) among the kernels and
    its host spans (:func:`span`) among the host's events; on exit the
    Chrome trace ``trace.json`` is written into ``logdir``
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
