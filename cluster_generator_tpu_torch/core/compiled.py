"""Captured batch programs: CUDA graphs memoized by configuration and shape.

The counterpart of the JAX package's compiled programs: there each batch
program is ``jax.jit``-ed behind a factory's ``lru_cache``, compiled once
per configuration and shape, and run again with new inputs.  Here a
:class:`Program` is one batch program at one configuration and shape,
looked up by :func:`program` under a key that holds every value its body
takes as a Python number or a shape.  On a CUDA device the program

* on its first call copies the inputs into static buffers of its own, runs
  the body once eagerly on a side stream, returns that run's outputs, and
  captures the body into a CUDA graph on the same stream.  The eager run
  warms every lazy set-up the capture must not do: cuBLAS's workspace,
  the kernels' libraries and their launch caches, the constants a body
  copies to the card once;
* on every later call copies the inputs into the static buffers (the
  uniforms are drawn straight into theirs), replays the graph on the
  current stream and returns copies of the static outputs, so a caller may
  hold one batch's outputs while the next batch replays.

A value that the capture bakes in (a count, ``z``, a table knob) is in the
key and never an input; every input is a tensor whose shape and type join
the key.  A failed capture raises: nothing falls back to the eager body on
the card.  A CPU tensor runs the eager body, the graph's plain version;
any other device raises.

Random numbers: a caller's generator stays outside the graph.  Before each
replay the uniforms are drawn eagerly from it into the static buffers, by
the calls the eager body would make, so a replay equals the eager run bit
for bit.  Registering a generator with the graph
(``CUDAGraph.register_generator_state``) would tie the graph to fixed
generator objects, while the batch streams give every batch a generator of
its own.

Memory: the programs of a device capture into one shared pool, which is
safe because their replays never overlap (each call waits for the
device's previous program call, on whatever stream it ran) and a program
reads its static outputs only right after its own replay.  The memo holds
at most :data:`MAX_PROGRAMS` programs, the least recently used goes first;
:func:`clear` drops them all and returns their memory to the card.

Kernel launches: a wrapper counts each launch with :func:`count_launch`.
A launch recorded into a graph is counted on each replay instead, once
per node, so a wrapper's ``launches`` counts the launches the card runs.
"""

from __future__ import annotations

import time
from collections import OrderedDict

import torch

__all__ = ["MAX_PROGRAMS", "Program", "run", "program", "programs",
           "clear", "count_launch", "drawer", "tree_map"]

MAX_PROGRAMS = 8

_PROGRAMS: OrderedDict = OrderedDict()
_DEVICES: dict = {}
# kernel wrapper -> launches recorded by the capture in progress
_TALLY: dict | None = None


def tree_map(fn, tree):
    """``fn`` on every tensor of a tree of dicts, tuples and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def _copy(dst, src):
    if isinstance(dst, dict):
        for k in dst:
            _copy(dst[k], src[k])
    elif isinstance(dst, (tuple, list)):
        for d, s in zip(dst, src):
            _copy(d, s)
    else:
        dst.copy_(src)


def drawer(uniforms, generator, device, draw):
    """The ``draw`` of a program call: the caller's ``uniforms`` (copied
    into the static buffers, or cloned when there are none yet), else
    ``draw(generator, out)`` with ``generator`` (default: one on
    ``device`` seeded with 0)."""
    if uniforms is not None:
        def given(out):
            if out is None:
                return tree_map(torch.clone, uniforms)
            _copy(out, uniforms)
            return out
        return given
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return lambda out: draw(generator, out)


def count_launch(kernel) -> None:
    """Count one launch of the hand-written kernel whose wrapper is
    ``kernel`` (its ``launches`` attribute).  A launch being captured is
    no launch: the capture of a :class:`Program` notes it, and each replay
    of that graph adds it; a capture by anyone else is not counted."""
    if _TALLY is not None:
        _TALLY[kernel] = _TALLY.get(kernel, 0) + 1
        return
    if (torch.cuda.is_initialized()
            and torch.cuda.is_current_stream_capturing()):
        return
    kernel.launches += 1


class _Device:
    """What the programs of one card share: the memory pool, the side
    stream of warm-ups and captures, and the event after the last program
    call."""

    def __init__(self, device):
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)
        self.done = None

    def wait(self, stream):
        if self.done is not None:
            stream.wait_event(self.done)

    def record(self, stream):
        self.done = torch.cuda.Event()
        self.done.record(stream)


class Program:
    """One batch program at one configuration and shape.

    ``body(*inputs, uniforms)`` is the eager program: tensors in, a tree of
    tensors out.  Call the program as ``prog(inputs, draw)``: ``inputs`` a
    tuple of tensors, ``draw(out)`` the uniforms: drawn into the tree
    ``out`` in place and returned, or, with ``out=None``, returned as new
    tensors.

    After the capture: ``capture_s`` (host seconds of the capture),
    ``pool_bytes`` (what the capture added to the device's shared pool),
    ``static_bytes`` (the static inputs, uniforms and outputs) and
    ``nodes`` (the counted kernels' launches per replay).
    """

    def __init__(self, key, body):
        self.key = key
        self.body = body
        self.graph = None
        self.inputs = self.uniforms = self.outputs = None
        self.nodes: dict = {}
        self.capture_s = None
        self.pool_bytes = None
        self.static_bytes = None

    def __call__(self, inputs, draw):
        dev = inputs[0].device
        if dev.type == "cpu":
            return self.body(*inputs, draw(None))
        if dev.type != "cuda":
            raise ValueError(f"batch programs run on cuda or cpu, not {dev}")
        with torch.cuda.device(dev):
            state = _DEVICES.get(dev)
            if state is None:
                state = _DEVICES[dev] = _Device(dev)
            cur = torch.cuda.current_stream(dev)
            state.wait(cur)
            if self.graph is None:
                out = self._capture(state, cur, inputs, draw)
            else:
                out = self._replay(cur, inputs, draw)
            state.record(cur)
        return out

    def _capture(self, state, cur, inputs, draw):
        global _TALLY
        self.inputs = tuple(a.detach().clone(
            memory_format=torch.contiguous_format) for a in inputs)
        self.uniforms = draw(None)
        side = state.stream
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = self.body(*self.inputs, self.uniforms)
        # the warm-up's outputs are the caller's, used on its stream
        tree_map(lambda t: t.record_stream(cur), out)
        cur.wait_stream(side)

        torch.cuda.synchronize(inputs[0].device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(inputs[0].device)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        _TALLY = {}
        try:
            with torch.cuda.graph(graph, pool=state.pool, stream=side):
                outputs = self.body(*self.inputs, self.uniforms)
            self.nodes = _TALLY
        finally:
            _TALLY = None
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = (torch.cuda.memory_reserved(inputs[0].device)
                           - reserved)
        self.graph, self.outputs = graph, outputs
        self.static_bytes = _nbytes((self.inputs, self.uniforms, outputs))
        return out

    def _replay(self, cur, inputs, draw):
        for buf, a in zip(self.inputs, inputs):
            if buf.shape != a.shape:
                raise ValueError(f"input of shape {tuple(a.shape)} for a "
                                 f"program captured at {tuple(buf.shape)}")
            buf.copy_(a)
        draw(self.uniforms)
        self.graph.replay()
        out = tree_map(torch.clone, self.outputs)
        for kernel, n in self.nodes.items():
            kernel.launches += n
        return out


def run(key, body, inputs, draw):
    """``body(*inputs, draw(None))``, as the memoized program of ``key``
    and the inputs' device, shapes and types (see :class:`Program`)."""
    return program(key, body, inputs)(inputs, draw)


def program(key, body, inputs) -> Program:
    """The memoized program of ``key`` at the device, shapes and types of
    ``inputs``; made with ``body`` when the memo has none (past
    :data:`MAX_PROGRAMS` the least recently used program goes)."""
    key = (key, inputs[0].device,
           tuple((tuple(a.shape), a.dtype) for a in inputs))
    prog = _PROGRAMS.get(key)
    if prog is None:
        prog = _PROGRAMS[key] = Program(key, body)
        while len(_PROGRAMS) > MAX_PROGRAMS:
            _PROGRAMS.popitem(last=False)
    else:
        _PROGRAMS.move_to_end(key)
    return prog


def programs() -> list:
    """The memoized programs, least recently used first."""
    return list(_PROGRAMS.values())


def clear() -> None:
    """Drop every memoized program and return their memory to the card
    (a program a caller still holds keeps its graph)."""
    _PROGRAMS.clear()
    _DEVICES.clear()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
