"""Captured programs: CUDA graphs memoized by configuration and shape.

The counterpart of the JAX package's compiled programs: there each batch
program is ``jax.jit``-ed behind a factory's ``lru_cache`` and each builder
of the class path is a jitted function, compiled once per configuration
and shape and run again with new inputs.  Here a :class:`Program` is one
program at one configuration and shape, looked up by :func:`program` under
a key that holds every value its body takes as a Python number or a shape;
:func:`function` turns a function into such programs, as
``partial(jax.jit, static_argnames=...)`` does.  On a CUDA device the
program

* on its first call copies the inputs into static buffers of its own, runs
  the body once eagerly on a side stream, returns that run's outputs, and
  captures the body into a CUDA graph on the same stream.  The eager run
  warms every lazy set-up the capture must not do: cuBLAS's workspace,
  the kernels' libraries and their launch caches, the constants a body
  copies to the card once;
* on every later call copies the inputs into the static buffers (the
  uniforms are drawn straight into theirs), replays the graph on the
  current stream and returns copies of the static outputs, so a caller may
  hold one call's outputs while the next call replays.

A value that the capture bakes in (a count, a table knob, a gravity
constant of the configuration) is in the key and never an input: the
sections of ``cgparams`` that bodies read (:func:`config_key`) join every
program's key in :func:`program`, the rest is the caller's key.  Every
input is a tensor whose shape and type join the key.  A failed capture
raises: nothing falls back to the eager body on the card.  A CPU tensor
runs the eager body, the graph's plain version; any other device raises.
A decorated function called inside a program's body (or inside
:func:`inline`) is part of that program: it runs its body there.

Buffers shared in place (the port's form of JAX's buffer donation): a
:class:`Workspace` owns large buffers and the programs that share them.
The first ``inplace`` inputs of :meth:`Workspace.run` are its buffers,
which the caller fills before a call and reads after it: the program
takes them as its static buffers (no copy in), its body may write them,
and an output that is one of them is handed back as itself (no copy
out).  So a chain of programs with a collective between them (the sharded
field's stages) holds each large array once: a collective writes straight
into the next stage's input.  A device holds one workspace of a name; one
of another configuration drops it, with its programs, first.

Random numbers: a caller's generator stays outside the graph.  Before each
replay the uniforms are drawn eagerly from it into the static buffers, by
the calls the eager body would make, so a replay equals the eager run bit
for bit.  Registering a generator with the graph
(``CUDAGraph.register_generator_state``) would tie the graph to fixed
generator objects, while the batch streams give every batch a generator of
its own.

Memory: each program captures into a memory pool of its own, so that
releasing it returns its memory to the card.  Each program's name (the
first entry of its key: one decorated function, one batch program) has a
memo of at most :data:`MAX_PROGRAMS` programs (a decorated function may
ask for more), the least recently used goes first, as each jitted JAX
function has a cache of its own.  What a
card keeps between calls (:func:`held`) is what the caller keeps plus the
memoized programs and workspaces, these only while the next call fits
beside them, as an XLA executable keeps only its outputs: before a
program's warm-up (the need: what its last capture held, for a program
captured again after a release), before its capture (what its warm-up
took) and before a workspace's buffers are made, :func:`make_room`
releases the least recently used programs and workspaces of that card
until the need fits in what it can still allocate (:func:`free_bytes`,
within the process's memory fraction).  A warm-up, a capture, the copies
a replay hands out and a workspace's ``make()`` that run out of memory
all the same are each run once more after every other program and
workspace of the card is released (:func:`retrying`), as the caching
allocator frees its cache before it raises; a second failure raises.  A
warm-up that has run through never runs again: it may have written
buffers shared in place.  A warm replay that fits releases nothing.  The
package's own eager steps between program calls that allocate in
proportion to the particles or the grid (joining, moving and cutting
particles, the Gadget blocks, the AREPO background, the AMR records, the
stacked field of a sampling, a container's conversions) make room the
same way before they allocate, for the bytes they reckon from their
inputs' sizes (:func:`room_for`); none of them is run again.  Only the
caller's own eager work has what the held programs leave: the allocator
gives no hook to make room for it.  :func:`clear` drops everything, the
counterpart of ``jax.clear_caches``: before such work, or for handing
the card to another process.

Kernel launches: a wrapper counts each launch with :func:`count_launch`.
A launch recorded into a graph is counted on each replay instead, once
per node, so a wrapper's ``launches`` counts the launches the card runs.

Host spans (:func:`~.profiling.span`, recorded only while a profiler
runs): a replay's copies into the static buffers (``cg.host.copy_in``),
its uniforms (``cg.host.draw``), the graph's launch (``cg.launch``) and
the copies handed out (``cg.host.hand_out``); a decorated function's
packing of its inputs (``cg.host.inputs``); and the synchronisation of
:func:`free_bytes` (``cg.wait.room``).
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import itertools
import math
import time
import weakref
from collections import OrderedDict
from typing import Callable, NamedTuple

import numpy as np
import torch

from .config import cgparams
from .device import host_to_device
from .profiling import span

__all__ = ["MAX_PROGRAMS", "Program", "run", "program", "programs",
           "clear", "config_key", "count_launch", "drawer", "tree_map",
           "function", "Workspace", "workspace", "workspaces",
           "register_node", "flatten", "unflatten", "signature", "inline",
           "is_inline", "eager", "eager_calls", "Held", "held", "free_bytes",
           "make_room", "room_for", "card", "retrying", "releases", "retries",
           "captures", "CAPACITY_CLASSES", "capacity", "padded"]

MAX_PROGRAMS = 8

# program name -> its memo (key -> Program), least recently used first
_MEMOS: dict = {}
# program key -> what its last capture held (static and pool bytes): the
# room its warm-up needs when it is captured again; the last _MAX_NEEDS
_NEEDS: OrderedDict = OrderedDict()
_MAX_NEEDS = 256
# (workspace name, device) -> its one Workspace
_WORKSPACES: dict = {}
_DEVICES: dict = {}
_STAMP = itertools.count()
# kernel wrapper -> launches recorded by the capture in progress
_TALLY: dict | None = None
# a program body runs: decorated calls run their body in it
_INLINE = False
# every program call runs its eager body (see :func:`eager`)
_EAGER = False
#: calls of decorated functions that ran their eager body because an input
#: requires grad (see :func:`function`)
eager_calls = 0
#: programs and workspaces released to make room (:func:`make_room`,
#: :func:`retrying`)
releases = 0
#: calls run once more after running out of memory (:func:`retrying`)
retries = 0
#: programs captured (one per capture that succeeds, a program captured
#: again after a release included): a reader takes it before and after
#: the calls it watches
captures = 0
#: seconds a reading of a card's free memory stands for the eager steps'
#: room (:func:`room_for`)
READING_SECONDS = 1.0
# device -> (time, its free and total memory, this process's reserved
# memory) at the last reading of free_bytes
_READINGS: dict = {}
#: capacity classes per octave of a particle count (:func:`capacity`); 0
#: runs every count at itself
CAPACITY_CLASSES = 16


def capacity(num: int) -> int:
    """The capacity class a program of ``num`` particles runs at, so that
    counts that change from call to call (an IC scene's, split by its
    halos' masses) replay a few programs: ``num`` rounded up to a multiple
    of 1/:data:`CAPACITY_CLASSES` of its octave (the power of two at or
    below it), at most 6.25% more at 16; a count below
    :data:`CAPACITY_CLASSES` is its own class.  The caller pads its inputs
    to the class (:func:`padded`, :func:`drawer`'s ``count``) and slices
    the outputs back; work per particle is the same at any length."""
    num = int(num)
    if CAPACITY_CLASSES <= 0 or num <= CAPACITY_CLASSES:
        return num
    step = (1 << (num.bit_length() - 1)) // CAPACITY_CLASSES
    return -(-num // step) * step


def padded(tensor, size: int):
    """``tensor`` with its leading axis padded with zeros to ``size`` (the
    tensor itself when it has that length)."""
    extra = size - tensor.shape[0]
    if extra == 0:
        return tensor
    return torch.cat([tensor, tensor.new_zeros((extra,) + tensor.shape[1:])])


def tree_map(fn, tree):
    """``fn`` on every tensor of a tree of dicts, tuples (named ones too,
    such as a spline) and lists (a ``None`` is an empty tree)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        items = [tree_map(fn, v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else \
            type(tree)(items)
    if tree is None:
        return None
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


def drawer(uniforms, generator, device, draw, count=None, size=None):
    """The ``draw`` of a program call: the caller's ``uniforms`` (copied
    into the static buffers, or cloned when there are none yet), else
    ``draw(generator, out)`` with ``generator`` (default: one on
    ``device`` seeded with 0), which is the draw's ``generator``
    attribute.  With ``size`` (a capacity class, :func:`capacity`) the
    program's uniforms are ``size`` long and the ``count`` a draw takes,
    in the same order, fill their front: the same numbers as a draw at
    ``count``; the rest is zeros, or what an earlier call left there."""
    if size is not None and size != count:
        inner = drawer(uniforms, generator, device, draw)

        def front(out):
            if out is None:
                return tree_map(lambda t: padded(t, size), inner(None))
            inner(tree_map(lambda t: t[:count], out))
            return out
        front.generator = getattr(inner, "generator", None)
        return front
    if uniforms is not None:
        def given(out):
            if out is None:
                return tree_map(torch.clone, uniforms)
            _copy(out, uniforms)
            return out
        return given
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)

    def drawn(out):
        return draw(generator, out)

    # a first call run again after running out of memory draws again from
    # the generator's state before the first attempt
    drawn.generator = generator
    return drawn


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


@contextlib.contextmanager
def inline():
    """Decorated functions called inside run their plain body: no program
    and no lifted floats.  Every program body runs inside it, and so does
    each batch program's eager body, so that both make the same calls."""
    global _INLINE
    old, _INLINE = _INLINE, True
    try:
        yield
    finally:
        _INLINE = old


def is_inline() -> bool:
    """Whether a program body (or :func:`inline`) is running."""
    return _INLINE


@contextlib.contextmanager
def eager():
    """Every decorated function called inside runs its eager body on its
    device, as a CPU call does (its floats lifted, so with the graph's
    arithmetic): the reference a replay is held against."""
    global _EAGER
    old, _EAGER = _EAGER, True
    try:
        yield
    finally:
        _EAGER = old


class _Device:
    """What the programs of one card share: the side stream of warm-ups
    and captures, and the event after the last program call.  It outlives
    :func:`clear`: cuBLAS keeps a workspace (32 MiB on an H100) for each
    stream it ran on until the process ends, so a new side stream after
    every :func:`clear` would hold one more each time."""

    def __init__(self, device):
        self.stream = torch.cuda.Stream(device)
        self.done = None

    def wait(self, stream):
        if self.done is not None:
            stream.wait_event(self.done)

    def record(self, stream):
        self.done = torch.cuda.Event()
        self.done.record(stream)


def _storages(tree) -> set:
    return {t.untyped_storage().data_ptr() for t in _leaves(tree)}


class Program:
    """One program at one configuration and shape.

    ``body(*inputs, uniforms)`` is the eager program: tensors in, a tree of
    tensors out.  Call the program as ``prog(inputs, draw)``: ``inputs`` a
    tuple of tensors, ``draw(out)`` the uniforms: drawn into the tree
    ``out`` in place and returned, or, with ``out=None``, returned as new
    tensors (``None`` for a program that draws nothing).

    The first ``inplace`` inputs are a :class:`Workspace`'s buffers,
    shared in place: they are the static buffers themselves, and an output
    that is one of them is returned as itself.

    The first call is a warm-up, then a capture, each with room made
    before it and run once more if it runs out of memory (:meth:`_first`).
    After the capture: ``capture_s`` (host seconds of the capture),
    ``pool_bytes`` (its own pool: what the capture added to the card's
    reserved memory, its outputs included), ``static_bytes`` (the static
    inputs and uniforms, less a workspace's buffers) and ``nodes`` (the
    counted kernels' launches per replay); ``device``, ``workspace`` (a
    weak reference to the one it belongs to, or ``None``) and ``stamp``
    (its last use) are what :func:`held` reads.
    """

    def __init__(self, key, body, inplace=0, workspace=None):
        self.key = key
        self.body = body
        self.inplace = inplace
        # weak: a workspace and its programs are freed by reference
        # counting alone once it is released
        self.workspace = None if workspace is None else weakref.ref(workspace)
        self.device = None
        self.graph = None
        self.inputs = self.uniforms = self.outputs = None
        self.nodes: dict = {}
        self.capture_s = None
        self.pool_bytes = None
        self.static_bytes = None
        self.stamp = next(_STAMP)

    def __call__(self, inputs, draw):
        dev = inputs[0].device
        if dev.type == "cpu":
            with inline():
                return self.body(*inputs, draw(None))
        if dev.type != "cuda":
            raise ValueError(f"programs run on cuda or cpu, not {dev}")
        with torch.cuda.device(dev):
            state = _DEVICES.get(dev)
            if state is None:
                state = _DEVICES[dev] = _Device(dev)
            cur = torch.cuda.current_stream(dev)
            state.wait(cur)
            if self.graph is None:
                self.device = dev
                out = self._first(state.stream, cur, inputs, draw)
            else:
                out = self._replay(cur, inputs, draw)
            state.record(cur)
        return out

    def _keep(self):
        """What releasing room for this program must not release."""
        return (self, self.workspace and self.workspace())

    def _shared(self):
        return _storages(self.inputs[:self.inplace])

    def _handed(self, tree, copied):
        """``tree`` as the caller gets it: each tensor whose storage's
        address is ``copied`` cloned (retried after running out of
        memory)."""
        return retrying(lambda: tree_map(
            lambda t: t.clone() if copied(t.untyped_storage().data_ptr())
            else t, tree), self.device, self._keep())

    def _first(self, side, cur, inputs, draw):
        """The warm-up (:meth:`_warm_up`), then the capture
        (:meth:`_capture`), each run once more after running out of memory
        (:func:`retrying`): the warm-up from the generator's state before
        its first attempt, the capture alone, so that a warm-up that has
        run through, and may have written buffers shared in place, never
        runs again.  Room is made before each (:func:`make_room`): for the
        warm-up what this program's last capture held, when it is captured
        again after a release; for the capture what the warm-up took."""
        dev, keep = self.device, self._keep()
        gen = getattr(draw, "generator", None)
        start = None if gen is None else gen.get_state()
        if self.key in _NEEDS:
            make_room(_NEEDS[self.key], dev, keep)

        def warm_up():
            if start is not None:
                gen.set_state(start)
            return self._warm_up(side, cur, inputs, draw)

        out, need = retrying(warm_up, dev, keep)
        # an output that is a static buffer (a field that is the input
        # grid, the field in the noise's buffer) is cloned for the caller:
        # the next call overwrites the buffer; a buffer shared in place is
        # read in place
        static = _storages((self.inputs[self.inplace:], self.uniforms)) \
            - self._shared()
        out = self._handed(out, static.__contains__)
        make_room(need, dev, keep)
        retrying(functools.partial(self._capture, side), dev, keep)
        _NEEDS[self.key] = self.static_bytes + self.pool_bytes
        _NEEDS.move_to_end(self.key)
        while len(_NEEDS) > _MAX_NEEDS:
            _NEEDS.popitem(last=False)
        return out

    def _warm_up(self, side, cur, inputs, draw):
        """The static buffers, the uniforms and the eager run of the body
        on ``side``: returns its outputs and the capture's need, what the
        run took from the card (the reserved memory's growth and the
        cached blocks it could reuse)."""
        n = self.inplace
        dev = self.device
        statics = tuple(inputs[:n]) + tuple(a.detach().clone(
            memory_format=torch.contiguous_format) for a in inputs[n:])
        uniforms = draw(None)
        side.wait_stream(cur)
        reserved = torch.cuda.memory_reserved(dev)
        need = reserved - torch.cuda.memory_allocated(dev)
        with torch.cuda.stream(side), inline():
            out = self.body(*statics, uniforms)
        need += torch.cuda.memory_reserved(dev) - reserved
        # the warm-up's outputs are the caller's, used on its stream once
        # the warm-up is done
        cur.wait_stream(side)
        tree_map(lambda t: t.record_stream(cur), out)
        self.inputs, self.uniforms = statics, uniforms
        return out, need

    def _capture(self, side):
        """The body captured on ``side`` into a graph with a pool of its
        own, from the static buffers and uniforms of the warm-up (counted
        in :data:`captures`)."""
        global _TALLY, captures
        dev = self.device
        # the capture empties the allocator's cache as it begins: its pool
        # is what the reserved memory grows from there
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        _TALLY = {}
        try:
            with torch.cuda.graph(graph, stream=side), inline():
                outputs = self.body(*self.inputs, self.uniforms)
            nodes = _TALLY
        finally:
            _TALLY = None
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.graph, self.nodes, self.outputs = graph, nodes, outputs
        captures += 1
        shared = self._shared()
        own = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
               for t in _leaves((self.inputs[self.inplace:], self.uniforms))}
        self.static_bytes = sum(v for k, v in own.items() if k not in shared)

    def _replay(self, cur, inputs, draw):
        with span("cg.host.copy_in"):
            for i, (buf, a) in enumerate(zip(self.inputs, inputs)):
                if buf.shape != a.shape:
                    raise ValueError(
                        f"input of shape {tuple(a.shape)} for a program "
                        f"captured at {tuple(buf.shape)}")
                if i >= self.inplace:
                    buf.copy_(a)
        with span("cg.host.draw"):
            draw(self.uniforms)
        with span("cg.launch"):
            self.graph.replay()
        with span("cg.host.hand_out"):
            shared = self._shared()
            out = self._handed(self.outputs, lambda p: p not in shared)
        for kernel, n in self.nodes.items():
            kernel.launches += n
        return out


def _frozen(section):
    if isinstance(section, dict):
        return tuple(sorted((k, _frozen(v)) for k, v in section.items()))
    if isinstance(section, list):
        return tuple(map(_frozen, section))
    return section


def config_key():
    """The sections of ``cgparams`` that a program body reads at capture,
    as a hashable key: the table knobs of ``numerical`` and the MOND
    constants of ``gravity``.  Every program's key holds it, and so does
    every factory memo of a program object, so that nothing captured under
    one configuration is replayed under another."""
    return _frozen({k: cgparams[k] for k in ("numerical", "gravity")})


def _memo_key(key, inputs):
    """The memo key of a program: the caller's ``key``, the configuration
    (:func:`config_key`) and the inputs' device, shapes and types."""
    return (key, config_key(), inputs[0].device,
            tuple((tuple(a.shape), a.dtype) for a in inputs))


def run(key, body, inputs, draw=None):
    """``body(*inputs, draw(None))``, as the memoized program of ``key``
    and the inputs' device, shapes and types (see :class:`Program`).  Under
    :func:`eager` the body runs eagerly."""
    draw = draw or _no_draw
    if _EAGER:
        with inline():
            return body(*inputs, draw(None))
    return program(key, body, inputs)(inputs, draw)


def program(key, body, inputs, size=MAX_PROGRAMS) -> Program:
    """The memoized program of ``key`` under the configuration and at the
    device, shapes and types of ``inputs`` (:func:`_memo_key`); made with
    ``body`` when the memo of the key's name (``key[0]``) has none (past
    ``size`` programs that memo's least recently used program goes)."""
    memo = _MEMOS.setdefault(key[0], OrderedDict())
    key = _memo_key(key, inputs)
    prog = memo.get(key)
    if prog is None:
        prog = memo[key] = Program(key, body)
        while len(memo) > size:
            memo.popitem(last=False)
    else:
        memo.move_to_end(key)
        prog.stamp = next(_STAMP)
    return prog


class Workspace:
    """Buffers that a chain of programs shares in place, and those
    programs: their one owner, dropped as a unit (see :func:`workspace`).
    ``buffers``: what ``make()`` returned; ``device``: theirs; ``stamp``:
    the last use."""

    def __init__(self, key, buffers, device):
        self.key = key
        self.buffers = buffers
        self.device = device
        self.programs: dict = {}
        self.stamp = next(_STAMP)

    def run(self, key, body, inputs, draw=None, inplace=0):
        """:func:`run` as a program of this workspace, whose first
        ``inplace`` inputs are buffers of the workspace, shared in place
        (the buffers' addresses stay, so the key is :func:`_memo_key`'s)."""
        draw = draw or _no_draw
        if _EAGER:
            with inline():
                return body(*inputs, draw(None))
        memo_key = _memo_key(key, inputs)
        prog = self.programs.get(memo_key)
        if prog is None:
            prog = self.programs[memo_key] = Program(
                memo_key, body, inplace, self)
        else:
            prog.stamp = next(_STAMP)
        self.stamp = next(_STAMP)
        return prog(inputs, draw)

    def nbytes(self) -> int:
        """The bytes of the buffers."""
        return _nbytes(self.buffers)


def card(device):
    """``device`` with its index (the current card's for a bare ``cuda``)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def workspace(name, key, device, make, nbytes=None) -> Workspace:
    """The workspace ``name`` on ``device`` for ``key`` (and the
    configuration, :func:`config_key`): the one the device holds when its
    key is the same, else ``make()``'s buffers in a new one, after the
    device's workspace of another key and its programs are dropped, so
    that their memory is free for the new buffers.  On a card, room is
    made for ``nbytes`` (what ``make()`` allocates) first
    (:func:`make_room`), and a ``make()`` that runs out of memory runs once
    more (:func:`retrying`).  :func:`clear` drops every workspace."""
    slot = (name, torch.device(device))
    key = (key, config_key())
    ws = _WORKSPACES.get(slot)
    if ws is not None and ws.key == key:
        ws.stamp = next(_STAMP)
        return ws
    _WORKSPACES.pop(slot, None)
    ws = None   # the last reference to the old buffers, before make()
    dev = card(device)
    if dev.type == "cuda":
        if nbytes:
            make_room(nbytes, dev)
        buffers = retrying(make, dev)
    else:
        buffers = make()
    ws = _WORKSPACES[slot] = Workspace(key, buffers, dev)
    return ws


def workspaces() -> list:
    """Every workspace held, one per name and device."""
    return list(_WORKSPACES.values())


def programs() -> list:
    """The memoized programs of every memo and workspace, least recently
    used first."""
    return sorted([p for memo in _MEMOS.values() for p in memo.values()]
                  + [p for ws in _WORKSPACES.values()
                     for p in ws.programs.values()], key=lambda p: p.stamp)


class Held(NamedTuple):
    """One thing a card keeps between calls (see :func:`held`): its last
    use, its card, its bytes (a program's static buffers and pool; a
    workspace's buffers and its programs' bytes), the :class:`Program` or
    :class:`Workspace`, and the call that releases it (out of its memo or
    slot)."""

    stamp: int
    device: torch.device
    nbytes: int
    what: object
    drop: Callable[[], object]


def _program_bytes(p) -> int:
    return (p.static_bytes or 0) + (p.pool_bytes or 0)


def held(device=None) -> list:
    """What the cards keep between calls beside what callers keep, least
    recently used first: each memoized program that has run on a device
    (its ``static_bytes`` and ``pool_bytes``) and each workspace with its
    programs (a unit); only ``device``'s when given."""
    out = [Held(p.stamp, p.device, _program_bytes(p), p,
                functools.partial(memo.pop, k, None))
           for memo in _MEMOS.values() for k, p in memo.items()
           if p.device is not None]
    out += [Held(ws.stamp, ws.device, ws.nbytes() + sum(
        map(_program_bytes, ws.programs.values())), ws,
        functools.partial(_WORKSPACES.pop, slot, None))
        for slot, ws in _WORKSPACES.items()]
    return sorted((h for h in out if device is None or h.device == device),
                  key=lambda h: h.stamp)


def free_bytes(device, empty=True) -> int:
    """What ``device`` can still allocate: its free memory within the
    process's memory fraction (``torch.cuda.set_per_process_memory_fraction``),
    with ``empty`` once the caching allocator has returned its unused
    blocks to the card (a synchronisation), else beside them."""
    if empty:
        with span("cg.wait.room"):
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info(device)
    reserved = torch.cuda.memory_reserved(device)
    _READINGS[device] = (time.monotonic(), free, total, reserved)
    cap = torch.cuda.get_per_process_memory_fraction(device) * total
    return int(min(free, cap - reserved))


def make_room(need, device, keep=(), free=None) -> int:
    """Release the least recently used programs and workspaces of
    ``device`` (:func:`held`), never one in ``keep``, until ``free()``
    reaches ``need`` bytes or nothing is left to release.  By default
    ``free`` is :func:`free_bytes` of ``device``: a need that fits beside
    the allocator's cache returns at once, with no synchronisation;
    otherwise the cache, and with it each released program's pool, goes
    back to the card before each reading.  Returns how many were released
    (also added to :data:`releases`)."""
    global releases
    if free is None:
        if free_bytes(device, empty=False) >= need:
            return 0
        free = functools.partial(free_bytes, device)
    victims = [h for h in held(device) if all(h.what is not k for k in keep)]
    n = 0
    while free() < need and victims:
        victims.pop(0).drop()
        n += 1
    releases += n
    return n


def room_for(device, *sizes) -> int:
    """Before an eager step of the package on ``device``: make room
    (:func:`make_room`) for the new tensors it allocates, one per entry of
    ``sizes``: a tensor (a new one of its bytes) or ``(numel, dtype)``.
    On a card a need that fits beside the allocator's cache returns at
    once, with no synchronisation and no release, and by a reading of the
    card's free memory under a second old (:func:`_free_unread`) without
    reading it again: ``cudaMemGetInfo`` can stall for tens of
    milliseconds behind the card's work, and an IC scene makes ~9 such
    steps a call.  Anywhere else nothing is done.  Returns how many
    programs and workspaces were released."""
    dev = card(device)
    need = sum(s.numel() * s.element_size() if isinstance(s, torch.Tensor)
               else s[0] * s[1].itemsize for s in sizes)
    if dev.type != "cuda" or not need:
        return 0
    free = _free_unread(dev)
    if free is not None and free >= need:
        return 0
    return make_room(need, dev)


def _free_unread(device):
    """:func:`free_bytes` beside the cache without reading the card: from
    its last reading on ``device`` if that is under
    :data:`READING_SECONDS` old, the card's free memory then less what
    this process has reserved since, within the memory fraction now;
    ``None`` without such a reading.  Only another process's allocations
    since the reading escape it."""
    seen = _READINGS.get(device)
    if seen is None or time.monotonic() - seen[0] > READING_SECONDS:
        return None
    _, free, total, reserved_then = seen
    reserved = torch.cuda.memory_reserved(device)
    cap = torch.cuda.get_per_process_memory_fraction(device) * total
    return int(min(free - (reserved - reserved_then), cap - reserved))


def retrying(fn, device, keep=()):
    """``fn()``; if it runs out of memory, once more after every program and
    workspace of ``device`` but those in ``keep`` is released and the
    card's unused cached memory returned (:func:`make_room`), as the
    caching allocator frees its cache before it raises.  A second failure
    raises.  Nothing else is caught, and nothing runs in ``fn``'s place."""
    global retries
    try:
        return fn()
    except torch.cuda.OutOfMemoryError:
        pass
    # outside the except clause, so that the failed attempt's frames and
    # their tensors are gone
    retries += 1
    make_room(math.inf, device, keep)
    return fn()


def clear() -> None:
    """Drop every memoized program and workspace and return their memory
    to the card (a program a caller still holds keeps its graph): the
    counterpart of ``jax.clear_caches``, for handing the card to another
    process, whose needs :func:`make_room` cannot see."""
    _MEMOS.clear()
    _NEEDS.clear()
    _WORKSPACES.clear()
    _READINGS.clear()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


# ----------------------------------------------------------------- trees
# type -> (to_children, from_children): obj -> (children, aux) and back
_NODES: dict = {}


def register_node(cls, to_children, from_children) -> None:
    """Let :func:`flatten` see through ``cls`` (JAX's pytree registration):
    ``to_children(obj) -> (children, aux)`` with ``children`` a tuple of
    trees, ``from_children(aux, children) -> obj``.  ``aux`` is structure:
    it joins a program's key through :func:`signature` when callable."""
    _NODES[cls] = (to_children, from_children)


def _node(tree):
    for cls, fns in _NODES.items():
        if isinstance(tree, cls):
            return fns
    return None


def flatten(tree, leaves: list, lift: bool = False):
    """Replace every tensor of ``tree`` (tuples, lists, named tuples, dicts
    and registered nodes such as a profile) by its index in ``leaves``,
    appending it there; with ``lift`` a Python float becomes a leaf too.
    Anything else is a constant of the structure.  Returns the structure
    (see :func:`unflatten`)."""
    if isinstance(tree, torch.Tensor) or (
            lift and isinstance(tree, float)):
        leaves.append(tree)
        return len(leaves) - 1
    node = _node(tree)
    if node is not None:
        children, aux = node[0](tree)
        return ("node", node[1], aux,
                [flatten(c, leaves, lift) for c in children])
    if isinstance(tree, dict):
        return ("dict", tuple(tree),
                [flatten(v, leaves, lift) for v in tree.values()])
    if isinstance(tree, (tuple, list)):
        return ("seq", type(tree), [flatten(p, leaves, lift) for p in tree])
    return ("const", tree)


def unflatten(struct, leaves):
    """The tree of :func:`flatten`'s ``struct`` with ``leaves`` in place."""
    if isinstance(struct, int):
        return leaves[struct]
    kind = struct[0]
    if kind == "const":
        return struct[1]
    items = [unflatten(p, leaves) for p in struct[-1]]
    if kind == "node":
        return struct[1](struct[2], tuple(items))
    if kind == "dict":
        return dict(zip(struct[1], items))
    cls = struct[1]
    return cls(*items) if hasattr(cls, "_fields") else cls(items)


def signature(value):
    """What a program's key holds for a value of its structure: a callable
    by its ``signature`` attribute (a composed profile's) or, for a
    function defined at a module's top level, by its module and name; any
    other callable by identity; a constant by value."""
    sig = getattr(value, "signature", None)
    if sig is not None:
        return sig
    if inspect.isfunction(value) and "<" not in value.__qualname__:
        return ("fn", value.__module__, value.__qualname__)
    hash(value)   # an unhashable constant cannot key a program: TypeError
    return value


def _struct_key(struct):
    if isinstance(struct, int):
        return struct
    kind = struct[0]
    if kind == "const":
        return ("const", signature(struct[1]))
    children = tuple(_struct_key(s) for s in struct[-1])
    if kind == "node":
        return ("node", struct[1], signature(struct[2]), children)
    return (kind, struct[1], children)


class _Function:
    """A function run as memoized programs (see :func:`function`)."""

    def __init__(self, fn, static, random, name, memo):
        self.fn = fn
        self.static = frozenset(static)
        self.random = random
        self.name = name or fn.__name__
        self.memo = memo
        self.sig = inspect.signature(fn)
        if any(p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD)
               for p in self.sig.parameters.values()):
            raise TypeError(f"{self.name}: no *args or **kwargs")
        functools.update_wrapper(self, fn)

    def _call(self, args, kwargs):
        """``(key, inputs, body, draw)`` of one call: statics and the
        structure in the key, tensors and lifted floats as inputs."""
        bound = self.sig.bind(*args, **kwargs)
        bound.apply_defaults()
        arguments = dict(bound.arguments)
        draw = arguments.pop(self.random, None) if self.random else None
        statics = {k: arguments.pop(k) for k in list(arguments)
                   if k in self.static}
        leaves: list = []
        struct = flatten(arguments, leaves, lift=True)
        tensors = [t for t in leaves if isinstance(t, torch.Tensor)]
        floats = [t for t in leaves if not isinstance(t, torch.Tensor)]
        if tensors:
            dev = tensors[0].device
        elif "device" in statics:
            dev = torch.device(statics["device"])
        else:
            raise ValueError(f"{self.name}: no tensor and no device to "
                             "run on")
        # the floats go to the device as one vector, each a 0-d view
        packed = host_to_device(np.asarray(floats, dtype=np.float64), dev)
        slots, nt, nf = [], 0, 0
        for leaf in leaves:
            if isinstance(leaf, torch.Tensor):
                slots.append((0, nt))
                nt += 1
            else:
                slots.append((1, nf))
                nf += 1
        key = (self.name, tuple(sorted((k, signature(v))
                                       for k, v in statics.items())),
               _struct_key(struct), tuple(s for s, _ in slots))

        def body(*inputs):
            *ts, vec, uniforms = inputs
            vals = [ts[i] if kind == 0 else vec[i] for kind, i in slots]
            call = dict(unflatten(struct, vals), **statics)
            if self.random is not None:
                call[self.random] = uniforms
            return self.fn(**call)

        if draw is None:
            draw = _no_draw
        return key, (*tensors, packed), body, draw

    def __call__(self, *args, **kwargs):
        global eager_calls
        if _INLINE:
            return self.fn(*args, **kwargs)
        with span("cg.host.inputs"):
            key, inputs, body, draw = self._call(args, kwargs)
        if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
            eager_calls += 1
        elif not (_EAGER or inputs[0].device.type == "cpu"
                  or any(t.device != inputs[0].device for t in inputs)):
            return program(key, body, inputs, self.memo)(inputs, draw)
        # the eager body: on the CPU (the plain version, no program), for
        # grad, as the reference of a replay (:func:`eager`), or with
        # inputs on two devices, where the body raises with its own
        # message (a profile whose parameters live on another device than
        # its radii)
        with inline():
            return body(*inputs, draw(None))


def _no_draw(out):
    return None


def function(static=(), random=None, name=None, memo=MAX_PROGRAMS):
    """Decorator: the counterpart of ``partial(jax.jit,
    static_argnames=static)``.  On the card each call of the function runs
    as the memoized :class:`Program` of its key, a CUDA graph; on the CPU
    it runs its eager body and makes no program:

    * the arguments named in ``static``, every ``None``, int, bool and
      string, the structure of the others (a profile's ``eval_fn`` by its
      :func:`signature`, a dict's keys) and, as for every program, the
      configuration (:func:`config_key`) are the key;
    * every tensor is an input, and every Python float among the others
      (a profile's parameter, a dict's value, a scalar argument) is lifted
      to a 0-d float64 input, as JAX traces float leaves: a new ``M200``
      or rescale factor replays the program;
    * ``random`` names the argument that takes the uniforms: the caller
      passes a :func:`drawer` there, drawn before each replay into the
      static buffers (inside a program, the uniforms themselves).

    A call whose tensor input requires grad, with grad enabled, runs the
    eager body on its own device instead (a CUDA graph carries no autograd
    tape): the same kernels on the same card, not a fallback, counted in
    :data:`eager_calls`.  Inside a program's body (:func:`inline`) the
    function runs its plain body, as part of that program; under
    :func:`eager` it runs its eager body with the program's inputs.

    ``memo``: the programs its memo holds (a function keyed by the
    capacity class of a count, :func:`capacity`, may need more than
    :data:`MAX_PROGRAMS`).
    """
    def wrap(fn):
        return _Function(fn, static, random, name, memo)
    return wrap
