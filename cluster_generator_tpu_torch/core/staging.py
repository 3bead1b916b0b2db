"""Device-to-host staging of a stream of batches, overlapped with compute.

The streamed products (the datagen catalogs, the chunked grid) compute a
batch on the device while the host writes the one before it.  In PyTorch on
one stream, ``.cpu()`` of batch k waits for everything enqueued, batch k+1
included, and copies to pageable memory.  :func:`stream_to_host` instead:

* records an event on the current stream right after batch k's program is
  enqueued;
* on a dedicated copy stream waits on that event and copies batch k's
  tensors, laid end to end, into one of two pinned host buffers
  (``non_blocking``), with ``record_stream`` on the sources so that the
  caching allocator cannot hand their memory to a later batch early, and
  records a done-event;
* hands batch k to the consumer only after batches k+1 and k+2 are
  enqueued; the consumer waits on batch k's done-event, never on the
  device as a whole.  With one batch of lookahead the host, blocked on
  copy k, would enqueue batch k+2 only after it, and the card would idle
  whenever that enqueue plus the copy outlasts a batch's device time.

The two pinned buffers form a ring, allocated once per call: batch k's copy
is enqueued once batch k+1 is, into the buffer of batch k-2, whose consumer
has asked for batch k-1 by then.  So the consumer must be done with a
batch's arrays when it asks for the next one.  Tensors on the CPU are
handed over as numpy views with no stream and no copy.

Host spans (:func:`~.profiling.span`, while a profiler runs): the copies
enqueued with their buffer and events (``cg.host.stage_copy``), the wait
for a copy (``cg.wait.copy``) and the numpy views made of the buffer
(``cg.host.unpack``).
"""

from __future__ import annotations

import torch

from .profiling import span

__all__ = ["stream_to_host", "to_host"]

_ALIGN = 64  # bytes between the starts of two packed arrays


class _Ring:
    """The copy stream and the two pinned buffers of one call."""

    def __init__(self, device):
        self.device = device
        self.stream = torch.cuda.Stream(device=device)
        self.buffers = [None, None]
        self.slot = 0

    def _buffer(self, nbytes):
        buf = self.buffers[self.slot]
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            self.buffers[self.slot] = buf
        return buf

    def ready(self):
        """An event on the current stream: everything enqueued so far."""
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return event

    def stage(self, tensors, ready=None):
        """Enqueue the copy of ``tensors`` (contiguous, on the device),
        after ``ready`` (default: now), into the next pinned buffer;
        returns what :meth:`finish` needs."""
        spans, off = [], 0
        for t in tensors:
            n = t.numel() * t.element_size()
            spans.append((off, n))
            off += -(-n // _ALIGN) * _ALIGN
        buf = self._buffer(max(off, 1))
        self.slot ^= 1
        ready = self.ready() if ready is None else ready
        done = torch.cuda.Event()
        with torch.cuda.stream(self.stream):
            self.stream.wait_event(ready)
            for t, (o, n) in zip(tensors, spans):
                if n:
                    buf[o:o + n].copy_(t.reshape(-1).view(torch.uint8),
                                       non_blocking=True)
                t.record_stream(self.stream)
            done.record(self.stream)
        return buf, spans, [(t.dtype, tuple(t.shape)) for t in tensors], done

    @staticmethod
    def finish(staged):
        """Wait for one staged copy; the arrays as numpy views of the
        pinned buffer."""
        buf, spans, metas, done = staged
        with span("cg.wait.copy"):
            done.synchronize()
        with span("cg.host.unpack"):
            host = buf.numpy()
            out = []
            for (o, n), (dtype, shape) in zip(spans, metas):
                dt = torch.empty((), dtype=dtype).numpy().dtype
                out.append(host[o:o + n].view(dt).reshape(shape))
        return out


def stream_to_host(batches):
    """``batches``: an iterable of ``(key, [tensors])``, each item's
    program enqueued on the device as the iterable produces it.  Yields
    ``(key, [numpy arrays])`` in order, batch k's copy to pinned host
    memory overlapped with the compute of the batches after it (see the
    module docstring: a batch's arrays are valid until the next one is
    asked for).

    CPU tensors are handed over as numpy views, with no copy."""
    ring = None
    items = []  # oldest first: [key, tensors, ready event, staged or None]
    for key, tensors in batches:
        with span("cg.host.stage_copy"):
            tensors = [t.detach().contiguous() for t in tensors]
            on_card = bool(tensors) and tensors[0].device.type == "cuda"
            if on_card:
                if ring is None:
                    ring = _Ring(tensors[0].device)
                items.append([key, tensors, ring.ready(), None])
                if len(items) >= 2:
                    # batch k-1 into the buffer of batch k-3, handed over
                    # already
                    items[-2][3] = ring.stage(items[-2][1], items[-2][2])
        if not on_card:
            yield key, [t.numpy() for t in tensors]
            continue
        if len(items) == 3:
            key0, _, _, staged = items.pop(0)
            yield key0, ring.finish(staged)
    if items:
        with span("cg.host.stage_copy"):
            for item in items:
                if item[3] is None:
                    item[3] = ring.stage(item[1], item[2])
    for key0, _, _, staged in items:
        yield key0, ring.finish(staged)


def to_host(tensors):
    """One batch of tensors as numpy arrays, through the same pinned copy
    (a CUDA tensor) or as views (a CPU tensor)."""
    (_, arrays), = stream_to_host([(None, list(tensors))])
    return arrays
