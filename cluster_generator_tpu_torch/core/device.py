"""Device selection for the entry points: the card unless asked otherwise."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises when it names CUDA and no
    card is present (pass ``device="cpu"`` to run on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU")
    return dev


def tensor_on(value, device="cuda", dtype=torch.float64) -> torch.Tensor:
    """``value`` as a ``dtype`` tensor.  A tensor stays on its own device;
    a float, a list or a numpy array goes to ``device`` (through
    :func:`resolve_device`, so the card unless the CPU is asked for)."""
    if isinstance(value, torch.Tensor):
        return value.to(dtype=dtype)
    return torch.as_tensor(np.array(value), dtype=dtype,
                           device=resolve_device(device))


def host_to_device(value, device, dtype=None) -> torch.Tensor:
    """A host value (a float, a list, a numpy array) as a tensor on
    ``device``, with no host sync: to a card the bytes go through pinned
    memory by a non-blocking copy, since a copy from pageable memory waits
    until the device has run everything enqueued before it."""
    t = torch.as_tensor(np.asarray(value), dtype=dtype)
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def f64_on(value, device) -> torch.Tensor:
    """``value`` as a float64 tensor on ``device``: a tensor by a cast
    (and a move, when it lives elsewhere); a host value (a float, a list,
    a numpy array) through :func:`host_to_device`, so the copy makes no
    sync."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=torch.float64)
    return host_to_device(np.asarray(value, dtype=np.float64), device)
