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
