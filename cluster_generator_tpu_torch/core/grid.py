"""Log-radius grid (the abscissa every model lives on)."""

from __future__ import annotations

import math

import torch

from .device import resolve_device

__all__ = ["linspace", "log_radius_grid"]


def linspace(start, stop, num: int, dtype=torch.float64, device=None):
    """``jnp.linspace`` along a new last axis, with its arithmetic:
    ``start (1 - t) + stop t`` for ``t = i / (num - 1)`` and the endpoint
    copied exactly.  ``start``/``stop`` may be tensors of one batch shape
    (one row per batch element) or Python floats."""
    # a float becomes a filled 0-d tensor on the device: no copy from the
    # host, which would wait for the device or queue behind other copies
    if not isinstance(start, torch.Tensor):
        start = torch.full((), float(start), dtype=dtype,
                           device=device or "cpu")
    start = start.to(device=device or start.device, dtype=dtype)
    if not isinstance(stop, torch.Tensor):
        stop = torch.full((), float(stop), dtype=dtype, device=start.device)
    stop = stop.to(device=start.device, dtype=dtype)
    if num == 1:
        return start[..., None].clone()
    div = num - 1
    step = (torch.arange(div, dtype=torch.float64, device=start.device)
            / float(div)).to(dtype)
    out = start[..., None] * (1 - step) + stop[..., None] * step
    return torch.cat([out, stop[..., None].expand(out.shape[:-1] + (1,))],
                     dim=-1)


def log_radius_grid(rmin: float, rmax: float, num_points: int = 1000,
                    device="cuda"):
    """Log-spaced radius grid in kpc, endpoint inclusive (float64), on
    ``device`` (the card unless ``"cpu"`` is asked for)."""
    lin = linspace(math.log10(rmin), math.log10(rmax), num_points,
                   device=resolve_device(device))
    return torch.pow(10.0, lin)
