"""Log-radius grid (the abscissa every model lives on)."""

from __future__ import annotations

import math

import torch

__all__ = ["linspace", "log_radius_grid"]


def linspace(start, stop, num: int, dtype=torch.float64, device=None):
    """``jnp.linspace`` along a new last axis, with its arithmetic:
    ``start (1 - t) + stop t`` for ``t = i / (num - 1)`` and the endpoint
    copied exactly.  ``start``/``stop`` may be tensors of one batch shape
    (one row per batch element) or Python floats."""
    start = torch.as_tensor(start, dtype=dtype, device=device)
    stop = torch.as_tensor(stop, dtype=dtype, device=start.device)
    if num == 1:
        return start[..., None].clone()
    div = num - 1
    step = (torch.arange(div, dtype=torch.float64, device=start.device)
            / float(div)).to(dtype)
    out = start[..., None] * (1 - step) + stop[..., None] * step
    return torch.cat([out, stop[..., None].expand(out.shape[:-1] + (1,))],
                     dim=-1)


def log_radius_grid(rmin: float, rmax: float, num_points: int = 1000,
                    device=None):
    """Log-spaced radius grid in kpc, endpoint inclusive (float64)."""
    lin = linspace(math.log10(rmin), math.log10(rmax), num_points,
                   device=device)
    return torch.pow(10.0, lin)
