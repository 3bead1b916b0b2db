"""State carried across from the JAX package.

This system has no weights: its state is the model fields and the tables.
These helpers turn the JAX package's outputs, handed over as numpy arrays
(``np.asarray`` of each JAX array), into the port's tensors on a given
device, keeping each array's dtype (float64 fields, float32 tables) and
the leading halo axis, so that any stage of the port can start from the
JAX package's state.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.device import resolve_device

__all__ = ["fields_from_numpy", "tables_from_numpy", "to_numpy"]


def _tensor(a, device):
    return torch.tensor(np.asarray(a), device=device)


def fields_from_numpy(fields: dict, device="cuda") -> dict:
    """``build_merger_models`` fields (name -> (H, n) array) as tensors."""
    dev = resolve_device(device)
    return {k: _tensor(v, dev) for k, v in fields.items()}


def tables_from_numpy(tables: dict, device="cuda") -> dict:
    """The tables dict (``"dm"``/``"star"`` speed tables and the nested
    ``"radius"`` dict of :func:`build_radius_tables`) as tensors."""
    dev = resolve_device(device)
    return {k: (tables_from_numpy(v, dev) if isinstance(v, dict)
                else _tensor(v, dev))
            for k, v in tables.items()}


def to_numpy(tree):
    """A (nested) dict of tensors as numpy arrays on the host."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()
