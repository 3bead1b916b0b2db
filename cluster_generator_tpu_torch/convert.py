"""State carried across from the JAX package.

This system has no weights: its state is the model fields and the tables.
These helpers turn the JAX package's outputs, handed over as numpy arrays
(``np.asarray`` of each JAX array), into the port's tensors on a given
device, keeping each array's dtype (float64 fields, float32 tables) and
the leading halo axis, so that any stage of the port can start from the
JAX package's state.  The fields of an Osipkov-Merritt build carry their
extras (``df_ee_ext``, ``dm_df_ext``, ``star_df_ext``) like any other
field; a datagen batch output keeps its layout of tuples per species.
:func:`cluster_model_from_numpy` makes a whole
:class:`~.model.cluster_model.ClusterModel` of a JAX model's fields and
DFs, so that both packages compute on the same state.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.device import resolve_device

__all__ = ["fields_from_numpy", "tables_from_numpy",
           "datagen_batch_from_numpy", "cluster_model_from_numpy",
           "to_numpy"]


def _tensor(a, device):
    return torch.tensor(np.asarray(a), device=device)


def fields_from_numpy(fields: dict, device="cuda") -> dict:
    """``build_merger_models`` fields (name -> (H, n) array, the OM extras
    on their longer grid included) as tensors."""
    dev = resolve_device(device)
    return {k: _tensor(v, dev) for k, v in fields.items()}


def tables_from_numpy(tables: dict, device="cuda") -> dict:
    """The tables dict (``"dm"``/``"star"`` speed tables and the nested
    ``"radius"`` dict of :func:`build_radius_tables`) as tensors."""
    dev = resolve_device(device)
    return {k: (tables_from_numpy(v, dev) if isinstance(v, dict)
                else _tensor(v, dev))
            for k, v in tables.items()}


def datagen_batch_from_numpy(batch_out, device="cuda"):
    """A datagen batch output as tensors: ``{"dm": (pos, vel, pmass),
    "star": (...), "gas": (pos, energy, pmass)}`` with a leading batch
    axis, or the bare DM tuple of the int-count product."""
    dev = resolve_device(device)
    if isinstance(batch_out, dict):
        return {sp: datagen_batch_from_numpy(v, dev)
                for sp, v in batch_out.items()}
    return tuple(_tensor(a, dev) for a in batch_out)


def cluster_model_from_numpy(fields: dict, dm_df=None, star_df=None,
                             gravity="newtonian", device="cuda"):
    """A :class:`~.model.cluster_model.ClusterModel` on ``device`` from a
    JAX ``ClusterModel``'s fields (name -> (n,) array) and, where given,
    its DFs on the radial grid, which are resumed, not recomputed."""
    from .model.cluster_model import ClusterModel
    from .virial import VirialEquilibrium

    n = int(np.asarray(fields["radius"]).size)
    model = ClusterModel(n, {k: np.asarray(v) for k, v in fields.items()},
                         gravity=gravity, device=device)
    if dm_df is not None:
        model._dm_virial = VirialEquilibrium(model, "dark_matter",
                                             df=np.asarray(dm_df))
    if star_df is not None:
        model._star_virial = VirialEquilibrium(model, "stellar",
                                               df=np.asarray(star_df))
    return model


def to_numpy(tree):
    """A (nested) dict or tuple of tensors as numpy arrays on the host."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(to_numpy(v) for v in tree)
    return tree.detach().cpu().numpy()
