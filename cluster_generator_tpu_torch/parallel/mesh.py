"""Device meshes over a ``torch.distributed`` world.

A mesh is a :class:`~torch.distributed.device_mesh.DeviceMesh` with the dims

* ``ens``  — the cluster-ensemble axis (each rank computes its slice of a
  batch),
* ``part`` — the particle axis (each rank draws its share of the particles
  from its own generator, :func:`fold_in`).

The program is SPMD: one process per rank, each holding its own shard.  A
globally sharded array is a :class:`~torch.distributed.tensor.DTensor`
whose placements shard dim 0; ``.to_local()`` gives the rank's shard,
``.full_tensor()`` gathers it.  The caller starts the process group, and
its backend (NCCL across cards, gloo through the host) is the caller's
choice: nothing here picks one.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["make_mesh", "ensemble_sharding", "particle_sharding", "fold_in",
           "mesh_device", "ens_rows", "sharded", "replicated",
           "all_gather_rows"]

_NO_WORLD = (
    "make_mesh needs an initialized torch.distributed process group, one "
    "process per rank: call torch.distributed.init_process_group(backend, "
    "init_method=..., rank=..., world_size=...) first (backend 'nccl' with "
    "one card per rank, or 'gloo'; a single process starts a world of one "
    "with rank=0, world_size=1, e.g. init_method='tcp://localhost:29500')")


def make_mesh(n_ens: int | None = None, n_part: int | None = None,
              device_type: str = "cuda"):
    """An ``(ens, part)`` mesh over the initialized world.

    With one dim size given, the other takes the remaining ranks; with
    neither, every rank goes to ``ens``.  ``device_type``: where the
    tensors of the mesh live, the card unless ``"cpu"`` is asked for (a
    gloo world whose ranks hold CUDA tensors is a ``"cuda"`` mesh too).
    Raises ``ValueError`` when no process group is initialized."""
    from torch.distributed.device_mesh import init_device_mesh

    from ..core.device import resolve_device

    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(_NO_WORLD)
    device_type = resolve_device(device_type).type
    n = dist.get_world_size()
    if n_ens is None and n_part is None:
        n_ens, n_part = n, 1
    elif n_ens is None:
        n_ens = n // n_part
    elif n_part is None:
        n_part = n // n_ens
    assert n_ens * n_part == n, (n_ens, n_part, n)
    return init_device_mesh(device_type, (n_ens, n_part),
                            mesh_dim_names=("ens", "part"))


def ensemble_sharding(mesh):
    """Placements that shard the leading (ensemble/batch) axis over
    ``ens`` and replicate over ``part``."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(0), Replicate()]


def particle_sharding(mesh):
    """Placements that shard the leading (particle) axis over the whole
    mesh, ens-major (the flattened ``("ens", "part")`` axis)."""
    from torch.distributed.tensor import Shard

    return [Shard(0), Shard(0)]


def _mix(seed, i):
    return (int(seed) * 0x9E3779B97F4A7C15 + int(i) + 1) % (2**63)


def fold_in(seed, i, device):
    """A ``torch.Generator`` on ``device`` seeded from ``(seed, i)``
    alone: the stream of shard ``i``."""
    return torch.Generator(device=device).manual_seed(_mix(seed, i))


def mesh_device(mesh):
    """The ``torch.device`` of this rank's tensors on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _dim(mesh, axis):
    return mesh.mesh_dim_names.index(axis)


def ens_rows(mesh, n, axis="ens"):
    """``(lo, hi)``: this rank's rows of an ``n``-row batch split over
    ``axis``, or ``None`` when the axis size does not divide ``n`` (the
    batch is then computed whole on every rank)."""
    size = mesh.size(_dim(mesh, axis))
    if n % size:
        return None
    per = n // size
    lo = mesh.get_local_rank(axis) * per
    return lo, lo + per


def sharded(mesh, local, axis, n_global, dim=0):
    """A DTensor of ``n_global`` entries along ``dim`` from this rank's
    ``local`` part, sharded over the mesh dim ``axis`` and replicated over
    the others (no collective)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    placements = [Replicate()] * mesh.ndim
    placements[_dim(mesh, axis)] = Shard(dim)
    shape = list(local.shape)
    shape[dim] = n_global
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta")
                              .stride())


def replicated(mesh, local):
    """A DTensor that every rank holds whole (no collective)."""
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(local, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def all_gather_rows(mesh, local, axis="ens"):
    """The rows of every rank along ``axis``, concatenated in rank order,
    on every rank of the group (the list form of ``all_gather``, which
    gloo also takes for CUDA tensors)."""
    group = mesh.get_group(axis)
    local = local.contiguous()
    parts = [torch.empty_like(local)
             for _ in range(dist.get_world_size(group))]
    if local.is_complex():
        dist.all_gather([torch.view_as_real(p) for p in parts],
                        torch.view_as_real(local), group=group)
    else:
        dist.all_gather(parts, local, group=group)
    return torch.cat(parts, dim=0)
