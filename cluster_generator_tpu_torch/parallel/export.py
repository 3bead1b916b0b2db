"""Sharded particle export: one Gadget file per particle shard.

:func:`~..pipeline.sample_merger_ic_sharded` leaves every particle array a
DTensor sharded along its first axis.  Exporting through one file would
funnel the whole IC through one rank; instead each rank writes a standard
multi-file Gadget snapshot's file for its own shard
(``NumFilesPerSnapshot`` = the shard count, reference particles.py:475-552
header semantics).  Ranks that hold a replica of a shard (they differ from
its owner only in a mesh dim the arrays are replicated over) write nothing.
The snapshot-wide header values come from one collective:

* the shard index and count follow from the DTensor's placements and the
  rank's mesh coordinates;
* per-shard in-box particle counts, and from them ``NumPart_Total`` and the
  globally unique ``ParticleIDs`` offsets, come from one ``all_gather`` of
  an int64 tensor (the counts per species) over the world.

Plain tensors (no mesh) are one shard: the totals are its own.  Read back
with ``ClusterParticles.from_gadget_files(base + ".0.h5")``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..core import compiled

__all__ = ["shard_particles", "write_sharded_gadget_files"]

# pipeline-dict field name -> ClusterParticles container field name
_PIPE_TO_CONTAINER = {"particle_potential": "potential_energy"}

_SLOT = {"gas": 0, "dm": 1, "tracer": 2, "star": 4, "black_hole": 5}


def _shard_of(arr):
    """``(index, count, owner)`` of this rank's particle-axis shard of
    ``arr``: mesh dims that shard dim 0 split it (in mesh-dim order, so
    ``[Shard(0), Shard(0)]`` is ens-major), and the rank owns its shard
    when its coordinate is 0 on every dim the array is replicated over.  A
    plain tensor is shard 0 of 1, owned."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(arr, DTensor):
        return 0, 1, True
    mesh = arr.device_mesh
    coords = mesh.get_coordinate()
    index, count, owner = 0, 1, True
    for d, placement in enumerate(arr.placements):
        if isinstance(placement, Shard):
            if placement.dim != 0:
                raise ValueError(f"particle arrays shard dim 0, not "
                                 f"{placement.dim}")
            index = index * mesh.size(d) + coords[d]
            count *= mesh.size(d)
        elif isinstance(placement, Replicate):
            owner = owner and coords[d] == 0
        else:
            raise ValueError(f"unsupported placement {placement}")
    return index, count, owner


def _local(arr):
    from torch.distributed.tensor import DTensor

    return arr.to_local() if isinstance(arr, DTensor) else arr


def _species(parts):
    order = []
    for ptype, _ in parts:
        if ptype not in order:
            order.append(ptype)
    return order


def shard_particles(parts: dict):
    """This rank's shard of a dict of sharded particle arrays as a
    ``ClusterParticles``.

    ``parts`` is the output of ``sample_merger_ic_sharded``, every value a
    DTensor sharded along dim 0 (or plain tensors: one shard).  Yields
    ``(global_shard_rank, ClusterParticles)`` for the shard this rank
    owns, on the rank's device, and nothing on a rank that holds a
    replica.  Nothing is gathered."""
    from ..particles import ClusterParticles

    index, _, owner = _shard_of(next(iter(parts.values())))
    if not owner:
        return
    fields = {(ptype, _PIPE_TO_CONTAINER.get(fname, fname)): _local(arr)
              for (ptype, fname), arr in parts.items()}
    yield index, ClusterParticles(_species(parts), fields)


def _inbox_count(pos, box_size):
    """Particles inside the Gadget box [0, box_size]^3: the predicate of
    ``ClusterParticles._clip_to_box``."""
    return (~torch.logical_or((pos < 0.0).any(dim=1),
                              (pos > box_size).any(dim=1))).sum()


def _export_plan(parts: dict, box_size, center_offset=None):
    """What every rank needs to write its file: ``(n_files, npart_total,
    mine)`` with ``npart_total`` the uint32[6] post-clip totals and
    ``mine`` the list of ``(shard rank, ClusterParticles shifted by
    center_offset, id_offset, {species: in-box count})`` of the shard this
    rank owns (empty on a replica).  One ``all_gather`` over the world when
    the arrays are DTensors."""
    from torch.distributed.tensor import DTensor

    first = next(iter(parts.values()))
    index, n_files, owner = _shard_of(first)
    species = _species(parts)
    mine = list(shard_particles(parts))
    if center_offset is not None:
        for _, sp in mine:
            compiled.room_for(sp.device, *(
                sp.fields[p, "particle_position"] for p in sp.particle_types))
            for ptype in sp.particle_types:
                sp.fields[ptype, "particle_position"] = (
                    sp.fields[ptype, "particle_position"]
                    + sp._coerce((ptype, "particle_position"), center_offset))
    off = torch.as_tensor(np.zeros(3) if center_offset is None
                          else np.asarray(center_offset, np.float64),
                          device=_local(first).device)

    def inbox(p):
        pos = _local(parts[p, "particle_position"])
        # the float64 positions, moved, and the in-box masks
        compiled.room_for(pos.device, *[(pos.numel(), torch.float64)] * 2,
                          (2 * pos.numel() + 4 * pos.shape[0], torch.bool))
        return _inbox_count(pos.to(torch.float64) + off, box_size)

    # this rank's row: shard index, owner flag, in-box count per species
    row = torch.cat([
        torch.as_tensor([index, int(owner)], device=off.device),
        torch.stack([inbox(p) for p in species])])
    if isinstance(first, DTensor):
        rows = [torch.empty_like(row) for _ in range(dist.get_world_size())]
        dist.all_gather(rows, row)
    else:
        rows = [row]
    table = torch.stack(rows).cpu().numpy()
    counts = np.zeros((n_files, len(species)), np.int64)
    for r in table[table[:, 1] == 1]:
        counts[r[0]] = r[2:]
    npart_total = np.zeros(6, dtype="uint32")
    for j, p in enumerate(species):
        npart_total[_SLOT[p]] = int(counts[:, j].sum())
    plan = []
    for rank, sp in mine:
        id_offset = int(counts[:rank].sum())
        expect = dict(zip(species, (int(n) for n in counts[rank])))
        plan.append((rank, sp, id_offset, expect))
    return n_files, npart_total, plan


def write_sharded_gadget_files(parts: dict, box_size, base_filename,
                               dtype="float32", overwrite=False, code=None,
                               center_offset=None):
    """Write sharded pipeline output as a multi-file Gadget snapshot.

    Writes ``{base}.{k}.h5`` for the shard ``k`` this rank owns; across
    the world the files form one consistent snapshot: ``NumFilesPerSnapshot``
    is the global shard count, ``NumPart_Total`` the global post-clip
    totals, and the ``ParticleIDs`` are globally unique (shard by shard,
    species by species).  Every rank of the world must call it.

    ``center_offset``: pipeline draws are centered on the merger frame;
    pass an offset (e.g. ``box_size/2``) to shift positions into the
    [0, box_size] Gadget box.  Returns the list of files this rank
    wrote."""
    base = Path(base_filename)
    n_files, npart_total, plan = _export_plan(parts, box_size, center_offset)
    written = []
    for rank, sp, id_offset, expect in plan:
        fn = base.parent / f"{base.name}.{rank}.h5"
        num = sp.write_to_gadget_file(fn, box_size, dtype=dtype,
                                      overwrite=overwrite, code=code,
                                      num_files=n_files, file_num=rank,
                                      id_offset=id_offset,
                                      npart_total=npart_total)
        for p, n in num.items():
            if n != expect[p]:
                raise RuntimeError(
                    f"shard {rank} wrote {n} {p} particles but the "
                    f"collective count saw {expect[p]}: snapshot headers "
                    "would be inconsistent")
        written.append(fn)
    return written
