"""Chunk-batched fluid reads for the yt frontend.

A grid is one HDF5 chunk row, so a run of consecutive grid ids is read as
one hyperslab: ``_iter_hyperslabs`` yields those reads, and both selection
paths consume it.
"""

from __future__ import annotations

import numpy as np
from yt.utilities.io_handler import BaseIOHandler

from ..core.h5raw import read_slab

_FLUID = "cluster_generator"


def _iter_hyperslabs(dataset, grids):
    """Yield (grid, data_cube) over id-sorted grids, reading each maximal
    run of consecutive ids as one HDF5 hyperslab."""
    run = []
    for g in grids:
        if run and g.id != run[-1].id + 1:
            yield from _emit(dataset, run)
            run = []
        run.append(g)
    if run:
        yield from _emit(dataset, run)


def _emit(dataset, run):
    lo = run[0].id - run[0]._id_offset
    hi = run[-1].id - run[-1]._id_offset + 1
    block = read_slab(dataset, lo, hi)  # pread of a contiguous float slab
    # chunk rows are z-first on disk, block[n][k][j][i] = f(x_i, y_j, z_k):
    # transpose to the x-first (nx, ny, nz) cube yt's grid.select expects
    for i, g in enumerate(run):
        yield g, block[i].transpose(2, 1, 0)


class ClusterGeneratorIOHandler(BaseIOHandler):
    _particle_reader = False
    _dataset_type = _FLUID

    def __init__(self, ds):
        super().__init__(ds)
        self._handle = ds._handle

    # grid datasets carry no particles
    def _read_particle_coords(self, chunks, ptf):
        pass

    def _read_particle_fields(self, chunks, ptf, selector):
        pass

    def _read_fluid_selection(self, chunks, selector, fields, size):
        chunks = list(chunks)
        bad = [f for f in fields if f[0] != self._dataset_type]
        if bad:
            raise NotImplementedError(
                f"Field types {bad} not valid for dataset type "
                f"{self._dataset_type}.")
        out = {field: np.empty(size, dtype="=f8") for field in fields}
        for ftype, fname in fields:
            dset = self._handle[f"grid/{fname}"]
            offset = 0
            for chunk in chunks:
                for g, cube in _iter_hyperslabs(dset, chunk.objs):
                    offset += g.select(selector, cube,
                                       out[ftype, fname], offset)
        return out

    def _read_chunk_data(self, chunk, fields):
        out = {g.id: {} for g in chunk.objs}
        for field in fields:
            dset = self._handle[f"grid/{field[1]}"]
            for g, cube in _iter_hyperslabs(dset, chunk.objs):
                out[g.id][field] = cube
        return out
