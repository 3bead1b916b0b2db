"""Raw-I/O fast paths for contiguous HDF5 datasets (host code).

Plain ``os.pwrite``/``os.pread`` of a dataset's bytes at its allocated
file extent, with no HDF5 selection or sieve-buffer machinery in the path.
The bytes on disk are the ones ``h5py`` writes, so every HDF5 reader (h5py,
yt, the JAX package) sees the same dataset.

Eligibility is checked per dataset: contiguous (not chunked), no filters,
little-endian f4/f8, an allocated offset.  Callers must flush the owning
h5py file before raw access, so that pending sieve-buffer data cannot be
written back over raw writes (the helpers here do it).

``h5py`` is imported inside the functions that need it, never when this
module is imported: the package must import on machines without it.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["create_early_alloc", "RawSlabIO", "RawWriter", "RawReader",
           "read_slab"]

_RAW_DTYPES = (np.dtype("<f8"), np.dtype("<f4"))


def _pwrite_all(fd, buf, offset):
    """pwrite the whole buffer, looping over short writes (one os.pwrite
    is capped near 2 GB on Linux and can return short on a full disk;
    ignoring the count would corrupt the file silently)."""
    view = memoryview(buf).cast("B")
    done = 0
    while done < len(view):
        n = os.pwrite(fd, view[done:], offset + done)
        if n <= 0:
            raise OSError(f"pwrite returned {n} at offset {offset + done}"
                          f" ({done}/{len(view)} bytes written)")
        done += n


def _pread_all(fd, nbytes, offset):
    """pread exactly ``nbytes``; raises on a read cut short by EOF (an
    early-allocated dataset whose extent was never written lies beyond the
    physical EOF, and reading it is a caller's bug)."""
    chunks = []
    done = 0
    while done < nbytes:
        b = os.pread(fd, nbytes - done, offset + done)
        if not b:
            raise OSError(
                f"pread hit EOF at offset {offset + done} "
                f"({done}/{nbytes} bytes): dataset extent not on disk "
                "(unwritten early-alloc dataset?)")
        chunks.append(b)
        done += len(b)
    return chunks[0] if len(chunks) == 1 else b"".join(chunks)


def create_early_alloc(group, name, shape, dtype="f8"):
    """Create a contiguous float dataset whose file extent is allocated at
    creation (no fill written), so that writers can stream straight to its
    file offset with os.pwrite.

    ALLOC_TIME_EARLY pins the offset up front; FILL_TIME_NEVER keeps a
    multi-GB create instant (the extent is a hole until written: callers
    write every byte before readers arrive)."""
    import h5py

    h5t = {"f8": h5py.h5t.IEEE_F64LE, "f4": h5py.h5t.IEEE_F32LE}
    if dtype not in h5t:
        raise ValueError(f"dtype must be one of {sorted(h5t)}, "
                         f"got {dtype!r}")
    space = h5py.h5s.create_simple(shape)
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
    dcpl.set_fill_time(h5py.h5d.FILL_TIME_NEVER)
    did = h5py.h5d.create(group.id, name.encode(), h5t[dtype], space, dcpl)
    return h5py.Dataset(did)


def _raw_eligible(dset):
    # get_offset() is None for every non-contiguous layout (chunked, and so
    # filtered or compressed as well), so one low-level call covers them
    return (dset.id.get_offset() is not None
            and dset.dtype in _RAW_DTYPES)


class RawSlabIO:
    """Raw pread/pwrite of outer-dimension slabs of one contiguous dataset.

    ``eligible`` is False (callers use h5py) when the dataset is chunked or
    filtered, of another dtype, or has no allocated offset."""

    def __init__(self, fileio, dset):
        self.dtype = dset.dtype
        self.eligible = _raw_eligible(dset)
        if not self.eligible:
            self.fd = None
            return
        fileio.flush()
        self.offset = dset.id.get_offset()
        self.row_bytes = int(np.prod(dset.shape[1:])) * self.dtype.itemsize
        self.fd = os.open(fileio.filename, os.O_RDWR)

    def write(self, i0, blocks):
        blocks = np.ascontiguousarray(blocks, dtype=self.dtype)
        _pwrite_all(self.fd, blocks, self.offset + i0 * self.row_bytes)

    def accumulate(self, i0, blocks):
        nb = len(blocks) * self.row_bytes
        cur = np.frombuffer(
            _pread_all(self.fd, nb, self.offset + i0 * self.row_bytes),
            dtype=self.dtype).reshape(blocks.shape)
        self.write(i0, cur + blocks)

    def close(self):
        if self.fd is not None:
            os.close(self.fd)
            self.fd = None


class RawWriter:
    """Create-then-pwrite many whole datasets through one file descriptor.

    ``add`` creates an early-allocated dataset for ``arr`` under ``group``
    and queues its bytes; ``flush`` writes every queued array at its
    dataset's offset.  Arrays the low-level path cannot take (other dtypes)
    are written through h5py at once."""

    def __init__(self, fileio):
        self.fileio = fileio
        self.pairs = []

    def add(self, group, name, arr):
        """Create ``group[name]`` for ``arr`` and queue its bytes; returns
        the dataset (for attributes).  Its data is on disk only after
        :meth:`flush`."""
        arr = np.ascontiguousarray(arr)
        if arr.dtype == np.float32:
            dt = "f4"
        elif arr.dtype == np.float64:
            dt = "f8"
        else:
            return group.create_dataset(name, data=arr)
        ds = create_early_alloc(group, name, arr.shape, dt)
        if _raw_eligible(ds):
            self.pairs.append((ds, arr))
        else:  # pragma: no cover - early allocation always gives an offset
            ds[...] = arr
        return ds

    def flush(self):
        if not self.pairs:
            return
        self.fileio.flush()
        fd = os.open(self.fileio.filename, os.O_WRONLY)
        try:
            for ds, arr in self.pairs:
                _pwrite_all(fd, arr, ds.id.get_offset())
        finally:
            os.close(fd)
        self.pairs = []


class RawReader:
    """Whole-dataset pread companion of :class:`RawWriter`; datasets the
    raw path cannot take are read through h5py."""

    def __init__(self, fileio):
        self.fileio = fileio
        if fileio.mode != "r":  # pending buffered writes must land first
            fileio.flush()
        self.fd = os.open(fileio.filename, os.O_RDONLY)

    def read(self, dset):
        if not _raw_eligible(dset):
            return dset[()]
        nbytes = dset.size * dset.dtype.itemsize
        buf = _pread_all(self.fd, nbytes, dset.id.get_offset())
        return np.frombuffer(buf, dtype=dset.dtype).reshape(dset.shape)

    def close(self):
        if self.fd is not None:
            os.close(self.fd)
            self.fd = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_slab(dset, lo, hi):
    """``dset[lo:hi]`` (an outer-dimension slab) by pread when eligible,
    through h5py otherwise.  The result may be read-only.

    ``hi`` is clamped to the extent as the h5py slice clamps it (an
    unclamped pread past the extent would return the bytes of whatever
    follows in the file).  Negative bounds raise: h5py would wrap them
    while the raw path would read an empty slab, two meanings for one
    call."""
    if lo < 0 or hi < 0:
        raise ValueError(f"read_slab bounds must be >= 0, got "
                         f"lo={lo}, hi={hi}")
    n = dset.shape[0]
    lo = int(lo)
    hi = min(int(hi), n)
    if not _raw_eligible(dset):
        return dset[lo:hi]
    if hi <= lo:
        return np.empty((0,) + dset.shape[1:], dset.dtype)
    # pending h5py-buffered writes must land before raw access
    dset.file.flush()
    row = int(np.prod(dset.shape[1:])) * dset.dtype.itemsize
    fd = os.open(dset.file.filename, os.O_RDONLY)
    try:
        buf = _pread_all(fd, (hi - lo) * row,
                         dset.id.get_offset() + lo * row)
    finally:
        os.close(fd)
    return np.frombuffer(buf, dset.dtype).reshape((hi - lo,)
                                                  + dset.shape[1:])
