"""Chunked uniform-grid HDF5 datasets for yt (the grid product).

* :func:`construct_chunks`: the chunkmap, index arithmetic in numpy;
* the painter: a radial spline field evaluated at the cell centres of a
  batch of chunks at once on the model's device (:func:`_paint_batch`, a
  captured program on the card), the radii clamped to the model's radial
  grid, each block in the z-first on-disk layout.  :func:`_paint_blocks`
  streams a field's batches to pinned host memory, batch k's copy
  overlapped with batch k+1's paint
  (``core/staging``), and needs no ``h5py``; :func:`_native_blocks` is
  the same stream painted on the host by the C++ painter (``ops/native``,
  ``engine="native"``);
* :class:`YTHDF5`: the file (``build``, ``load``, ``add_model`` with
  ``resume`` and accumulation, ``add_ICs``), written by pwrite at each
  dataset's offset (``core/h5raw``).

``h5py`` is imported inside the functions that open files.
"""

from __future__ import annotations

import hashlib
import pathlib as pt

import numpy as np
import torch

from .core import compiled
from .core import constants as C
from .core.device import host_to_device
from .core.h5raw import RawSlabIO, create_early_alloc
from .core.interp import cubic_spline, spline_eval
from .core.logging import mylog
from .core.staging import stream_to_host

__all__ = ["YTHDF5", "construct_chunks"]


def construct_chunks(domain_dimensions, chunksize: int) -> np.ndarray:
    """Chunkmap ``uint32[3, 2, Nchunks]`` of per-chunk (min, max) cell
    indices tiling the domain in cubes of side ``chunksize``."""
    dd = np.asarray(domain_dimensions, dtype=np.uint32)
    counts = (dd // chunksize).astype(int)
    ii, jj, kk = np.meshgrid(np.arange(counts[0]), np.arange(counts[1]),
                             np.arange(counts[2]), indexing="ij")
    starts = np.stack([ii.ravel(), jj.ravel(), kk.ravel()],
                      axis=0).astype(np.uint32) * np.uint32(chunksize)
    ends = starts + np.uint32(chunksize)
    return np.stack([starts, ends], axis=1)  # (3, 2, Nchunks)


def _paint_batch(sp, starts, deltas, left, cs, f32=False):
    """A radial spline field on the cell centres of a batch of chunks.

    ``sp``: a 1-D :class:`~.core.interp.CubicSpline`; ``starts`` (nb, 3)
    the first cell index of each chunk; ``deltas``/``left`` (3,) the cell
    widths and the left edge relative to the model's centre.  Returns
    (nb, cs, cs, cs) on the spline's device in the on-disk z-first layout
    ``block[k, j, i] = f(x_i, y_j, z_k)``, float32 when ``f32``.  Radii
    beyond the model's grid take the boundary value: no cubic
    extrapolation into the box corners."""
    dev, f64 = sp.x.device, torch.float64
    starts, deltas, left = (
        a.to(dev, f64) if isinstance(a, torch.Tensor)
        else host_to_device(a, dev, f64) for a in (starts, deltas, left))
    return _paint_program(sp, starts, deltas, left, cs=int(cs),
                          f32=bool(f32))


@compiled.function(static=("cs", "f32"))
def _paint_program(sp, starts, deltas, left, cs, f32):
    """The body of :func:`_paint_batch`: one program (JAX ``_paint_chunk``,
    static ``cs``) keyed by ``cs``, ``f32``, the batch's chunk count and
    the spline's length; the spline, the starts and the geometry are
    inputs."""
    f64 = torch.float64
    idx = torch.arange(cs, dtype=f64, device=starts.device)
    x, y, z = (left[a] + (starts[:, a, None] + idx + 0.5) * deltas[a]
               for a in range(3))
    rr = torch.sqrt(z[:, :, None, None] ** 2 + y[:, None, :, None] ** 2
                    + x[:, None, None, :] ** 2)
    rr = torch.clamp(rr, sp.x[0], sp.x[-1])
    out = spline_eval(sp, rr)
    return out.to(torch.float32) if f32 else out


def _paint_blocks(sp, chunk_starts, deltas, left, cs, batch=64, f32=False):
    """The painter's stream: yields ``(i0, host_blocks)`` for the chunks
    ``chunk_starts[i0:i0 + batch]``, each batch painted on the spline's
    device and brought to host memory while the next one paints (pinned,
    on a copy stream, for a CUDA spline; no copy on the CPU).  A batch's
    blocks are valid until the next one is asked for."""
    dev = sp.x.device
    starts, deltas, left = (host_to_device(a, dev, torch.float64)
                            for a in (chunk_starts, deltas, left))

    def programs():
        for i0 in range(0, starts.shape[0], batch):
            yield i0, [_paint_batch(sp, starts[i0:i0 + batch], deltas, left,
                                    cs, f32)]

    for i0, (blocks,) in stream_to_host(programs()):
        yield i0, blocks


def _check_engine(engine):
    if engine not in ("device", "native"):
        raise ValueError(f"engine must be 'device' or 'native', got "
                         f"{engine!r}")


def _native_blocks(sp, chunk_starts, deltas, left, cs, batch=64, f32=False):
    """The host painter's stream: yields ``(i0, host_blocks)`` like
    :func:`_paint_blocks`, painted by the C++ painter
    (``ops/native.paint_radial_chunks``) into one reused float64 buffer
    (a fresh ~100 MB buffer per batch costs first-touch page faults
    several times the paint), cast into a reused float32 buffer when
    ``f32``.  A batch's blocks are valid until the next one is asked
    for."""
    from .ops import native

    buf = buf32 = None
    for i0 in range(0, chunk_starts.shape[0], batch):
        starts = np.asarray(chunk_starts[i0:i0 + batch]).astype(np.int64)
        if buf is None or buf.shape[0] != starts.shape[0]:
            buf = np.empty((starts.shape[0], cs, cs, cs), dtype=np.float64)
            buf32 = np.empty(buf.shape, np.float32) if f32 else None
        blocks = native.paint_radial_chunks(sp, starts, cs, deltas, left,
                                            out=buf)
        if f32:
            np.copyto(buf32, blocks, casting="same_kind")
            blocks = buf32
        yield i0, blocks


def _host64(t):
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", torch.float64).numpy()
    return np.asarray(t, np.float64)


def _paint_config_digest(model, center, velocity):
    """sha256 of everything that shapes a painted field's values, recorded
    by the first ``add_model`` so that ``resume=True`` can refuse a call
    whose completed fields would mix two configurations.  The same digest
    as the JAX package's for the same arrays."""
    h = hashlib.sha256()
    h.update(np.asarray(center, np.float64).tobytes())
    h.update(np.asarray(velocity, np.float64).tobytes())
    h.update(_host64(model["radius"]).tobytes())
    for name in sorted(model.fields):
        h.update(name.encode())
        h.update(np.ascontiguousarray(_host64(model[name])).tobytes())
    # the convention changes the painted magnetic_pressure values
    h.update(b"gaussian" if getattr(model, "magnetic_gaussian", True)
             else b"lorentz-heaviside")
    return h.hexdigest()


class YTHDF5:
    """The chunked-grid HDF5 file that yt reads."""

    _yt_fields = {
        "density": "Msun/kpc**3",
        "dark_matter_density": "Msun/kpc**3",
        "stellar_density": "Msun/kpc**3",
        "pressure": "Msun/(kpc*Myr**2)",
        "momentum_density_x": "Msun/(Myr*kpc**2)",
        "momentum_density_y": "Msun/(Myr*kpc**2)",
        "momentum_density_z": "Msun/(Myr*kpc**2)",
        "magnetic_pressure": "Msun/(kpc*Myr**2)",
    }

    def __init__(self, filename):
        import h5py

        self.filename = pt.Path(filename)
        if not self.filename.exists():
            raise FileNotFoundError(
                f"The file {self.filename} doesn't appear to exist.")
        with h5py.File(self.filename, "r") as fo:
            self.chunkmap = fo["chunks"]["chunkmap"][:]
            self._attrs = dict(fo.attrs)
            ds = next(iter(fo["grid"].values()), None)
            self._itemsize = 8 if ds is None else ds.dtype.itemsize

    def __str__(self):
        return f"<YTHDF5 File @ {self.filename}>"

    __repr__ = __str__

    @property
    def domain_dimensions(self):
        return self._attrs["domain_dimensions"]

    @property
    def bbox(self):
        return self._attrs["bbox"]

    @property
    def chunksize(self):
        return int(self._attrs["chunksize"])

    @property
    def model_count(self):
        import h5py

        with h5py.File(self.filename, "r") as fo:
            return int(fo.attrs["model_count"])

    @classmethod
    def load(cls, filename):
        return cls(filename)

    @classmethod
    def build(cls, filename, domain_dimensions=(512, 512, 512), bbox=None,
              overwrite=False, chunksize=64, dtype="f8"):
        """Create the file's schema: attrs, the chunkmap, and one
        early-allocated dataset per field of shape (Nchunks, cs, cs, cs).

        ``dtype``: "f8" (default) or "f4" on disk (half the bytes)."""
        import h5py

        filename = pt.Path(filename)
        if dtype not in ("f8", "f4"):
            raise ValueError(f"dtype must be 'f8' or 'f4', got {dtype!r}")
        domain_dimensions = np.array(domain_dimensions, dtype="uint32")
        if bbox is None:
            bbox = np.array([[0, 1]] * 3, dtype="float64")
        bbox = np.asarray(bbox, dtype="float64")
        if np.any(domain_dimensions % chunksize):
            raise ValueError(
                "The chunksize does not evenly divide the domain. Please "
                "alter your chunksize so that it fits.")
        if filename.exists() and not overwrite:
            raise IOError(f"Could not create YTHDF5 object at {filename} "
                          "because it already exists.")
        elif filename.exists():
            mylog.info("%s exists. Overwriting it...", filename)
            filename.unlink()

        with h5py.File(filename, "w") as buf:
            buf.attrs["domain_dimensions"] = domain_dimensions
            buf.attrs["bbox"] = bbox
            buf.attrs["chunksize"] = chunksize
            buf.attrs["model_count"] = 0
            # the MEAN molecular weight, from which yt's frontend derives
            # T = (P / rho) mu m_p / k_B, as the models' own temperature
            buf.attrs["mu"] = C.mu
            grid = buf.create_group("grid")
            chunks = buf.create_group("chunks")
            chunkmap = construct_chunks(domain_dimensions, chunksize)
            chunks.create_dataset("chunkmap", data=chunkmap, dtype="uint32")
            for field, unit in cls._yt_fields.items():
                ds = create_early_alloc(
                    grid, field, (chunkmap.shape[-1], chunksize, chunksize,
                                  chunksize), dtype=dtype)
                ds.attrs["unit"] = unit
        return cls.load(filename)

    # --------------------------------------------------------------- sizes
    @property
    def _estimated_size(self):
        return (np.prod(np.array(self.domain_dimensions)) * self._itemsize
                * len(self._yt_fields) / 1e9)

    @property
    def _estimated_chunk_memory(self):
        return (self.chunksize ** 3) * self._itemsize / 1e9

    def survey_memory(self):
        """Log the grid's size on disk, one chunk's size and the free host
        memory."""
        mylog.info("MEMORY SURVEY: %s.", self.filename)
        mylog.info("Total size: %s GB.",
                   np.round(self._estimated_size, decimals=4))
        mylog.info("Chunk size: %s GB.",
                   np.round(self._estimated_chunk_memory, decimals=4))
        try:
            import psutil
        except ImportError:
            return
        avail = psutil.virtual_memory().available / 1e9
        mylog.info("Free memory: %s GB", np.round(avail, decimals=3))
        if avail < self._estimated_chunk_memory:
            mylog.warning("Free memory may be insufficient for chunked "
                          "operations.")

    # -------------------------------------------------------------- adding
    @staticmethod
    def _model_field(model, field):
        """The radial profile painted for ``field``, float64 on the model's
        device, or None when the model lacks it.  ``magnetic_pressure`` is
        B^2 / (8 pi) (Gaussian) or B^2 / 2 (Lorentz-Heaviside), as the
        model's field was set, converted from erg/cm^3."""
        if field == "magnetic_pressure":
            if "magnetic_field_strength" not in model.fields:
                return None
            from .core import units as U

            B = model["magnetic_field_strength"]
            if getattr(model, "magnetic_gaussian", True):
                p_B = B ** 2 / (8.0 * np.pi)
            else:
                p_B = B ** 2 / 2.0
            return p_B * U.unit_factor("erg/cm**3")
        if field in model.fields:
            return model[field]
        mylog.debug("Field %s not in model; skipping.", field)
        return None

    def add_model(self, model, center, velocity, engine: str = "device",
                  resume: bool = False):
        """Paint a :class:`~.model.ClusterModel` onto the grid.

        ``engine="device"`` paints on the model's device;
        ``engine="native"`` on the host, by the multithreaded C++ painter
        of ``native/cg_native.cpp`` (``ops/native``), which raises when it
        cannot be built.  The blocks go to the same sinks either way.

        The momentum densities are the density paint scaled by each
        component of ``velocity`` (no repaint).  A second and later model
        adds to the fields.  ``resume=True`` restarts an interrupted FIRST
        ``add_model``: fields recorded complete are kept, the rest
        repainted whole; it refuses when ``model_count > 0`` (a partly
        added field cannot be told from a finished one) and when the
        (model, center, velocity) digest differs from the interrupted
        call's."""
        import h5py

        _check_engine(engine)
        center = np.asarray(center, dtype=np.float64)
        velocity = np.asarray(velocity, dtype=np.float64)
        bbox = np.asarray(self.bbox)
        mylog.info("Adding %s to %s", model, self)

        rr = model["radius"]
        cs = self.chunksize
        chunk_starts = self.chunkmap[:, 0, :].T.astype(np.float64)  # (Nc, 3)
        deltas = (bbox[:, 1] - bbox[:, 0]) / np.asarray(self.domain_dimensions)
        left = (bbox - center.reshape(3, 1))[:, 0]

        digest = _paint_config_digest(model, center, velocity)
        with h5py.File(self.filename, "a") as fo:
            if resume:
                if int(fo.attrs["model_count"]) != 0:
                    raise ValueError(
                        "resume=True is only valid for the FIRST model on a "
                        "grid: later models accumulate into the datasets "
                        "and a partially-accumulated field cannot be "
                        "detected; rebuild instead")
                have = fo.attrs.get("_paint_config")
                if have is None:
                    mylog.warning(
                        "%s predates the paint-config digest; resume cannot "
                        "verify this call matches the interrupted one",
                        self.filename)
                elif have != digest:
                    raise ValueError(
                        "resume=True with a different (model, center, "
                        "velocity) than the interrupted add_model: completed "
                        "fields would keep the OLD configuration; rebuild "
                        "instead")
                done = set(fo.attrs.get("_fields_done", ()))
                if done:
                    mylog.info("Resuming: %d field(s) already painted.",
                               len(done))
            else:
                done = set()
                fo.attrs["_fields_done"] = []
                fo.attrs["_paint_config"] = digest
            for field in self._yt_fields:
                if field in done or "momentum_density" in field:
                    continue  # momenta are scaled copies of the density
                yy = self._model_field(model, field)
                if yy is None:
                    continue
                extra_scaled = []
                if field == "density":
                    extra_scaled = [(f"momentum_density_{ax}", velocity[i])
                                    for i, ax in enumerate("xyz")]
                self._add_field(fo, rr, yy, field, left, deltas,
                                chunk_starts, cs,
                                accumulate=int(fo.attrs["model_count"]) > 0,
                                extra_scaled=extra_scaled, engine=engine)
                # the marker AFTER the field and its scaled copies are in
                # the file: a crash mid-field leaves it unlisted
                done.add(field)
                done.update(fn for fn, _ in extra_scaled)
                fo.attrs["_fields_done"] = sorted(done)
                fo.flush()
            mylog.info("Core fields of %s were written to %s.", model, self)
            fo.attrs["model_count"] += 1

    def add_ICs(self, ics, engine: str = "device"):
        """Paint every halo model of a :class:`~.ics.ClusterICs` scene at its
        centre with its bulk velocity, by ``engine`` (see
        :meth:`add_model`)."""
        mylog.info("Adding %s to %s.", ics.basename, self)
        for ic_id in range(ics.num_halos):
            self.add_model(ics.load_model(ic_id), ics.center[ic_id],
                           ics.velocity[ic_id], engine=engine)

    def _add_field(self, fileio, r, y, fieldname, left, deltas, chunk_starts,
                   cs, batch=64, accumulate=True, extra_scaled=(),
                   engine="device"):
        """Paint one radial field on every chunk and write the blocks.

        ``accumulate=False`` (the first model) writes the blocks, otherwise
        they are added to what the file holds.  ``extra_scaled``:
        ``[(fieldname, factor), ...]``, datasets written as ``factor *
        blocks`` of the same paint (the momentum densities).  When every
        sink is float32 the blocks are cast to it before the sinks see
        them: on the device, before the copy to the host, or on the host
        for ``engine="native"``."""
        sp = cubic_spline(r, y)
        grid = fileio["grid"]
        sinks = [(grid[fn], RawSlabIO(fileio, grid[fn]), fac)
                 for fn, fac in [(fieldname, 1.0), *extra_scaled]]
        f32_out = all(ds.dtype == np.dtype("<f4") for ds, _, _ in sinks)
        scratch = None  # the reused scaled-copy buffer

        try:
            paint = _native_blocks if engine == "native" else _paint_blocks
            for i0, blocks in paint(sp, chunk_starts, deltas, left, cs,
                                    batch=batch, f32=f32_out):
                for ds, raw, fac in sinks:
                    if fac == 1.0:
                        blk = blocks
                    else:
                        if scratch is None or scratch.shape != blocks.shape:
                            scratch = np.empty_like(blocks)
                        blk = np.multiply(blocks, fac, out=scratch)
                    if raw.eligible:
                        (raw.accumulate if accumulate else raw.write)(i0, blk)
                    elif accumulate:
                        ds[i0:i0 + blk.shape[0], ...] += blk
                    else:
                        ds[i0:i0 + blk.shape[0], ...] = blk
        finally:
            for _, raw, _ in sinks:
                raw.close()
