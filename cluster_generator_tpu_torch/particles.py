"""Particle containers, gas mixing and Gadget I/O.

:class:`ClusterParticles` is a (ptype, field)-keyed dict of tensors in
galactic units on one device: float64, except ``particle_index``, which
keeps its integer dtype. The gas mixing of :func:`combine_two_clusters`,
:func:`combine_three_clusters` and the ``resample_*`` functions runs on
the particles' device, one halo at a time (halo models may sit on grids of
different sizes), as one program (:func:`~.core.compiled.function`; on the
card a memoized CUDA graph, replayed for halos of other parameters on
grids of the same sizes, at the capacity class of the gas count,
:func:`~.core.compiled.capacity`); the moves to the halos' centers and the
sum of the containers before it run op by op, marked as the stage ``mix``
(:func:`~.core.profiling.device_stage`). Each eager step here that
allocates on a card in proportion to the particles (a container's
conversions, the sum, the moves, the radial cut, the Gadget blocks) first
makes room for what it reckons from its inputs' sizes among the memoized
programs the card holds (:func:`~.core.compiled.room_for`). Nothing here
copies a field to the host but the writers,
:meth:`ClusterParticles.to_numpy` and
:meth:`ClusterParticles.to_yt_dataset`; the Gadget writer assembles its
blocks on the device and copies them to the host at once
(:meth:`ClusterParticles.gadget_blocks`, the stage ``export``). ``h5py``
and ``yt`` are imported inside the functions that need them.
"""

from __future__ import annotations

import math
from collections import OrderedDict, defaultdict
from pathlib import Path

import numpy as np
import torch

from .core import compiled
from .core import constants as C
from .core.device import f64_on, resolve_device
from .core.interp import bracket_for_spline, cubic_spline, spline_eval_at
from .core.logging import mylog
from .core.profiling import device_stage, span
from .core.staging import to_host

__all__ = [
    "ClusterParticles", "combine_two_clusters", "combine_three_clusters",
    "resample_one_cluster", "resample_two_clusters", "resample_three_clusters",
    "gadget_fields", "ptype_map", "rptype_map",
]

# ---------------------------------------------------------------- gadget maps
gadget_fields = {
    "dm": ["Coordinates", "Velocities", "Masses", "ParticleIDs", "Potential"],
    "gas": ["Coordinates", "Velocities", "Masses", "ParticleIDs",
            "InternalEnergy", "MagneticField", "Density", "Potential"],
    "star": ["Coordinates", "Velocities", "Masses", "ParticleIDs", "Potential"],
    "black_hole": ["Coordinates", "Velocities", "Masses", "ParticleIDs"],
    "tracer": ["Coordinates"],
}

code_fields = {"arepo": {"gas": ["PassiveScalars", "GFM_Metallicity"]}}

gadget_field_map = {
    "Coordinates": "particle_position",
    "Velocities": "particle_velocity",
    "Masses": "particle_mass",
    "Density": "density",
    "Potential": "potential_energy",
    "InternalEnergy": "thermal_energy",
    "MagneticField": "magnetic_field",
    "Metallicity": "metallicity",
    "GFM_Metallicity": "metallicity",
}

# conversion factor: galactic value / factor = gadget-file value
_MSUN_G = C.MSUN_KG * 1.0e3
_B_GADGET_IN_GAUSS = 1.0e5 * math.sqrt(_MSUN_G) * 1.0e5 / C.CM_PER_KPC**1.5

gadget_field_factors = {
    "Coordinates": 1.0,                      # kpc
    "Velocities": C.km_s,                    # km/s
    "Masses": 1.0e10,                        # 1e10 Msun
    "Density": 1.0e10,                       # 1e10 Msun/kpc^3
    "InternalEnergy": C.km_s**2,             # km^2/s^2
    "Potential": C.km_s**2,                  # km^2/s^2
    "PassiveScalars": 1.0,
    "MagneticField": _B_GADGET_IN_GAUSS,     # stored in gauss internally
    "Metallicity": 1.0,
    "GFM_Metallicity": 1.0,
}

ptype_map = OrderedDict([
    ("PartType0", "gas"), ("PartType1", "dm"), ("PartType2", "tracer"),
    ("PartType4", "star"), ("PartType5", "black_hole"),
])
rptype_map = OrderedDict([(v, k) for k, v in ptype_map.items()])

#: native HDF5 units metadata for particle fields
particle_field_units = {
    "particle_position": "kpc",
    "particle_velocity": "kpc/Myr",
    "particle_mass": "Msun",
    "particle_potential": "kpc**2/Myr**2",
    "potential_energy": "kpc**2/Myr**2",
    "thermal_energy": "kpc**2/Myr**2",
    "density": "Msun/kpc**3",
    "magnetic_field": "gauss",
    "velocity": "kpc/Myr",
    "magnetic_vector_potential": "gauss*kpc",
    "metallicity": "",
}


def _ensure_list(x):
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


class ClusterParticles:
    """Container for multi-species particle ICs on one device.

    ``device``: where the fields live.  ``None`` takes the device of the
    first tensor among ``fields``, and the card when there is none (arrays
    only); pass ``"cpu"`` to keep arrays on the CPU."""

    def _coerce(self, key, value):
        # particle_index carries Gadget IDs: it stays integral, the
        # unsigned ones (uint32 in Gadget files) widened to int64, since
        # torch's unsigned types lack most operations; the source dtype is
        # remembered, and the host copy (to_numpy, the writers) casts back
        if key[1] == "particle_index":
            self._index_dtypes.pop(key[0], None)
            if not isinstance(value, torch.Tensor):
                value = np.array(value)
                if value.dtype.kind == "u":
                    self._index_dtypes[key[0]] = value.dtype
                    value = value.astype(np.int64)
                value = torch.as_tensor(value)
            elif value.dtype in (torch.uint16, torch.uint32, torch.uint64):
                self._index_dtypes[key[0]] = np.dtype(
                    str(value.dtype).removeprefix("torch."))
                value = self._moved(value, torch.int64)
            return self._moved(value, value.dtype)
        if not isinstance(value, torch.Tensor):
            value = torch.as_tensor(np.array(value, dtype=np.float64))
        return self._moved(value, torch.float64)

    def _moved(self, value, dtype):
        """``value`` as ``dtype`` on this container's device, room made
        there first when that is a new tensor."""
        if value.dtype != dtype or value.device != (
                compiled.card(self.device) if value.is_cuda else self.device):
            compiled.room_for(self.device, (value.numel(), dtype))
        return value.to(device=self.device, dtype=dtype)

    def __init__(self, particle_types, fields, device=None):
        self.particle_types = _ensure_list(particle_types)
        if device is None:
            device = next((v.device for v in fields.values()
                           if isinstance(v, torch.Tensor)), "cuda")
        self.device = resolve_device(device)
        self._index_dtypes = {}  # ptype -> unsigned dtype of its source IDs
        self.fields = OrderedDict(
            (k, self._coerce(k, v)) for k, v in fields.items())
        self._update_num_particles()
        self._update_field_names()
        self.passive_scalars: list[str] = []

    def __repr__(self):
        counts = ", ".join(f"{k}: {v:,}" for k, v in self.num_particles.items())
        return f"<ClusterParticles {{{counts}}} on {self.device}>"

    __str__ = __repr__

    def __getitem__(self, key):
        return self.fields[key]

    def __setitem__(self, key, value):
        self.fields[key] = self._coerce(key, value)

    def keys(self):
        return self.fields.keys()

    def to_numpy(self) -> "OrderedDict":
        """Every field as a numpy array on the host; IDs read as unsigned
        come back in their source dtype."""
        out = OrderedDict((k, v.detach().cpu().numpy())
                          for k, v in self.fields.items())
        for ptype, dtype in self._index_dtypes.items():
            if (ptype, "particle_index") in out:
                out[ptype, "particle_index"] = \
                    out[ptype, "particle_index"].astype(dtype)
        return out

    def _update_num_particles(self):
        self.num_particles = {}
        for ptype in self.particle_types:
            self.num_particles[ptype] = int(
                self.fields[ptype, "particle_mass"].shape[0])

    def _update_field_names(self):
        self.field_names = defaultdict(list)
        for field in self.fields:
            self.field_names[field[0]].append(field[1])

    def _clip_to_box(self, ptype, box_size):
        """Mask of particles inside the Gadget box [0, box_size]^3.

        Gadget boxes start at the origin, so a scene built around (0,0,0)
        must be offset (centres near box_size/2) before writing; a large
        drop is logged, because an origin-centred scene loses 7/8 of its
        particles to the positive octant."""
        keep = self._box_mask(ptype, box_size)
        self._log_dropped(ptype, int(keep.sum()), keep.numel(), box_size)
        return keep

    def _box_mask(self, ptype, box_size):
        pos = self.fields[ptype, "particle_position"]
        return ~torch.logical_or((pos < 0.0).any(dim=1),
                                 (pos > box_size).any(dim=1))

    @staticmethod
    def _log_dropped(ptype, kept, total, box_size):
        dropped = total - kept
        if dropped > 0.05 * total:
            mylog.warning(
                "dropping %d/%d %s particles outside the box [0, %g]^3: "
                "centre the scene inside the box (centres near box_size/2)",
                dropped, total, ptype, box_size)

    def __add__(self, other):
        """Concatenate two containers (the result lives on this one's
        device).  For particle types both operands carry, only fields
        present in both survive: a field of one operand has no values for
        the other's particles.  Dropped names are logged.  Passive-scalar
        registrations carry over for scalars that survive."""
        shared = set(self.particle_types) & set(other.particle_types)
        compiled.room_for(self.device, *(
            t for field, arr in self.fields.items()
            if field[0] in shared and field in other.fields
            for t in (arr, other[field])))
        fields = OrderedDict()
        for field, arr in self.fields.items():
            if field[0] not in shared:
                fields[field] = arr
            elif field in other.fields:
                fields[field] = torch.cat(
                    [arr, other[field].to(self.device)])
            else:
                mylog.warning(
                    "ClusterParticles.__add__: dropping %s, present in "
                    "only one operand (no values exist for the other's "
                    "particles)", field)
        for field, arr in other.fields.items():
            if field[0] not in shared:
                fields[field] = arr
            elif field not in self.fields:
                mylog.warning(
                    "ClusterParticles.__add__: dropping %s, present in "
                    "only one operand (no values exist for the other's "
                    "particles)", field)
        # an ordered union: the order (and with it the Gadget ID ranges
        # per type) must not depend on the interpreter's hash seed
        particle_types = list(dict.fromkeys(self.particle_types
                                            + other.particle_types))
        out = ClusterParticles(particle_types, fields, device=self.device)
        out._index_dtypes = {**other._index_dtypes, **self._index_dtypes}
        out.passive_scalars = [
            s for s in dict.fromkeys(self.passive_scalars
                                     + other.passive_scalars)
            if ("gas", s) in fields]
        return out

    @property
    def num_passive_scalars(self):
        return len(self.passive_scalars)

    def drop_ptypes(self, ptypes):
        """Remove all particles of the given types."""
        ptypes = _ensure_list(ptypes)
        for ptype in ptypes:
            self.particle_types.remove(ptype)
            for name in list(self.fields.keys()):
                if name[0] in ptypes:
                    self.fields.pop(name)
        self._update_num_particles()
        self._update_field_names()

    def make_radial_cut(self, r_max, center=None, ptypes=None):
        """Drop particles outside ``r_max`` of ``center``."""
        rm2 = r_max * r_max
        if center is None:
            center = torch.zeros(3, dtype=torch.float64, device=self.device)
        else:
            center = torch.as_tensor(np.asarray(center, dtype=np.float64),
                                     device=self.device)
        if ptypes is None:
            ptypes = self.particle_types
        for part in _ensure_list(ptypes):
            # the squared offsets and their sum, the mask, and every field
            # at most whole
            pos = self[part, "particle_position"]
            compiled.room_for(self.device, pos, pos,
                              (pos.shape[0], torch.bool),
                              *(self.fields[part, f]
                                for f in self.field_names[part]))
            cidx = (((pos - center) ** 2).sum(dim=1) <= rm2)
            for field in self.field_names[part]:
                self.fields[part, field] = self.fields[part, field][cidx]
        self._update_num_particles()

    def add_black_hole(self, bh_mass, pos=None, vel=None, use_pot_min=False):
        """Append a black-hole particle, at ``pos``/``vel`` or at the
        dark-matter particle of lowest potential."""
        def row(x):
            if x is None:
                return torch.zeros((1, 3), dtype=torch.float64,
                                   device=self.device)
            return self._coerce(("black_hole", ""), x).reshape(1, 3)

        mass = torch.tensor([bh_mass], dtype=torch.float64,
                            device=self.device)
        if use_pot_min:
            for key in (("dm", "potential_energy"),
                        ("dm", "particle_potential")):
                if key in self.fields:
                    break
            else:
                raise KeyError("('dm', 'potential_energy') / ('dm', "
                               "'particle_potential') is not available!")
            idx = torch.argmin(self.fields[key])
            pos = self.fields["dm", "particle_position"][idx].reshape(1, 3)
            vel = self.fields["dm", "particle_velocity"][idx].reshape(1, 3)
        else:
            pos, vel = row(pos), row(vel)
        if "black_hole" not in self.particle_types:
            self.particle_types.append("black_hole")
            self.fields["black_hole", "particle_position"] = pos
            self.fields["black_hole", "particle_velocity"] = vel
            self.fields["black_hole", "particle_mass"] = mass
        else:
            for name, new in (("particle_position", pos),
                              ("particle_velocity", vel),
                              ("particle_mass", mass)):
                self.fields["black_hole", name] = torch.cat(
                    [self.fields["black_hole", name], new])
        self._update_num_particles()
        self._update_field_names()

    # ------------------------------------------------------------------ IO
    @classmethod
    def from_fields(cls, fields, device=None):
        particle_types = []
        for key in fields:
            if key[0] not in particle_types:
                particle_types.append(key[0])
        return cls(particle_types, fields, device=device)

    @classmethod
    def from_file(cls, filename, ptypes=None, device="cuda"):
        """Read native-HDF5 particles onto ``device``."""
        import h5py

        from .core.h5raw import RawReader

        fields = OrderedDict()
        with h5py.File(filename, "r") as f, RawReader(f) as raw:
            if ptypes is None:
                ptypes = list(f.keys())
            ptypes = _ensure_list(ptypes)
            for ptype in ptypes:
                for field in f[ptype]:
                    arr = raw.read(f[ptype][field])
                    if field == "particle_index":
                        fields[ptype, field] = np.asarray(arr)
                    else:
                        fields[ptype, field] = arr.astype(np.float64)
        return cls(ptypes, fields, device=device)

    from_h5_file = from_file

    @classmethod
    def from_gadget_file(cls, filename, ptypes=None, device="cuda"):
        """Read a Gadget/AREPO/GIZMO HDF5 snapshot onto ``device``; the
        values are converted from the file's units to galactic ones."""
        import h5py

        from .core.h5raw import RawReader

        fields = OrderedDict()
        particle_types = []
        with h5py.File(filename, "r") as f, RawReader(f) as raw:
            if ptypes is None:
                ptypes = [k for k in f if k.startswith("PartType")]
            else:
                ptypes = [rptype_map[k] for k in _ensure_list(ptypes)]
            for ptype in ptypes:
                my_ptype = ptype_map[ptype]
                particle_types.append(my_ptype)
                g = f[ptype]
                for field in gadget_fields[my_ptype]:
                    if field in g:
                        if field == "ParticleIDs":
                            fields[my_ptype, "particle_index"] = g[field][:]
                        else:
                            fd = gadget_field_map[field]
                            fields[my_ptype, fd] = (
                                raw.read(g[field]).astype(np.float64)
                                * gadget_field_factors[field])
                if "Masses" not in g:
                    n_ptype = g["ParticleIDs"].size
                    n_type = int(ptype[-1])
                    m = f["Header"].attrs["MassTable"][n_type]
                    fields[my_ptype, "particle_mass"] = (
                        m * gadget_field_factors["Masses"]
                        * np.ones(n_ptype))
        return cls(particle_types, fields, device=device)

    @classmethod
    def from_gadget_files(cls, filenames, ptypes=None, device="cuda"):
        """Read a multi-file Gadget snapshot (``NumFilesPerSnapshot > 1``).

        ``filenames``: a list of shard paths, or the path of shard 0
        (``...0.h5`` / ``...0.hdf5``), from which the other names follow
        by the header's ``NumFilesPerSnapshot``.  Shards are concatenated
        in file order."""
        import h5py

        if isinstance(filenames, (str, Path)):
            first = Path(filenames)
            with h5py.File(first, "r") as f:
                n_files = int(f["Header"].attrs["NumFilesPerSnapshot"])
            stem, suffix = first.name, first.suffix
            if not stem.endswith(f".0{suffix}"):
                raise ValueError(f"Pass shard 0 (named *.0{suffix}) or an "
                                 f"explicit list; got {first}")
            base = stem[: -len(f".0{suffix}")]
            filenames = [first.parent / f"{base}.{i}{suffix}"
                         for i in range(n_files)]
        shards = [cls.from_gadget_file(fn, ptypes=ptypes, device=device)
                  for fn in filenames]
        out = shards[0]
        for s in shards[1:]:
            out = out + s
        return out

    def write_particles(self, output_filename, overwrite=False):
        """Write native-HDF5 particles: one group per particle type, one
        dataset per field with a ``units`` attribute."""
        import h5py

        from .core.h5raw import RawWriter

        if Path(output_filename).exists() and not overwrite:
            raise IOError(f"Cannot create {output_filename}. "
                          "It exists and overwrite=False.")
        with h5py.File(output_filename, "w") as f:
            for ptype in self.particle_types:
                f.create_group(ptype)
            raw = RawWriter(f)
            for (ptype, name), arr in self.to_numpy().items():
                ds = raw.add(f[ptype], name, arr)
                if name != "particle_index":
                    ds.attrs["units"] = particle_field_units.get(name, "")
            raw.flush()

    def write_particles_to_h5(self, output_filename, overwrite=False):
        self.write_particles(output_filename, overwrite=overwrite)

    def set_field(self, ptype, name, value, units=None, add=False,
                  passive_scalar=False):
        """Add or update a particle field.

        ``units``: if given, ``value`` is interpreted in that unit and
        converted to galactic base units for storage."""
        value = self._coerce((ptype, name), value)
        # the value converted from ``units``, the sum with the old one
        compiled.room_for(self.device, *[value] * (
            (units is not None) + (add and (ptype, name) in self.fields)))
        if units is not None:
            from .core.units import to_galactic

            value = to_galactic(value, units)
        num_particles = self.num_particles[ptype]
        exists = (ptype, name) in self.fields
        if value.shape[0] != num_particles:
            raise ValueError(f"The length of the array needs to be "
                             f"{num_particles} particles!")
        if exists:
            if add:
                self.fields[ptype, name] = self.fields[ptype, name] + value
            else:
                mylog.warning("Overwriting field (%s, %s).", ptype, name)
                self.fields[ptype, name] = value
        else:
            if add:
                raise RuntimeError(f"Field ({ptype}, {name}) does not exist "
                                   "and add=True!")
            self.fields[ptype, name] = value
            if passive_scalar and ptype == "gas":
                self.passive_scalars.append(name)
        self._update_field_names()

    def add_offsets(self, r_ctr, v_ctr, ptypes=None):
        """Shift positions and velocities (offsets given on the host go to
        the device through pinned memory: no host sync)."""
        if ptypes is None:
            ptypes = self.particle_types
        r_ctr, v_ctr = (self._coerce(("", ""), x)
                        if isinstance(x, torch.Tensor)
                        else f64_on(x, self.device) for x in (r_ctr, v_ctr))
        ptypes = _ensure_list(ptypes)
        compiled.room_for(self.device, *(
            self.fields[p, f] for p in ptypes
            for f in ("particle_position", "particle_velocity")))
        for ptype in ptypes:
            self.fields[ptype, "particle_position"] = (
                self.fields[ptype, "particle_position"] + r_ctr)
            self.fields[ptype, "particle_velocity"] = (
                self.fields[ptype, "particle_velocity"] + v_ctr)

    # ------------------------------------------------------------- gadget
    def _gadget_sources(self, ptype, code):
        """``(Gadget name, [fields])`` for every block of ``ptype`` but the
        IDs: the field it is made of, or the passive scalars it stacks."""
        fields = list(gadget_fields[ptype])
        if code in code_fields:
            fields += code_fields[code].get(ptype, [])
        for field in fields:
            if field == "ParticleIDs":
                continue
            if field == "PassiveScalars":
                if self.num_passive_scalars > 0:
                    yield field, [self[ptype, s]
                                  for s in self.passive_scalars]
                continue
            my_field = gadget_field_map[field]
            if ((ptype, my_field) not in self.fields
                    and my_field == "potential_energy"
                    and (ptype, "particle_potential") in self.fields):
                # the generators store 'particle_potential'
                my_field = "particle_potential"
            if (ptype, my_field) in self.fields:
                yield field, [self.fields[ptype, my_field]]

    def _gadget_field_blocks(self, ptype, index, dtype, code):
        """``(Gadget name, tensor)`` for every block of ``ptype`` but the
        IDs, at the particles ``index`` selects, in file units and
        ``dtype`` (the passive scalars keep float64, as written)."""
        for field, src in self._gadget_sources(ptype, code):
            if field == "PassiveScalars":
                yield field, torch.stack(src, dim=-1)[index]
            else:
                yield field, (src[0][index] / gadget_field_factors[field]
                              ).to(dtype)

    def _gadget_room(self, ptype, dtype, code):
        """Room for the Gadget blocks of ``ptype`` (:meth:`gadget_blocks`),
        as if every particle were in the box: the in-box masks, the index,
        each block in ``dtype`` (the passive scalars stacked, then
        selected, in float64), the selected and scaled float64 values of
        the largest block on their way to ``dtype``, and the IDs (int64,
        then int32)."""
        pos = self.fields[ptype, "particle_position"]
        n = pos.shape[0]
        sizes = [(2 * pos.numel() + 4 * n, torch.bool), (n, torch.int64),
                 (n, torch.int64), (n, torch.int32)]
        largest = 0
        for field, src in self._gadget_sources(ptype, code):
            numel = sum(t.numel() for t in src)
            if field == "PassiveScalars":
                sizes += [(numel, torch.float64)] * 2
            else:
                sizes.append((numel, dtype))
                largest = max(largest, numel)
        sizes += [(largest, torch.float64)] * 2
        compiled.room_for(self.device, *sizes)

    def _write_gadget_fields(self, ptype, h5_group, idxs, dtype, code,
                             raw=None):
        """Write the blocks of ``ptype`` but its IDs into ``h5_group`` for
        the particles the boolean mask ``idxs`` keeps."""
        _add = (raw.add if raw is not None
                else lambda g, k, v: g.create_dataset(k, data=v))
        self._gadget_room(ptype, _torch_dtype(dtype), code)
        index = torch.as_tensor(idxs, device=self.device)
        for field, block in self._gadget_field_blocks(ptype, index,
                                                      _torch_dtype(dtype),
                                                      code):
            _add(h5_group, field, block.cpu().numpy())

    def write_to_gadget_file(self, ic_filename, box_size, dtype="float32",
                             overwrite=False, code=None, num_files=1,
                             file_num=0, id_offset=0, npart_total=None):
        """Write a Gadget-HDF5 IC file.

        ``num_files``/``file_num``/``id_offset``/``npart_total`` serve
        multi-file snapshots (``NumFilesPerSnapshot > 1``): this container
        becomes file ``file_num`` of ``num_files`` with particle IDs from
        ``id_offset + 1`` and ``NumPart_Total`` from ``npart_total`` (a
        uint32[6]); with ``npart_total`` None the totals equal
        ``NumPart_ThisFile``.  Returns the per-type counts written."""
        import h5py

        from .core.h5raw import RawWriter

        if Path(ic_filename).exists() and not overwrite:
            raise IOError(f"Cannot create {ic_filename}. "
                          "It exists and overwrite=False.")
        blocks, num_particles, mass_table = self.gadget_blocks(
            box_size, dtype=dtype, code=code, id_offset=id_offset)
        with h5py.File(ic_filename, "w") as f:
            raw = RawWriter(f)  # pwrite at each dataset's offset
            for ptype, arrays in blocks.items():
                g = f.create_group(rptype_map[ptype])
                for name, arr in arrays.items():
                    raw.add(g, name, arr)
            raw.flush()
            hg = f.create_group("Header")
            hg.attrs["Time"] = 0.0
            hg.attrs["Redshift"] = 0.0
            hg.attrs["BoxSize"] = box_size
            hg.attrs["Omega0"] = 0.0
            hg.attrs["OmegaLambda"] = 0.0
            hg.attrs["HubbleParam"] = 1.0
            hg.attrs["NumPart_ThisFile"] = np.array(
                [num_particles.get("gas", 0), num_particles.get("dm", 0),
                 num_particles.get("tracer", 0), 0,
                 num_particles.get("star", 0),
                 num_particles.get("black_hole", 0)], dtype="uint32")
            hg.attrs["NumPart_Total"] = (
                hg.attrs["NumPart_ThisFile"] if npart_total is None
                else np.asarray(npart_total, dtype="uint32"))
            hg.attrs["NumPart_Total_HighWord"] = np.zeros(6, dtype="uint32")
            hg.attrs["NumFilesPerSnapshot"] = int(num_files)
            hg.attrs["MassTable"] = mass_table
            for flag in ["Flag_Sfr", "Flag_Cooling", "Flag_StellarAge",
                         "Flag_Metals", "Flag_Feedback",
                         "Flag_DoublePrecision", "Flag_IC_Info"]:
                hg.attrs[flag] = 0
            if code == "arepo":
                cg = f.create_group("Config")
                cg.attrs["VORONOI"] = 1
        return num_particles

    def gadget_blocks(self, box_size, dtype="float32", code=None,
                      id_offset=0):
        """Everything a Gadget file holds but its header's constants, built
        on the particles' device and staged to the host in one copy (into
        pinned memory, ``core.staging.to_host``): per type, in
        ``particle_types`` order, the particles inside the box [0,
        box_size]^3, their fields in file units (``gadget_field_factors``)
        cast to ``dtype`` (``code``'s fields added: ``"arepo"`` stacks the
        passive scalars, in float64), the IDs ``id_offset + 1, ...``
        running on from type to type (uint32 in the file), and the
        ``MassTable`` entry, which is the first cast mass, as the file
        gives it back.  Returns ``(blocks, counts, mass_table)``:
        ``blocks[ptype]`` maps each Gadget name to a numpy array, in file
        order with ``ParticleIDs`` last; ``counts[ptype]`` the particles in
        the box.  The host reads each type's in-box count (the one read
        before the copy); the work is the stage ``export``."""
        tdtype = _torch_dtype(dtype)
        names, tensors, counts = [], [], {}
        npart = id_offset
        first = self.fields[self.particle_types[0], "particle_position"]
        with device_stage("export", first):
            for ptype in self.particle_types:
                self._gadget_room(ptype, tdtype, code)
                keep = self._box_mask(ptype, box_size)
                with span("cg.wait.read"):
                    index = torch.nonzero(keep).squeeze(1)
                n = counts[ptype] = int(index.numel())
                self._log_dropped(ptype, n, keep.numel(), box_size)
                for field, block in self._gadget_field_blocks(ptype, index,
                                                              tdtype, code):
                    names.append((ptype, field))
                    tensors.append(block)
                ids = torch.arange(npart + 1, npart + 1 + n,
                                   dtype=torch.int64, device=self.device)
                names.append((ptype, "ParticleIDs"))
                tensors.append(ids.to(torch.int32))  # two's complement
                npart += n
            host = _to_host(tensors)
        blocks = OrderedDict((ptype, OrderedDict())
                             for ptype in self.particle_types)
        for (ptype, field), arr in zip(names, host):
            blocks[ptype][field] = arr
        mass_table = np.zeros(6)
        for ptype in ("star", "dm", "black_hole"):
            if counts.get(ptype, 0) > 0:
                mass_table[int(rptype_map[ptype][-1])] = \
                    blocks[ptype]["Masses"][0]
        return blocks, counts, mass_table

    def to_yt_dataset(self, box_size, ptypes=None):
        """In-memory yt particle dataset of the fields (copied to the
        host).  Needs ``yt``."""
        from yt import load_particles

        data = {}
        if ptypes is None:
            ptypes = self.particle_types
        for key, val in self.to_numpy().items():
            if key[0] not in ptypes:
                continue
            ptype, fname = key
            if fname == "particle_position":
                for i, ax in enumerate("xyz"):
                    data[ptype, f"particle_position_{ax}"] = (val[:, i], "kpc")
            elif fname == "particle_velocity":
                for i, ax in enumerate("xyz"):
                    data[ptype, f"particle_velocity_{ax}"] = (val[:, i],
                                                              "kpc/Myr")
            else:
                data[ptype, fname] = (val, particle_field_units.get(fname, ""))
        return load_particles(data, length_unit="kpc",
                              bbox=np.array([[0.0, box_size]] * 3),
                              mass_unit="Msun", time_unit="Myr")


def _torch_dtype(dtype):
    return getattr(torch, np.dtype(dtype).name)


def _to_host(tensors):
    """The tensors as numpy arrays through one staged copy: from a card the
    bytes go, laid end to end, to one pinned host buffer by non-blocking
    copies on a side stream (``core/staging.to_host``)."""
    if not tensors:
        return []
    return [a.view(_NUMPY_OF[t.dtype])
            for t, a in zip(tensors, to_host(tensors))]


_NUMPY_OF = {torch.float32: np.float32, torch.float64: np.float64,
             torch.int32: np.uint32}  # IDs: int32 bits read as uint32


# ----------------------------------------------------------- cluster mixing
def _halo_field(h, name, device):
    """Field ``name`` of a halo model (a ``ClusterModel`` or a dict of
    arrays) as a float64 tensor on ``device``."""
    return torch.as_tensor(h[name], dtype=torch.float64, device=device)


@compiled.function(static=("resample",), name="sample_clusters")
def _mix_gas(pos, columns, halos, centers, bulk, radii, resample):
    """The body of :func:`_sample_clusters` (one program): the new values
    of the gas ``columns`` (density, thermal energy, velocity, the passive
    scalars and, with ``resample``, the mass), each taking the old value
    outside the radial cut.  ``halos[h]``: ``None`` for a halo without
    gas, else its radius, density and pressure grids and its scalars' grids
    (``"scalars"``, by name); ``centers``/``bulk`` (H, 3); ``radii`` (H,)
    or ``None``.  The halo loop is unrolled: each halo's grid may have a
    size of its own."""
    # halo-centric radii for every halo, so that the radial cut holds
    # even where a halo has no gas fields
    halo_radius = [torch.sqrt(((pos - c) ** 2).sum(dim=1)) for c in centers]
    in_cut = None
    if radii is not None:
        in_cut = torch.zeros(pos.shape[0], dtype=torch.bool,
                             device=pos.device)
        for r_h, rc in zip(halo_radius, radii):
            in_cut |= r_h <= rc

    rho = e_sum = mom = 0.0
    per_halo = []
    for i, h in enumerate(halos):
        if h is None:
            continue
        rr, dens = h["radius"], h["density"]
        r_part = torch.clamp(halo_radius[i], rr[0], rr[-1])
        idx = bracket_for_spline(rr, r_part)
        rho_i = spline_eval_at(cubic_spline(rr, dens), r_part, idx)
        eint_grid = 1.5 * h["pressure"] / dens
        e_sum = e_sum + spline_eval_at(cubic_spline(rr, eint_grid), r_part,
                                       idx) * rho_i
        rho = rho + rho_i
        mom = mom + bulk[i][None, :] * rho_i[:, None]
        per_halo.append((h, rr, r_part, idx, rho_i))

    new = {}
    if resample:
        # the volume of the OLD density, before it is overwritten
        vol = columns["particle_mass"] / columns["density"]
        new["particle_mass"] = rho * vol
    new["density"] = rho
    new["thermal_energy"] = e_sum / rho
    new["particle_velocity"] = mom / rho[:, None]
    for name in per_halo[0][0]["scalars"]:
        mixed = 0.0
        for h, rr, r_part, idx, rho_i in per_halo:
            sp = cubic_spline(rr, h["scalars"][name])
            mixed = mixed + spline_eval_at(sp, r_part, idx) * rho_i
        new[name] = mixed / rho
    if in_cut is None:
        return new
    return {k: torch.where(in_cut.reshape(in_cut.shape + (1,) * (v.ndim - 1)),
                           v, columns[k]) for k, v in new.items()}


def _sample_clusters(particles, hses, center, velocity, radii=None,
                     resample=False, passive_scalars=None):
    """Mix overlapping gas distributions on the particles' device.

    Each halo's gas density is evaluated at every particle position and
    summed; thermal energy and bulk momentum mix density-weighted:
        rho   = sum_h rho_h(r_h)
        e_int = sum_h e_h rho_h / rho
        v     = sum_h v_h rho_h / rho
    One halo at a time, so that halos whose models sit on radial grids of
    different sizes mix as well.  Particle radii are clamped to each
    halo's grid: gas draws start below its first point and most particles
    lie far beyond the other halo's r_max, where the boundary polynomial's
    extrapolation can turn density or 1.5 P/rho negative.  With ``radii``
    only particles within ``radii[h]`` of some halo ``h`` are rewritten.
    The fields are written in place.

    One program (:func:`_mix_gas`), keyed by the number of halos, which
    of them have gas, their grids' sizes, ``resample``, whether ``radii``
    are given, the scalars' names and the capacity class of the gas count
    (:func:`~.core.compiled.capacity`: its inputs padded to the class, its
    outputs sliced back, the same values as at the count); the centers,
    velocities and radii are inputs.  It takes the old columns only where
    it keeps or reads them (outside ``radii``, or to resample).  It
    returns the new columns, written here into the particles' tensors.
    """
    scalars = list(passive_scalars) if passive_scalars else []
    dev = particles.device
    halos = []
    for h in hses:
        if "density" in h:
            halos.append({
                "radius": _halo_field(h, "radius", dev),
                "density": _halo_field(h, "density", dev),
                "pressure": _halo_field(h, "pressure", dev),
                "scalars": {s: _halo_field(h, s, dev) for s in scalars}})
        else:
            mylog.warning("No density field found in %s. Skipping.", h)
            halos.append(None)
    if all(h is None for h in halos):
        raise ValueError(
            "Gas mixing needs at least one halo model with a 'density' "
            f"field; none of the {len(hses)} provided models has one.")
    names = (["particle_mass"] if resample else []) + [
        "density", "thermal_energy", "particle_velocity"] + scalars
    pos = particles["gas", "particle_position"]
    num = pos.shape[0]
    size = compiled.capacity(num)
    read = resample or radii is not None
    if size > num:
        compiled.room_for(dev, *[
            (size * t[:1].numel(), t.dtype) for t in [pos] + [
                particles["gas", n] for n in (names if read else [])]])
    columns = {name: compiled.padded(particles["gas", name], size)
               for name in (names if read else [])}
    new = _mix_gas(compiled.padded(pos, size), columns, halos,
                   f64_on(center, dev), f64_on(velocity, dev),
                   None if radii is None else f64_on(radii, dev),
                   resample=bool(resample))
    for name in names:
        particles["gas", name].copy_(new[name][:num])
    return particles


def _combine(parts, hses, centers, velocities):
    """Every species moved to its halo's center, the collisionless ones
    given its bulk velocity, the containers summed, the gas mixed: the
    stage ``mix``."""
    centers = [np.asarray(c, dtype=np.float64) for c in centers]
    velocities = [np.asarray(v, dtype=np.float64) for v in velocities]
    first = next(iter(parts[0].fields.values()))
    with device_stage("mix", first):
        for particles, center in zip(parts, centers):
            if "gas" in particles.particle_types:
                particles.add_offsets(center, [0.0] * 3, ptypes=["gas"])
        for particles, center, velocity in zip(parts, centers, velocities):
            ptypes = [p for p in particles.particle_types if p != "gas"]
            particles.add_offsets(center, velocity, ptypes=ptypes)
        particles = parts[0]
        for p in parts[1:]:
            particles = particles + p
        if "gas" in particles.particle_types:
            particles = _sample_clusters(particles, hses, centers,
                                         velocities)
    return particles


def combine_two_clusters(particles1, particles2, hse1, hse2, center1, center2,
                         velocity1, velocity2):
    """Two halos' particles in one scene, the overlapping gas mixed."""
    return _combine([particles1, particles2], [hse1, hse2],
                    [center1, center2], [velocity1, velocity2])


def combine_three_clusters(particles1, particles2, particles3, hse1, hse2,
                           hse3, center1, center2, center3, velocity1,
                           velocity2, velocity3):
    """Three halos' particles in one scene, the overlapping gas mixed."""
    return _combine([particles1, particles2, particles3], [hse1, hse2, hse3],
                    [center1, center2, center3],
                    [velocity1, velocity2, velocity3])


@compiled.function(name="resample_one_cluster")
def _resample_one(pos, mass, density, rr, dens_grid, pres_grid, center):
    """The body of :func:`resample_one_cluster` (one program): the new
    thermal energy, mass and density of the gas."""
    # clamped to the model grid, as in _sample_clusters
    r = torch.clamp(torch.sqrt(((pos - center) ** 2).sum(dim=1)),
                    rr[0], rr[-1])
    idx = bracket_for_spline(rr, r)
    dens = spline_eval_at(cubic_spline(rr, dens_grid), r, idx)
    e_grid = 1.5 * pres_grid / dens_grid
    return {"thermal_energy": spline_eval_at(cubic_spline(rr, e_grid), r,
                                             idx),
            "particle_mass": dens * (mass / density), "density": dens}


def resample_one_cluster(particles, hse, center, velocity):
    """One halo's profiles resampled onto relaxed gas particles: density
    and thermal energy splined at each particle's radius, masses scaled by
    the new density at fixed volume, velocities set to ``velocity``.  One
    program (:func:`_resample_one`, the stage ``mix``); the velocities are
    written in place after it."""
    if "gas" not in particles.particle_types:
        return particles
    dev = particles.device
    pos = particles["gas", "particle_position"]
    with device_stage("mix", pos):
        new = _resample_one(
            pos, particles["gas", "particle_mass"],
            particles["gas", "density"], _halo_field(hse, "radius", dev),
            _halo_field(hse, "density", dev),
            _halo_field(hse, "pressure", dev), f64_on(center, dev))
    particles["gas", "thermal_energy"] = new["thermal_energy"]
    particles["gas", "particle_mass"] = new["particle_mass"]
    particles["gas", "particle_velocity"][:, :] = f64_on(velocity, dev)
    particles["gas", "density"] = new["density"]
    return particles


def resample_two_clusters(particles, hse1, hse2, center1, center2, velocity1,
                          velocity2, radii, passive_scalars=None):
    """Two halos' profiles resampled onto relaxed gas particles within
    ``radii`` of their centers, mixed as in :func:`combine_two_clusters`,
    masses scaled by the new density at fixed volume."""
    with device_stage("mix", particles["gas", "particle_position"]):
        return _sample_clusters(particles, [hse1, hse2], [center1, center2],
                                [velocity1, velocity2], radii=radii,
                                resample=True,
                                passive_scalars=passive_scalars)


def resample_three_clusters(particles, hse1, hse2, hse3, center1, center2,
                            center3, velocity1, velocity2, velocity3, radii,
                            passive_scalars=None):
    """:func:`resample_two_clusters` for three halos."""
    with device_stage("mix", particles["gas", "particle_position"]):
        return _sample_clusters(particles, [hse1, hse2, hse3],
                                [center1, center2, center3],
                                [velocity1, velocity2, velocity3],
                                radii=radii, resample=True,
                                passive_scalars=passive_scalars)
