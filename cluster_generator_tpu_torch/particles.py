"""The particle container.

:class:`ClusterParticles` is a (ptype, field)-keyed dict of tensors in
galactic units on one device: float64, except ``particle_index``, which
keeps its integer dtype.  Nothing here copies a field to the host but the
writer :meth:`ClusterParticles.write_particles` and the explicit
:meth:`ClusterParticles.to_numpy`.  The Gadget reader and writer, the yt
bridge and the combine/resample functions of
``cluster_generator_tpu.particles`` are not part of this module yet.
"""

from __future__ import annotations

import math
from collections import OrderedDict, defaultdict
from pathlib import Path

import numpy as np
import torch

from .core import constants as C
from .core.device import resolve_device
from .core.logging import mylog

__all__ = ["ClusterParticles", "gadget_fields", "ptype_map", "rptype_map"]

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
        # particle_index carries Gadget IDs: it keeps its integer dtype
        if key[1] == "particle_index":
            if isinstance(value, torch.Tensor):
                return value.to(self.device)
            return torch.as_tensor(np.array(value),
                                   device=self.device)
        if isinstance(value, torch.Tensor):
            return value.to(device=self.device, dtype=torch.float64)
        return torch.as_tensor(np.array(value, dtype=np.float64),
                               device=self.device)

    def __init__(self, particle_types, fields, device=None):
        self.particle_types = _ensure_list(particle_types)
        if device is None:
            device = next((v.device for v in fields.values()
                           if isinstance(v, torch.Tensor)), "cuda")
        self.device = resolve_device(device)
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
        """Every field as a numpy array on the host."""
        return OrderedDict((k, v.detach().cpu().numpy())
                           for k, v in self.fields.items())

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
        pos = self.fields[ptype, "particle_position"]
        keep = ~torch.logical_or((pos < 0.0).any(dim=1),
                                 (pos > box_size).any(dim=1))
        dropped = keep.numel() - int(keep.sum())
        if dropped > 0.05 * keep.numel():
            mylog.warning(
                "dropping %d/%d %s particles outside the box [0, %g]^3: "
                "centre the scene inside the box (centres near box_size/2)",
                dropped, keep.numel(), ptype, box_size)
        return keep

    def __add__(self, other):
        """Concatenate two containers (the result lives on this one's
        device).  For particle types both operands carry, only fields
        present in both survive: a field of one operand has no values for
        the other's particles.  Dropped names are logged.  Passive-scalar
        registrations carry over for scalars that survive."""
        shared = set(self.particle_types) & set(other.particle_types)
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
        particle_types = list(set(self.particle_types + other.particle_types))
        out = ClusterParticles(particle_types, fields, device=self.device)
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
            cidx = (((self[part, "particle_position"] - center) ** 2)
                    .sum(dim=1) <= rm2)
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

        fields = OrderedDict()
        with h5py.File(filename, "r") as f:
            if ptypes is None:
                ptypes = list(f.keys())
            ptypes = _ensure_list(ptypes)
            for ptype in ptypes:
                for field in f[ptype]:
                    arr = f[ptype][field][()]
                    if field == "particle_index":
                        fields[ptype, field] = np.asarray(arr)
                    else:
                        fields[ptype, field] = arr.astype(np.float64)
        return cls(ptypes, fields, device=device)

    from_h5_file = from_file

    def write_particles(self, output_filename, overwrite=False):
        """Write native-HDF5 particles: one group per particle type, one
        dataset per field with a ``units`` attribute."""
        import h5py

        if Path(output_filename).exists() and not overwrite:
            raise IOError(f"Cannot create {output_filename}. "
                          "It exists and overwrite=False.")
        with h5py.File(output_filename, "w") as f:
            for ptype in self.particle_types:
                f.create_group(ptype)
            for (ptype, name), arr in self.to_numpy().items():
                ds = f[ptype].create_dataset(name, data=arr)
                if name != "particle_index":
                    ds.attrs["units"] = particle_field_units.get(name, "")

    def write_particles_to_h5(self, output_filename, overwrite=False):
        self.write_particles(output_filename, overwrite=overwrite)

    def set_field(self, ptype, name, value, units=None, add=False,
                  passive_scalar=False):
        """Add or update a particle field.

        ``units``: if given, ``value`` is interpreted in that unit and
        converted to galactic base units for storage."""
        value = self._coerce((ptype, name), value)
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
        """Shift positions and velocities."""
        if ptypes is None:
            ptypes = self.particle_types
        r_ctr = self._coerce(("", ""), r_ctr)
        v_ctr = self._coerce(("", ""), v_ctr)
        for ptype in _ensure_list(ptypes):
            self.fields[ptype, "particle_position"] = (
                self.fields[ptype, "particle_position"] + r_ctr)
            self.fields[ptype, "particle_velocity"] = (
                self.fields[ptype, "particle_velocity"] + v_ctr)
