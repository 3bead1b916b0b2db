"""The :class:`ClusterModel` container: the user-facing equilibrium model.

The API of ``cluster_generator_tpu.model.cluster_model`` on top of the
field-building functions of :mod:`.builders`.  Fields are float64 tensors in galactic
units (keV for temperature, gauss for B) on one device, given by
``device=`` on every constructor (the card unless ``"cpu"`` is asked for);
unit strings live in :data:`..core.units.FIELD_UNITS` and are applied
only at the I/O boundary.  The writers copy the fields to the host;
besides them only :meth:`ClusterModel._host_field` does, once per field
(a ``cg.wait.read`` span).  The builders' program calls are the stage
``models`` (:func:`~..core.profiling.device_stage`).
"""

from __future__ import annotations

import math
import os
import weakref
from collections import OrderedDict

import numpy as np
import torch

from ..core import units
from ..core.device import resolve_device
from ..core.grid import log_radius_grid
from ..core.interp import cubic_spline, interp, spline_eval
from ..core.logging import mylog
from ..core.profiling import device_stage, span
from ..core.quadrature import integrate_from
from .builders import (build_from_dens_and_tden, build_from_dens_and_temp,
                       build_no_gas)

__all__ = ["ClusterModel", "HydrostaticEquilibrium"]


def _tensor(value, device):
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=torch.float64)
    return torch.as_tensor(np.array(value, dtype=np.float64),
                           device=device)


class ClusterModel:
    """A single galaxy-cluster equilibrium model on a log-radius grid.

    ``device``: where the fields live.  ``None`` takes the device of the
    first tensor among ``fields``, and the card when there is none.  Its
    constructors and its DFs, virial checks and speed tables run as the
    captured programs of the builders and of :mod:`..virial`
    (:mod:`..core.compiled`: memoized CUDA graphs on the card, keyed by
    the profiles' structure, their parameters inputs), and so do its
    draws' tables and its draws (:mod:`..sampling`); its checks'
    reductions run eagerly, op by op."""

    default_fields = [
        "density", "temperature", "pressure", "total_density",
        "gravitational_potential", "gravitational_field", "total_mass",
        "gas_mass", "dark_matter_mass", "dark_matter_density",
        "stellar_density", "stellar_mass",
    ]

    _keep_units = ["entropy", "electron_number_density",
                   "magnetic_field_strength"]

    def __init__(self, num_elements: int, fields: dict,
                 gravity: str = "newtonian", device=None):
        self.num_elements = int(num_elements)
        if device is None:
            device = next((v.device for v in fields.values()
                           if isinstance(v, torch.Tensor)), "cuda")
        self.device = resolve_device(device)
        self.fields = OrderedDict((k, _tensor(v, self.device))
                                  for k, v in fields.items())
        # which gravity law produced these fields; informational, since
        # the fields already encode it
        self.gravity = gravity
        # ptype -> (weak reference to its virial object, the object's
        # state): see _virial
        self._virials = {}
        # the gas draws' tables (sampling._draw_tables)
        self._draw_tables = None
        # host copies of fields (see _host_field)
        self._host_fields = {}

    def __repr__(self):
        rr = self.fields.get("radius")
        span = (f"[{float(rr[0]):.3g}, {float(rr[-1]):.3g}] kpc"
                if rr is not None and len(rr) else "?")
        return (f"<ClusterModel: {self.num_elements} pts {span}, "
                f"{len(self.fields)} fields on {self.device}>")

    __str__ = __repr__

    # ------------------------------------------------------------ dict API
    def __getitem__(self, key):
        return self.fields[key]

    def __contains__(self, key):
        return key in self.fields

    def keys(self):
        return self.fields.keys()

    def to_numpy(self) -> "OrderedDict":
        """Every field as a numpy array on the host."""
        return OrderedDict((k, v.detach().cpu().numpy())
                           for k, v in self.fields.items())

    def _host_field(self, name):
        """Field ``name`` as a float64 numpy array, for what the host
        decides from it (the grid index of a draw's ``r_max``, the grid's
        log-uniform gate, an IC scene's particle counts): copied from the
        device once and kept until the field is replaced or written in
        place.  A model read from a file starts with the arrays it read."""
        t = self.fields[name]
        held = self._host_fields.get(name)
        if held is None or held[0] is not t or held[1] != t._version:
            with span("cg.wait.read"):
                held = (t, t._version, t.detach().cpu().numpy())
            self._host_fields[name] = held
        return held[2]

    # ------------------------------------------------------- lazy virials
    # A virial object refers to its model; the model keeps the object's
    # state (``VirialEquilibrium.__dict__``: the DF, the speed and draw
    # tables) and the object itself only weakly, so that a model and its
    # virials are no reference cycle.  They go, with their tables on the
    # card, when the last reference to the model (or to one of its
    # virials) goes, and not at the cyclic collector's next full pass,
    # which a stream of IC scenes meets seldom.  A virial asked for again
    # while nothing holds one is a new object on the same state.
    def _virial(self, ptype):
        held = self._virials.get(ptype)
        if held is None:
            return None
        virial = held[0]()
        if virial is None:
            from ..virial import VirialEquilibrium

            virial = object.__new__(VirialEquilibrium)
            virial.model = self
            virial.__dict__ = held[1]
            self._virials[ptype] = (weakref.ref(virial), held[1])
        return virial

    def _keep_virial(self, ptype, virial):
        if virial is None:
            self._virials.pop(ptype, None)
        else:
            self._virials[ptype] = (weakref.ref(virial), virial.__dict__)

    _dm_virial = property(
        lambda self: self._virial("dark_matter"),
        lambda self, v: self._keep_virial("dark_matter", v))
    _star_virial = property(
        lambda self: self._virial("stellar"),
        lambda self, v: self._keep_virial("stellar", v))

    @property
    def dm_virial(self):
        from ..virial import VirialEquilibrium

        virial = self._dm_virial
        if virial is None:
            virial = self._dm_virial = VirialEquilibrium(self, "dark_matter")
        return virial

    @property
    def star_virial(self):
        from ..virial import VirialEquilibrium

        virial = self._star_virial
        if virial is None and "stellar_density" in self:
            virial = self._star_virial = VirialEquilibrium(self, "stellar")
        return virial

    # --------------------------------------------------------- constructors
    @classmethod
    def from_arrays(cls, fields, device="cuda") -> "ClusterModel":
        """Build from a raw field dict; 'radius' is required."""
        return cls(int(np.prod(np.shape(fields["radius"]))), fields,
                   device=device)

    @classmethod
    def from_dens_and_tden(cls, rmin, rmax, density, total_density,
                           stellar_density=None, num_points=1000,
                           gravity="newtonian", gravity_params=None,
                           device="cuda"):
        """Hydrostatic model from gas and total density profiles.

        ``gravity``: a registered law name ("newtonian", "aqual",
        "qumond", "emond"); the matter mass from ``total_density`` maps
        to the field by the law."""
        mylog.info("Computing the profiles from density and total density.")
        rr = log_radius_grid(rmin, rmax, num_points,
                             device=resolve_device(device))
        with device_stage("models", rr):
            fields = build_from_dens_and_tden(
                rr, density, total_density, stellar_density,
                gravity=gravity, gravity_params=gravity_params)
        return cls(num_points, fields, gravity=gravity)

    @classmethod
    def from_dens_and_temp(cls, rmin, rmax, density, temperature,
                           stellar_density=None, num_points=1000,
                           gravity="newtonian", gravity_params=None,
                           device="cuda"):
        """Hydrostatic model from gas density and temperature.

        ``gravity``: a registered law name; the hydrostatic field inverts
        to the law's dynamical (matter) mass."""
        mylog.info("Computing the profiles from density and temperature.")
        rr = log_radius_grid(rmin, rmax, num_points,
                             device=resolve_device(device))
        with device_stage("models", rr):
            fields = build_from_dens_and_temp(
                rr, density, temperature, stellar_density, gravity=gravity,
                gravity_params=gravity_params)
        return cls(num_points, fields, gravity=gravity)

    @classmethod
    def from_dens_and_entr(cls, rmin, rmax, density, entropy,
                           stellar_density=None, num_points=1000,
                           gravity="newtonian", gravity_params=None,
                           device="cuda"):
        """Hydrostatic model from gas density and entropy:
        T = S * n_e^{2/3} with n_e = rho / (mu_e m_p) in cm^-3."""
        n_e = units.density_to_ne(density)
        temperature = entropy * n_e ** (2.0 / 3.0)
        return cls.from_dens_and_temp(rmin, rmax, density, temperature,
                                      stellar_density=stellar_density,
                                      num_points=num_points, gravity=gravity,
                                      gravity_params=gravity_params,
                                      device=device)

    @classmethod
    def no_gas(cls, rmin, rmax, total_density, stellar_density=None,
               num_points=1000, gravity="newtonian", gravity_params=None,
               device="cuda"):
        """Model without a gas component."""
        rr = log_radius_grid(rmin, rmax, num_points,
                             device=resolve_device(device))
        with device_stage("models", rr):
            fields = build_no_gas(
                rr, total_density, stellar_density, gravity=gravity,
                gravity_params=gravity_params)
        return cls(num_points, fields, gravity=gravity)

    # ----------------------------------------------------------------- I/O
    @classmethod
    def from_h5_file(cls, filename, r_min=None, r_max=None,
                     device="cuda") -> "ClusterModel":
        """Read a model from HDF5: per-field datasets under the
        ``fields/`` group with a ``units`` attribute, plus optional
        ``dm_df``/``star_df`` datasets carrying the distribution
        functions, so that the Eddington inversion is resumed, not
        recomputed."""
        import h5py

        from ..virial import VirialEquilibrium

        fields = OrderedDict()
        with h5py.File(filename, "r") as f:
            fnames = list(f["fields"].keys())
            in_cgs = f.attrs.get("unit_system", "galactic") == "cgs"
            gravity = str(f.attrs.get("gravity", "newtonian"))
            for field in fnames:
                arr = np.asarray(f["fields"][field][()], dtype=np.float64)
                if field not in cls._keep_units and in_cgs:
                    arr = arr / units.galactic_to_cgs_factor(field)
                fields[field] = arr
            dm_df = np.asarray(f["dm_df"][()]) if "dm_df" in f else None
            star_df = np.asarray(f["star_df"][()]) if "star_df" in f else None

        if r_min is None:
            r_min = 0.0
        if r_max is None:
            r_max = fields["radius"][-1] * 2
        mask = (fields["radius"] >= r_min) & (fields["radius"] <= r_max)
        for field in fnames:
            fields[field] = fields[field][mask]
        model = cls(int(mask.sum()), fields, gravity=gravity, device=device)
        model._host_fields = {k: (t, t._version, fields[k])
                              for k, t in model.fields.items()}
        if dm_df is not None:
            model._dm_virial = VirialEquilibrium(model, ptype="dark_matter",
                                                 df=dm_df[mask])
        if star_df is not None:
            model._star_virial = VirialEquilibrium(model, ptype="stellar",
                                                   df=star_df[mask])
        return model

    @staticmethod
    def _mask(radius, r_min, r_max):
        if r_min is None:
            r_min = 0.0
        if r_max is None:
            r_max = radius[-1] * 2
        return (radius >= r_min) & (radius <= r_max)

    def _field_for_output(self, k, v, in_cgs):
        if in_cgs:
            if k == "temperature":
                return units.keV_to_K(v), "K"
            if k not in self._keep_units:
                return (v * units.galactic_to_cgs_factor(k),
                        units.CGS_UNITS.get(k, ""))
        return v, units.FIELD_UNITS.get(k, "")

    def write_model_to_h5(self, output_filename, in_cgs=False, r_min=None,
                          r_max=None, overwrite=False):
        """Write the model to HDF5 (the schema :meth:`from_h5_file` reads);
        the DFs are masked like the fields."""
        import h5py

        if os.path.exists(output_filename) and not overwrite:
            raise IOError(f"Cannot create {output_filename}. "
                          "It exists and overwrite=False.")
        host = self.to_numpy()
        mask = self._mask(host["radius"], r_min, r_max)
        with h5py.File(output_filename, "w") as f:
            f.create_dataset("num_elements", data=int(mask.sum()))
            f.attrs["unit_system"] = "cgs" if in_cgs else "galactic"
            f.attrs["gravity"] = self.gravity
            g = f.create_group("fields")
            for k, v in host.items():
                fd, unit = self._field_for_output(k, v[mask], in_cgs)
                ds = g.create_dataset(k, data=fd)
                ds.attrs["units"] = unit
            for name, virial in (("dm_df", self._dm_virial),
                                 ("star_df", self._star_virial)):
                if virial is not None:
                    ds = f.create_dataset(
                        name, data=virial.df.cpu().numpy()[mask])
                    ds.attrs["units"] = "Msun*Myr**3/kpc**6"

    # astropy-parseable unit labels for the ECSV header
    _ECSV_UNIT_MAP = {"dimensionless": "", "gauss": "G"}

    def write_model_to_ascii(self, output_filename, in_cgs=False,
                             overwrite=False):
        """Write the model as an ECSV table, the format astropy's QTable
        emits: a YAML header in ``#`` comments, then space-delimited
        columns."""
        if os.path.exists(output_filename) and not overwrite:
            raise IOError(f"Cannot create {output_filename}. "
                          "It exists and overwrite=False.")
        names, cols, units_ = [], [], []
        for k, v in self.to_numpy().items():
            fd, unit = self._field_for_output(k, v, in_cgs)
            names.append(k)
            units_.append(self._ECSV_UNIT_MAP.get(unit, unit))
            cols.append(np.asarray(fd))
        lines = ["# %ECSV 1.0", "# ---", "# datatype:"]
        for name, unit in zip(names, units_):
            entry = f"# - {{name: {name}"
            if unit:
                entry += f", unit: {unit}"
            entry += ", datatype: float64}"
            lines.append(entry)
        lines.append("# meta: {comments: [unit_system="
                     f"{'cgs' if in_cgs else 'galactic'}]}}")
        lines.append("# schema: astropy-2.0")
        lines.append(" ".join(names))
        data = np.column_stack(cols)
        with open(output_filename, "w") as f:
            f.write("\n".join(lines) + "\n")
            np.savetxt(f, data, fmt="%.18e", delimiter=" ")

    def write_model_to_binary(self, output_filename, fields_to_write=None,
                              in_cgs=False, r_min=None, r_max=None,
                              overwrite=False):
        """Fortran-unformatted record writer (the RAMSES path)."""
        from scipy.io import FortranFile

        if fields_to_write is None:
            fields_to_write = list(self.fields.keys())
        if os.path.exists(output_filename) and not overwrite:
            raise IOError(f"Cannot create {output_filename}. "
                          "It exists and overwrite=False.")
        host = self.to_numpy()
        mask = self._mask(host["radius"], r_min, r_max)
        with FortranFile(output_filename, "w") as f:
            f.write_record(int(mask.sum()))
            prof_rec = []
            for k in fields_to_write:
                fd, _ = self._field_for_output(k, host[k][mask], in_cgs)
                prof_rec.append(np.asarray(fd))
            f.write_record(np.array(prof_rec).T)

    # -------------------------------------------------------------- fields
    def set_field(self, name: str, value, unit: str | None = None):
        """Set a field (size-checked), converting from ``unit`` into the
        field's NATIVE storage unit with a dimension check: a unit of the
        wrong dimension (Kelvin for the keV-native temperature) raises
        instead of mis-scaling."""
        value = _tensor(value, self.device)
        if unit is not None:
            value = units.to_field_units(value, unit, name)
        if value.numel() != self.num_elements:
            raise ValueError(f"The length of the array needs to be "
                             f"{self.num_elements} elements!")
        if name in self.fields:
            mylog.warning("Overwriting field %s.", name)
        self.fields[name] = value

    def set_rmax(self, r_max) -> "ClusterModel":
        """The model truncated at ``r_max``."""
        mask = self.fields["radius"] <= r_max
        fields = OrderedDict((k, v[mask]) for k, v in self.fields.items())
        return ClusterModel(int(mask.sum()), fields, device=self.device)

    def find_field_at_radius(self, field, r):
        """``field`` interpolated linearly at radius ``r``."""
        return interp(_tensor(r, self.device), self["radius"], self[field])

    def mass_in_radius(self, radius):
        """Masses of each component within ``radius`` (0-d tensors); a
        ``radius`` below the first grid point gives zeros."""
        masses = {}
        inside = self.fields["radius"] < radius
        n_in = int(inside.sum())
        for mtype in ["total", "gas", "dark_matter", "stellar"]:
            if f"{mtype}_mass" in self.fields:
                m = self.fields[f"{mtype}_mass"]
                masses[mtype] = m[n_in - 1] if n_in else 0.0 * m[0]
        return masses

    def find_radius_for_density(self, density):
        """Radius where the gas density falls to ``density``; needs a
        monotonically decreasing density profile (noise within 1e-12 of
        the local size is let through) and raises otherwise."""
        r = torch.flip(self.fields["radius"], (0,))
        d = torch.flip(self.fields["density"], (0,))
        if bool(torch.any(torch.diff(d) < -1e-12 * torch.abs(d[:-1]))):
            raise ValueError(
                "find_radius_for_density requires a monotonically "
                "decreasing density profile; this model's gas density "
                "is non-monotone in radius.")
        return float(interp(_tensor(density, self.device),
                            torch.cummax(d, dim=0).values, r))

    # ------------------------------------------------------------- checks
    def check_hse(self):
        """Relative deviation from hydrostatic equilibrium."""
        if "pressure" not in self.fields:
            raise RuntimeError("This ClusterModel contains no gas!")
        rr = self.fields["radius"]
        p_sp = cubic_spline(rr, self.fields["pressure"])
        dPdx = spline_eval(p_sp, rr, nu=1)
        rhog = self.fields["density"] * self.fields["gravitational_field"]
        chk = (dPdx - rhog) / rhog
        mylog.info("The maximum relative deviation of this profile from "
                   "hydrostatic equilibrium is %g", float(chk.abs().max()))
        return chk

    def check_dm_virial(self):
        return self.dm_virial.check_virial()

    def check_star_virial(self):
        return self.star_virial.check_virial()

    def compute_velocity_dispersion(self, ptype: str = "dark_matter",
                                    r_a=None):
        """Jeans radial velocity dispersion, stored as the
        ``velocity_dispersion`` field.

        Isotropic (``r_a=None``):
        sigma_r^2(r) = (1 / rho(r)) int_r^{rmax} rho(r') g(r') dr'
        with g = -dPhi/dr < 0 taken from the model's gravitational field.

        Osipkov-Merritt (``r_a`` in kpc, the analytic companion of
        ``VirialEquilibrium(..., r_a=...)`` draws): the Jeans equation
        with beta(r) = r^2/(r^2 + r_a^2) integrates in closed form to
        sigma_r^2(r) = int_r^{rmax} (1 + r'^2/r_a^2) rho g dr' /
        (rho (1 + r^2/r_a^2)).
        """
        if r_a is not None and not float(r_a) > 0.0:
            raise ValueError(f"r_a must be positive (got {r_a!r}); use "
                             "r_a=None for the isotropic dispersion")
        rr = self.fields["radius"]
        rho = self.fields[f"{ptype}_density" if ptype != "gas"
                          else "density"]
        g = self.fields["gravitational_field"]
        aug_fn = ((lambda r: 1.0) if r_a is None
                  else (lambda r: 1.0 + (r / float(r_a)) ** 2))
        rho_sp = cubic_spline(rr, rho)
        g_sp = cubic_spline(rr, g)
        num = integrate_from(
            lambda r: (aug_fn(r) * spline_eval(rho_sp, r)
                       * (-spline_eval(g_sp, r))), rr)
        sigma2 = num / torch.clamp_min(rho * aug_fn(rr), 1e-300)
        sigma = torch.sqrt(torch.clamp_min(sigma2, 0.0))
        # the outermost point has an empty integral; extend smoothly
        sigma[-1] = sigma[-2]
        self.set_field("velocity_dispersion", sigma)
        return self.fields["velocity_dispersion"]

    # ---------------------------------------------------- magnetic fields
    def set_magnetic_field_from_beta(self, beta, gaussian=True):
        """B = sqrt(8 pi P / beta) (Gaussian) or sqrt(2 P / beta)
        (Lorentz-Heaviside), stored in gauss."""
        # galactic pressure -> cgs (erg/cm^3 = gauss^2 / 8 pi)
        p_cgs = (self.fields["pressure"]
                 * units.galactic_to_cgs_factor("pressure"))
        B = torch.sqrt(2.0 * p_cgs / beta)
        if gaussian:
            B = B * math.sqrt(4.0 * math.pi)
        self.set_field("magnetic_field_strength", B)
        # consumers computing p_B = B^2/(8 pi) vs B^2/2 need the convention
        self.magnetic_gaussian = gaussian

    def set_magnetic_field_from_density(self, B0, eta=2.0 / 3.0,
                                        gaussian=True):
        """B = B0 (rho/rho_0)^eta, with B0 in gauss."""
        B = B0 * (self.fields["density"] / self.fields["density"][0]) ** eta
        if not gaussian:
            B = B / math.sqrt(4.0 * math.pi)
        self.set_field("magnetic_field_strength", B)
        self.magnetic_gaussian = gaussian

    # ------------------------------------------------------------ sampling
    def generate_tracer_particles(self, num_particles, r_max=None,
                                  sub_sample=1, prng=None, uniforms=None):
        """Tracer particles following the gas distribution."""
        from ..sampling import generate_tracer_particles

        return generate_tracer_particles(self, num_particles, r_max=r_max,
                                         sub_sample=sub_sample, prng=prng,
                                         uniforms=uniforms)

    def generate_gas_particles(self, num_particles, r_max=None, sub_sample=1,
                               compute_potential=False, prng=None,
                               uniforms=None):
        """Gas particles in hydrostatic equilibrium."""
        from ..sampling import generate_gas_particles

        return generate_gas_particles(self, num_particles, r_max=r_max,
                                      sub_sample=sub_sample,
                                      compute_potential=compute_potential,
                                      prng=prng, uniforms=uniforms)

    def generate_dm_particles(self, num_particles, r_max=None, sub_sample=1,
                              compute_potential=False, prng=None,
                              uniforms=None):
        """Virialized dark-matter particles."""
        return self.dm_virial.generate_particles(
            num_particles, r_max=r_max, sub_sample=sub_sample,
            compute_potential=compute_potential, prng=prng,
            uniforms=uniforms)

    def generate_star_particles(self, num_particles, r_max=None, sub_sample=1,
                                compute_potential=False, prng=None,
                                uniforms=None):
        """Virialized star particles."""
        return self.star_virial.generate_particles(
            num_particles, r_max=r_max, sub_sample=sub_sample,
            compute_potential=compute_potential, prng=prng,
            uniforms=uniforms)

    # ------------------------------------------------------------ plotting
    def plot(self, field, r_min=None, r_max=None, fig=None, ax=None,
             **kwargs):
        """Log-log plot of ``field`` against the radius (both brought to
        host numpy), the axis labelled from ``utils.field_label_map``.
        ``kwargs`` go to ``ax.loglog``.  Returns ``(fig, ax)``."""
        import matplotlib.pyplot as plt

        from ..utils import field_label_map

        if fig is None:
            fig = plt.figure(figsize=(10, 10))
        if ax is None:
            ax = fig.add_subplot(111)
        ax.loglog(self["radius"].detach().cpu().numpy(),
                  self[field].detach().cpu().numpy(), **kwargs)
        ax.set_xlim(r_min, r_max)
        ax.set_xlabel("Radius (kpc)")
        ax.set_ylabel(field_label_map.get(field, ""))
        return fig, ax

    # ------------------------------------------------------------- dataset
    def create_dataset(self, filename, domain_dimensions=(512, 512, 512),
                       left_edge=None, box_size=None, overwrite=False,
                       chunksize=64, dtype="f8", engine="device"):
        """Paint this model onto a chunked uniform grid that yt reads
        (:class:`~..data_structures.YTHDF5`), centred on the origin, at
        rest, on the model's device (``engine="device"``) or on the host
        by the C++ painter (``engine="native"``).  The default box spans
        [-r_max, r_max] on each axis; ``dtype="f4"`` halves the bytes on
        disk.  Returns the filename."""
        from ..data_structures import YTHDF5, _check_engine

        _check_engine(engine)
        rmax = float(self["radius"].max())
        if left_edge is None:
            left_edge = 3 * [-rmax]
        if box_size is None:
            box_size = 3 * [2.0 * rmax]
        left_edge = np.asarray(left_edge, dtype=np.float64)
        box_size = np.broadcast_to(np.asarray(box_size, dtype=np.float64),
                                   (3,))
        bbox = np.array([[le, le + bs] for le, bs in zip(left_edge, box_size)],
                        dtype="float64")
        ds_obj = YTHDF5.build(filename, domain_dimensions, bbox,
                              chunksize=chunksize, overwrite=overwrite,
                              dtype=dtype)
        ds_obj.add_model(self, [0, 0, 0], [0, 0, 0], engine=engine)
        return ds_obj.filename


class HydrostaticEquilibrium(ClusterModel):
    """Backwards-compatible alias."""
