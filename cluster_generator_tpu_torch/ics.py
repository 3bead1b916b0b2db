"""Initial-condition scenes: one to three halos with centers and bulk
velocities, on one device.

:class:`ClusterICs` keeps the JAX package's file-level flow (model HDF5
files in, per-halo particle files cached, a YAML scene description), and
takes :class:`ClusterModel` objects in place of model files, which needs
no file at all (``h5py`` is then never imported). Its compute lives in
module functions over :class:`ClusterModel` objects:
:func:`halo_particle_counts` pro-rates the total counts by the halos'
masses, :func:`draw_halo_particles` draws one halo's species on the
models' device, and the combine/resample functions of :mod:`.particles`
mix the gas.

Random numbers: ``prng`` (as :func:`~.sampling.parse_prng` takes it)
becomes one generator on the scene's device.  Each halo that is drawn
takes the next four 62-bit integers from it, in halo order, and seeds one
generator per species with them (dark matter, stars, gas, tracers), so a
species' draws do not depend on how many particles another species took.
"""

from __future__ import annotations

import os
from collections import defaultdict
from numbers import Number

import numpy as np
import torch

from .core.device import resolve_device
from .core.profiling import span
from .model import ClusterModel
from .particles import (
    ClusterParticles,
    _ensure_list,
    combine_three_clusters,
    combine_two_clusters,
    resample_one_cluster,
    resample_three_clusters,
    resample_two_clusters,
)
from .sampling import parse_prng

__all__ = ["ClusterICs", "compute_centers_for_binary", "halo_particle_counts",
           "draw_halo_particles", "halo_generators"]

SPECIES = ("dm", "star", "gas", "tracer")


def compute_centers_for_binary(center, d, b, a=0.0):
    """Centers of a binary merger at separation ``d`` with impact
    parameter ``b`` (and ``a`` along z) about ``center``."""
    d = np.sqrt(d * d - b * b - a * a)
    diff = np.array([d, b, a])
    center = np.asarray(center, dtype=np.float64)
    center1 = center - 0.5 * diff
    center2 = center + 0.5 * diff
    return center1, center2


def _last_inside(model, field, r_max):
    """``field`` at the last grid point below ``r_max``, as a float, from
    the model's host copies (``ClusterModel._host_field``: the arrays of
    its file, or one copy): the counts pick shapes, so the host decides
    them without reading the card."""
    radius = model._host_field("radius")
    return float(model._host_field(field)[radius < float(r_max)][-1])


def halo_particle_counts(models, r_max, num_particles, r_max_tracer=None):
    """Total particle counts pro-rated over halos by mass: each species'
    ``num_particles[key]`` split by the halos' masses of that species
    inside ``r_max[i]`` (tracers: gas inside ``r_max_tracer[i]``), rounded
    to the nearest integer.  Returns ``{key: [count per halo]}`` for
    ``dm``, ``gas``, ``star`` and ``tracer``; a per-halo count may be off
    the split total by the rounding, at most 1/2 per halo."""
    if r_max_tracer is None:
        r_max_tracer = r_max
    masses = defaultdict(list)
    for i, p in enumerate(models):
        masses["dm"].append(_last_inside(p, "dark_matter_mass", r_max[i]))
        masses["gas"].append(_last_inside(p, "gas_mass", r_max[i])
                             if "gas_mass" in p else 0.0)
        masses["star"].append(_last_inside(p, "stellar_mass", r_max[i])
                              if "stellar_mass" in p else 0.0)
        masses["tracer"].append(
            _last_inside(p, "gas_mass", r_max_tracer[i])
            if num_particles.get("tracer", 0) > 0 else 0.0)
    tots = {k: np.sum(v) for k, v in masses.items()}
    counts = defaultdict(list)
    for i in range(len(models)):
        for key in ["dm", "gas", "star", "tracer"]:
            if num_particles.get(key, 0) > 0:
                n = np.rint(num_particles[key] * masses[key][i]
                            / tots[key]).astype("int")
            else:
                n = 0
            counts[key].append(int(n))
    return counts


def halo_generators(base):
    """One ``torch.Generator`` per species, on ``base``'s device, seeded
    by the next four 62-bit integers ``base`` gives (one read from the
    device: the seeds fix every stream of the scene)."""
    seeds = torch.randint(0, 2**62, (len(SPECIES),), generator=base,
                          device=base.device)
    with span("cg.wait.read"):
        seeds = seeds.tolist()
    return {sp: torch.Generator(device=base.device).manual_seed(s)
            for sp, s in zip(SPECIES, seeds)}


def draw_halo_particles(model, counts, r_max, r_max_tracer=None,
                        generators=None):
    """One halo's particles about its own center, on the model's device:
    ``counts[sp]`` dark-matter, star, gas and tracer particles inside
    ``r_max`` (tracers inside ``r_max_tracer``), each species from
    ``generators[sp]`` (a ``prng`` value).  Dark matter is always drawn;
    the other species when their count is positive."""
    if r_max_tracer is None:
        r_max_tracer = r_max
    gens = generators or {}
    p = model.generate_dm_particles(counts["dm"], r_max=r_max,
                                    prng=gens.get("dm"))
    if counts.get("star", 0) > 0:
        p = p + model.generate_star_particles(counts["star"], r_max=r_max,
                                              prng=gens.get("star"))
    if counts.get("gas", 0) > 0:
        p = p + model.generate_gas_particles(counts["gas"], r_max=r_max,
                                             prng=gens.get("gas"))
    if counts.get("tracer", 0) > 0:
        p = p + model.generate_tracer_particles(
            counts["tracer"], r_max=r_max_tracer, prng=gens.get("tracer"))
    return p


class ClusterICs:
    """A scene of one to three halos, each a model HDF5 file or a
    :class:`ClusterModel` with a center and a bulk velocity.  A scene with
    a model in memory writes no per-halo particle file unless
    ``setup_particle_ics`` is given an ``output_directory``, and has no
    scene description to write (:meth:`to_file` raises).  ``device``:
    where models and particles live (the card unless ``"cpu"`` is asked
    for).  On the card its compute runs as
    captured programs (:mod:`.core.compiled`): each species' draw tables
    and draw (:mod:`.sampling`), the gas mixing of the combine and the
    resample (:mod:`.particles`); the counts come from the host copies of
    the fields the model files held, and each halo's generators take one
    read of four seeds from the card (:func:`halo_generators`)."""

    def __init__(self, basename, num_halos, profiles, center, velocity,
                 num_particles=None, mag_file=None, particle_files=None,
                 r_max=20000.0, r_max_tracer=None, device="cuda"):
        self.device = resolve_device(device)
        self.basename = basename
        self.num_halos = num_halos
        self.profiles = _ensure_list(profiles)
        self.center = np.asarray(center, dtype=np.float64).reshape(num_halos, 3)
        self.velocity = np.asarray(velocity, dtype=np.float64).reshape(
            num_halos, 3)
        self.mag_file = mag_file
        if isinstance(r_max, Number):
            r_max = [r_max] * num_halos
        self.r_max = np.array(r_max, dtype=np.float64)
        if r_max_tracer is None:
            r_max_tracer = r_max
        if isinstance(r_max_tracer, Number):
            r_max_tracer = [r_max_tracer] * num_halos
        self.r_max_tracer = np.array(r_max_tracer, dtype=np.float64)
        if num_particles is None:
            self.tot_np = {"dm": 0, "gas": 0, "star": 0, "tracer": 0}
        else:
            self.tot_np = num_particles
        self._models: dict[int, ClusterModel] = {}
        self._determine_num_particles()
        self.particle_files = [None] * 3
        if particle_files is not None:
            given = _ensure_list(particle_files)
            if len(given) > num_halos:
                raise ValueError(
                    f"{len(given)} particle_files for {num_halos} halos")
            for i, pf in enumerate(given):
                self.particle_files[i] = pf

    def load_model(self, i):
        """The i-th profile as a :class:`ClusterModel` on the scene's
        device: a model given as such, or the file read once and kept; the
        returned instance is the one every later call uses, so changing it
        changes the scene."""
        if isinstance(self.profiles[i], ClusterModel):
            return self.profiles[i]
        if i not in self._models:
            self._models[i] = ClusterModel.from_h5_file(self.profiles[i],
                                                        device=self.device)
        return self._models[i]

    def _in_memory(self):
        """Whether a profile of the scene is a model, not a file."""
        return any(isinstance(p, ClusterModel) for p in self.profiles)

    def _determine_num_particles(self):
        """Pro-rate the total particle counts by the halos' masses."""
        self.num_particles = halo_particle_counts(
            [self.load_model(i) for i in range(len(self.profiles))],
            self.r_max, self.tot_np, self.r_max_tracer)

    def _generate_particles(self, output_directory=None,
                            regenerate_particles=False, prng=None):
        """Each halo's particles, drawn and written to
        ``{basename}_{i}_particles.h5`` in ``output_directory`` (a scene
        with a model in memory writes none unless it is given), or read
        back from the particle file it already has."""
        write = output_directory is not None or not self._in_memory()
        if output_directory is None:
            output_directory = ""
        base = parse_prng(prng, self.device)
        parts = []
        for i, pf in enumerate(self.profiles):
            if regenerate_particles or self.particle_files[i] is None:
                p = draw_halo_particles(
                    self.load_model(i),
                    {k: self.num_particles[k][i] for k in SPECIES},
                    self.r_max[i], self.r_max_tracer[i],
                    halo_generators(base))
                parts.append(p)
                if write:
                    outfile = os.path.join(
                        output_directory, f"{self.basename}_{i}_particles.h5")
                    p.write_particles(outfile, overwrite=True)
                    self.particle_files[i] = outfile
            else:
                parts.append(ClusterParticles.from_file(
                    self.particle_files[i], device=self.device))
        return parts

    # ----------------------------------------------------------------- I/O
    def to_file(self, filename, overwrite=False):
        """Write the scene description as YAML: one key per line with a
        comment, sequences inline; any YAML 1.1 loader reads it.  A scene
        with a model in memory has no file to name for it: it raises."""
        if self._in_memory():
            raise ValueError(
                "this scene holds a ClusterModel in memory, not a model "
                "file: write each model with write_model_to_h5 and build "
                "the scene from the files to describe it in YAML")
        if os.path.exists(filename) and not overwrite:
            raise RuntimeError(f"{filename} exists and overwrite=False!")
        import yaml

        out = [("basename", self.basename, "base name for ICs"),
               ("num_halos", self.num_halos, "number of halos")]
        for i in range(self.num_halos):
            out.append((f"profile{i+1}", self.profiles[i],
                        f"profile for cluster {i+1}"))
            out.append((f"center{i+1}", [float(v) for v in self.center[i]],
                        f"center for cluster {i+1}"))
            out.append((f"velocity{i+1}",
                        [float(v) for v in self.velocity[i]],
                        f"velocity for cluster {i+1}"))
            if self.particle_files[i] is not None:
                out.append((f"particle_file{i+1}", self.particle_files[i],
                            f"particle file for cluster {i+1}"))
        for key, name, label in [("dm", "num_dm_particles", "DM"),
                                 ("gas", "num_gas_particles", "gas"),
                                 ("star", "num_star_particles", "star"),
                                 ("tracer", "num_tracer_particles",
                                  "tracer")]:
            if self.tot_np.get(key, 0) > 0:
                out.append((name, int(self.tot_np[key]),
                            f"number of {label} particles"))
        if self.mag_file is not None:
            out.append(("mag_file", self.mag_file, "3D magnetic field file"))
        out.append(("r_max", [float(v) for v in self.r_max],
                    "Maximum radii of particles"))
        if self.tot_np.get("tracer", 0) > 0:
            out.append(("r_max_tracer",
                        [float(v) for v in self.r_max_tracer],
                        "Maximum radii of tracer particles"))
        with open(filename, "w") as f:
            for key, value, comment in out:
                flow = None if isinstance(value, list) else False
                line = yaml.safe_dump({key: value}, sort_keys=False,
                                      default_flow_style=flow,
                                      width=10**9).strip()
                f.write(f"{line}   # {comment}\n")

    @classmethod
    def from_file(cls, filename, device="cuda"):
        """Read a scene description from YAML."""
        import yaml

        with open(filename, "r") as f:
            params = yaml.safe_load(f)
        num_halos = params["num_halos"]
        profiles = [params[f"profile{i}"] for i in range(1, num_halos + 1)]
        center = [np.array(params[f"center{i}"])
                  for i in range(1, num_halos + 1)]
        velocity = [np.array(params[f"velocity{i}"])
                    for i in range(1, num_halos + 1)]
        num_particles = {k: params.get(f"num_{k}_particles", 0)
                         for k in ["gas", "dm", "star", "tracer"]}
        particle_files = [params.get(f"particle_file{i}", None)
                          for i in range(1, num_halos + 1)]
        return cls(params["basename"], num_halos, profiles, center, velocity,
                   num_particles=num_particles,
                   mag_file=params.get("mag_file", None),
                   particle_files=particle_files,
                   r_max=params.get("r_max", 20000.0),
                   r_max_tracer=params.get("r_max_tracer",
                                           params.get("r_max", 20000.0)),
                   device=device)

    # ------------------------------------------------------------ assembly
    def setup_particle_ics(self, output_directory=None,
                           regenerate_particles=False, prng=None):
        """Every halo's particles, moved to its center and velocity, with
        the gas of two or three halos mixed."""
        profiles = [self.load_model(i) for i in range(self.num_halos)]
        parts = self._generate_particles(
            output_directory=output_directory,
            regenerate_particles=regenerate_particles, prng=prng)
        if self.num_halos == 1:
            all_parts = parts[0]
            all_parts.add_offsets(self.center[0], self.velocity[0])
        elif self.num_halos == 2:
            all_parts = combine_two_clusters(
                parts[0], parts[1], profiles[0], profiles[1], self.center[0],
                self.center[1], self.velocity[0], self.velocity[1])
        else:
            all_parts = combine_three_clusters(
                parts[0], parts[1], parts[2], profiles[0], profiles[1],
                profiles[2], self.center[0], self.center[1], self.center[2],
                self.velocity[0], self.velocity[1], self.velocity[2])
        return all_parts

    def resample_particle_ics(self, parts, passive_scalars=None):
        """The halos' profiles resampled onto relaxed particles ``parts``
        (written in place)."""
        profiles = [self.load_model(i) for i in range(self.num_halos)]
        if self.num_halos == 1:
            return resample_one_cluster(parts, profiles[0], self.center[0],
                                        self.velocity[0])
        if self.num_halos == 2:
            return resample_two_clusters(
                parts, profiles[0], profiles[1], self.center[0],
                self.center[1], self.velocity[0], self.velocity[1],
                self.r_max, passive_scalars=passive_scalars)
        return resample_three_clusters(
            parts, profiles[0], profiles[1], profiles[2], self.center[0],
            self.center[1], self.center[2], self.velocity[0],
            self.velocity[1], self.velocity[2], self.r_max,
            passive_scalars=passive_scalars)

    def create_dataset(self, filename, domain_dimensions=(512, 512, 512),
                       left_edge=None, box_size=None, overwrite=False,
                       chunksize=64, engine="device"):
        """Paint every halo of the scene onto one chunked uniform grid
        (:class:`~.data_structures.YTHDF5`), on the scene's device or by
        the host C++ painter (``engine="native"``); the default box spans
        [-max r_max, max r_max] on each axis.  Returns the filename."""
        from .data_structures import YTHDF5, _check_engine

        _check_engine(engine)

        if left_edge is None:
            left_edge = 3 * [-np.amax(self.r_max)]
        if box_size is None:
            box_size = 2 * np.amax(self.r_max)
        bbox = [[le, le + box_size] for le in left_edge]
        ds_obj = YTHDF5.build(filename, domain_dimensions, bbox,
                              chunksize=chunksize, overwrite=overwrite)
        ds_obj.add_ICs(self, engine=engine)
        return ds_obj.filename
