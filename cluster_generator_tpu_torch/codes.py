"""Simulation-code exporters: GAMER, FLASH, RAMSES and AREPO setups, and
the particle writer they share.

The particle arrays are assembled on the particles' device and copied to
the host once per file; AREPO's background grid is built on the device
(:func:`_arepo_background`).  Each of these eager steps first makes room
on a card for what it reckons it allocates
(:func:`~.core.compiled.room_for`).  HDF5 output needs ``h5py``, imported
inside the writers; the Fortran format needs only scipy.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from .core import compiled
from .core import constants as C
from .core import units
from .core.logging import mylog
from .particles import ClusterParticles

__all__ = ["write_amr_particles", "setup_gamer_ics", "setup_flash_ics",
           "setup_athena_ics", "setup_enzo_ics", "setup_ramses_ics",
           "setup_arepo_ics", "resample_arepo_ics", "setup_gizmo_ics",
           "setup_art_ics"]

_AMR_FIELDS = ["particle_position", "particle_velocity", "particle_mass"]


def _cgs_factor(field):
    if field == "particle_position":
        return C.CM_PER_KPC
    if field == "particle_velocity":
        return C.CM_PER_KPC / C.MYR_S
    if field == "particle_mass":
        return C.MSUN_KG * 1.0e3
    return 1.0


def _amr_field(particles, field, ptypes, in_cgs):
    parts = [particles[ptype, field] for ptype in ptypes]
    # the joined field, and its scaled copy
    compiled.room_for(particles.device, *parts * (1 + bool(in_cgs)))
    fd = torch.cat(parts, dim=0)
    return fd * _cgs_factor(field) if in_cgs else fd


def write_amr_particles(particles, output_filename, ptypes, ptype_num,
                        overwrite=True, in_cgs=False, format="hdf5"):
    """Write the particles of ``ptypes`` for GAMER, FLASH or RAMSES:
    ``format="hdf5"`` gives one dataset per field plus ``particle_type``
    (the ``ptype_num`` of each particle); ``format="fortran"`` one record
    with the count and one (N, 7) float64 record of position, velocity
    and mass per particle."""
    if Path(output_filename).exists() and not overwrite:
        raise IOError(f"Cannot create {output_filename}. "
                      "It exists and overwrite=False.")
    nparts = [particles.num_particles[ptype] for ptype in ptypes]
    if format == "hdf5":
        import h5py

        from .core.h5raw import RawWriter

        with h5py.File(output_filename, "w") as f:
            raw = RawWriter(f)  # pwrite at each dataset's offset
            for field in _AMR_FIELDS:
                raw.add(f, field, _amr_field(particles, field, ptypes,
                                             in_cgs).cpu().numpy())
            fd = np.concatenate([ptype_num[ptype] * np.ones(nparts[i])
                                 for i, ptype in enumerate(ptypes)])
            raw.add(f, "particle_type", fd)
            raw.flush()
    elif format == "fortran":
        from scipy.io import FortranFile

        cols = [_amr_field(particles, field, ptypes, in_cgs)
                for field in _AMR_FIELDS]
        num_particles = int(cols[-1].numel())
        compiled.room_for(particles.device, *cols)
        rec = torch.cat([cols[0], cols[1], cols[2][:, None]],
                        dim=1).cpu().numpy()
        with FortranFile(output_filename, "w") as f:
            f.write_record(num_particles)
            f.write_record(rec)
    else:
        raise ValueError(f"Unknown format {format}")


def setup_gamer_ics(ics, regenerate_particles=False, use_tracers=False):
    """Input__TestProblem lines and per-halo particle and profile files
    for GAMER's ClusterMerger setup, written to the current directory."""
    gamer_ptypes = ["dm", "star"]
    if use_tracers:
        gamer_ptypes.insert(0, "tracer")
    gamer_ptype_num = {"tracer": 0, "dm": 2, "star": 3}
    hses = [ics.load_model(i) for i in range(ics.num_halos)]
    parts = ics._generate_particles(regenerate_particles=regenerate_particles)
    outlines = [f"Merger_Coll_NumHalos\t\t{ics.num_halos}\t# number of halos"]
    for i in range(ics.num_halos):
        particle_file = f"{ics.basename}_gamerp_{i+1}.h5"
        if ics.num_particles["star"][i] == 0:
            ptypes = gamer_ptypes[:-1]
        else:
            ptypes = gamer_ptypes
        write_amr_particles(parts[i], particle_file, ptypes, gamer_ptype_num,
                            in_cgs=True, format="hdf5")
        # the table's name comes from splitting off the suffix, so that
        # no name (such as 'halo.hdf5') maps onto the source profile itself
        root, ext = os.path.splitext(ics.profiles[i])
        hse_file_gamer = f"{root}_gamer{ext}"
        hses[i].write_model_to_h5(hse_file_gamer, overwrite=True, in_cgs=True,
                                  r_max=ics.r_max[i])
        vel = ics.velocity[i] / units.unit_factor("km/s")
        outlines += [
            f"Merger_File_Prof{i+1}\t\t{hse_file_gamer}\t# profile table of cluster {i+1}",
            f"Merger_File_Par{i+1}\t\t{particle_file}\t# particle file of cluster {i+1}",
            f"Merger_Coll_PosX{i+1}\t\t{ics.center[i][0]}\t# X-center of cluster {i+1} in kpc",
            f"Merger_Coll_PosY{i+1}\t\t{ics.center[i][1]}\t# Y-center of cluster {i+1} in kpc",
            f"Merger_Coll_VelX{i+1}\t\t{vel[0]}\t# X-velocity of cluster {i+1} in km/s",
            f"Merger_Coll_VelY{i+1}\t\t{vel[1]}\t# Y-velocity of cluster {i+1} in km/s",
        ]
    mylog.info("Write the following lines to Input__TestProblem: ")
    for line in outlines:
        print(line)
    if ics.mag_file is not None:
        mylog.info(
            "Rename the file '%s' to 'B_IC' and place it in the same "
            "directory as the Input__* files, and set "
            "OPT__INIT_BFIELD_BYFILE to 1 in Input__Parameter", ics.mag_file)
    return outlines


def setup_flash_ics(ics, use_particles=True, regenerate_particles=False):
    """flash.par lines for FLASH's GalaxyClusterMerger setup."""
    if use_particles:
        ics._generate_particles(regenerate_particles=regenerate_particles)
    outlines = [f"testSingleCluster\t=\t{ics.num_halos} # number of halos"]
    for i in range(ics.num_halos):
        vel = ics.velocity[i] / units.unit_factor("km/s")
        outlines += [
            f"profile{i+1}\t=\t{ics.profiles[i]}\t# profile table of cluster {i+1}",
            f"xInit{i+1}\t=\t{ics.center[i][0]}\t# X-center of cluster {i+1} in kpc",
            f"yInit{i+1}\t=\t{ics.center[i][1]}\t# Y-center of cluster {i+1} in kpc",
            f"vxInit{i+1}\t=\t{vel[0]}\t# X-velocity of cluster {i+1} in km/s",
            f"vyInit{i+1}\t=\t{vel[1]}\t# Y-velocity of cluster {i+1} in km/s",
        ]
        if use_particles:
            outlines.append(
                f"Merger_File_Par{i+1}\t=\t{ics.particle_files[i]}\t"
                f"# particle file of cluster {i+1}")
    mylog.info("Add the following lines to flash.par: ")
    for line in outlines:
        print(line)
    return outlines


def setup_athena_ics(ics):
    """Athena setup: a stub, as upstream's."""
    mylog.info("Add the following lines to athinput.cluster3d: ")


def setup_enzo_ics(ics):
    """Enzo setup: a stub, as upstream's."""


def setup_ramses_ics(ics, regenerate_particles=False):
    """RAMSES merger setup in the current directory: Fortran-record
    profiles and dark-matter particles per halo, and Merger_Config.txt."""
    names = ["Main", "Sub", "Third"]
    config_lines = ["# Merger Dynamics Setting, do not change the general format"]
    hses = [ics.load_model(i) for i in range(ics.num_halos)]
    parts = ics._generate_particles(regenerate_particles=regenerate_particles)
    fields_to_write = ["radius", "density", "pressure"]
    for i in range(ics.num_halos):
        if i > 0:
            config_lines.append("#")
        config_lines += [f"# {names[i]}", "#", "#", f"Halo {i+1}"]
        hses[i].write_model_to_binary(
            f"halo{i+1}_prof.dat", overwrite=True, in_cgs=True,
            r_max=float(np.max(ics.r_max)), fields_to_write=fields_to_write)
        vel = ics.velocity[i] / units.unit_factor("km/s")
        pos = ics.center[i]
        config_lines += [
            f"x_cen[kpc]     ={pos[0]:16.6e}",
            f"y_cen[kpc]     ={pos[1]:16.6e}",
            f"z_cen[kpc]     ={pos[2]:16.6e}",
            f"vx_cen[kms]    ={vel[0]:16.6e}",
            f"vy_cen[kms]    ={vel[1]:16.6e}",
            f"vz_cen[kms]    ={vel[2]:16.6e}",
        ]
        write_amr_particles(parts[i], f"halo{i+1}_part.dat", ["dm"],
                            {"dm": 1}, format="fortran", in_cgs=True)
    mylog.info("Simulation setups saved to Merger_Config.txt.")
    np.savetxt("Merger_Config.txt", config_lines, fmt="%s")
    return config_lines


def _arepo_background(centers, r_max, boxsize, nx, gas):
    """AREPO's background gas on the device of ``gas`` (a scene's gas
    fields): the centers of an ``nx``^3 grid of cells over the box that
    lie outside every halo's ``r_max``, at rest, with the density and
    thermal energy of the scene's least dense gas particle and the mass
    of their cell.  A cell is background only outside every halo (the
    AND of the per-halo outside masks): upstream's OR put background gas
    inside each halo of a multi-halo scene."""
    dens, eint = gas["gas", "density"], gas["gas", "thermal_energy"]
    dev = dens.device
    # at most every cell: the cell centres, the squared offsets and their
    # sum, the mask, then the kept centres and velocities, and the mass,
    # density and energy columns
    n3, f64 = nx ** 3, torch.float64
    compiled.room_for(dev, *[(3 * n3, f64)] * 4, *[(n3, f64)] * 3,
                      (n3, torch.bool))
    dx = boxsize / nx
    le = 0.5 * dx
    re = boxsize - 0.5 * dx
    # numpy.linspace's arithmetic: i * step + start, the end point exact
    ax = torch.arange(nx, dtype=torch.float64, device=dev) * (
        (re - le) / (nx - 1)) + le
    ax[-1] = re
    posg = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"),
                       dim=-1).reshape(nx**3, 3)
    outside = torch.ones(nx**3, dtype=torch.bool, device=dev)
    for c, rm in zip(np.asarray(centers, dtype=np.float64), r_max):
        c = torch.as_tensor(c, device=dev)
        outside &= ((posg - c) ** 2).sum(dim=1) > float(rm) ** 2
    pos = posg[outside]
    nleft = pos.shape[0]
    idens = torch.argmin(dens)
    cell_dens = dens[idens].expand(nleft)
    return {("gas", "particle_position"): pos,
            ("gas", "particle_velocity"): torch.zeros_like(pos),
            ("gas", "particle_mass"): cell_dens * dx**3,
            ("gas", "density"): cell_dens.clone(),
            ("gas", "thermal_energy"): eint[idens].expand(nleft).clone()}


def setup_arepo_ics(ics, boxsize, nx, ic_file, overwrite=False,
                    regenerate_particles=False, prng=None):
    """Gadget-HDF5 AREPO ICs: the scene's particles and a uniform
    low-density background grid filling the box outside the halos."""
    cparts = ics.setup_particle_ics(
        regenerate_particles=regenerate_particles, prng=prng)
    fields = _arepo_background(ics.center, ics.r_max, boxsize, nx, cparts)
    mylog.info("Background cell density is %g g/cm**3.",
               float(fields["gas", "density"][0])
               * units.galactic_to_cgs_factor("density"))
    mylog.info("Background cell mass is %g Msun.",
               float(fields["gas", "particle_mass"][0]))
    all_parts = cparts + ClusterParticles.from_fields(fields,
                                                      device=cparts.device)
    all_parts.write_to_gadget_file(ic_file, boxsize, overwrite=overwrite,
                                   code="arepo")
    return all_parts


def resample_arepo_ics(ics, infile, outfile, overwrite=False):
    """The scene's profiles resampled onto a relaxed (MESHRELAX) AREPO
    snapshot, written as a new Gadget file."""
    import h5py

    parts = ClusterParticles.from_gadget_file(infile, device=ics.device)
    new_parts = ics.resample_particle_ics(parts)
    with h5py.File(infile, "r") as f:
        boxsize = f["Header"].attrs["BoxSize"]
    new_parts.write_to_gadget_file(outfile, boxsize, overwrite=overwrite)


def setup_gizmo_ics(ics):
    """GIZMO setup: a stub, as upstream's."""


def setup_art_ics(ics):
    """ART setup: a stub, as upstream's."""
