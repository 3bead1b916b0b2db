"""cluster_generator_tpu_torch — the PyTorch/CUDA port of cluster_generator_tpu.

The same galaxy-cluster initial-conditions engine on one NVIDIA H100:
equilibrium models, Eddington DFs, inverse-CDF tables and particle draws.
Six paths: the class API of a single cluster (:class:`ClusterModel`,
:class:`VirialEquilibrium`, :class:`ClusterParticles`, with the profile
library, every constructor and the MOND gravity laws), the multi-cluster
IC scene (:class:`ClusterICs`: pro-rating, per-halo draws, gas mixing and
resampling) with its exporters (:mod:`.codes`: Gadget/AREPO, GAMER, FLASH,
RAMSES), the fused merger IC
(:mod:`.pipeline`), the ensemble datagen batch program
(:mod:`.parallel.ensemble`) and the merger-scene batch program
(:mod:`.parallel.mergers`), the last three as plain functions on tensors
with a leading halo axis, and the 3D random fields (:mod:`.fields`,
``torch.fft``).  Two file products stream from the card: the datagen
catalogs of both batch programs (write, resume, shards, read, batch,
verify, to particles; :mod:`.parallel`) and the chunked grid that yt reads
(:mod:`.data_structures`), each batch copied to pinned host memory while
the next one computes (:mod:`.core.staging`), or painted on the host by the
C++ painter of ``native/cg_native.cpp`` (:mod:`.ops.native`); yt reads the
grid through :mod:`.frontend`.  ``python -m cluster_generator_tpu_torch``
(:mod:`.cli`) drives it all from the shell; :mod:`.core.profiling` and
:mod:`.core.debug` time, trace and check it.  Float64 for the equilibrium solve, float32 for
tables and fused draws.  The TPU kernel of the JAX package is a
hand-written CUDA kernel here (``ops/csrc``), compiled by ``nvcc`` at
first use.  Entry points run on the card unless called with
``device="cpu"``.  This package imports neither JAX nor
``cluster_generator_tpu``; ``h5py``, PyYAML and matplotlib are imported
only inside the functions that need them, ``yt`` only by :mod:`.frontend`.
"""

from __future__ import annotations

from .codes import (resample_arepo_ics, setup_arepo_ics, setup_flash_ics,
                    setup_gamer_ics, setup_ramses_ics)
from .core.config import cgparams
from .core.constants import G, kboltz, mp, mu, mue
from .core.cosmology import Cosmology, default_cosmology
from .core.grid import log_radius_grid
from .core.logging import mylog
from .fields import (ClusterField, GaussianRandomField,
                     RadialRandomMagneticField,
                     RadialRandomMagneticVectorPotential,
                     RadialRandomVelocityField, RandomMagneticField,
                     RandomMagneticVectorPotential, RandomVelocityField)
from .ics import ClusterICs, compute_centers_for_binary
from .model import ClusterModel, HydrostaticEquilibrium
from .parallel.ensemble import (build_ensemble, datagen_batches,
                                prorate_species_counts,
                                sample_ensemble_params)
from .parallel.mergers import (binary_scene_geometry, merger_scene_batches,
                               sample_merger_scene_params,
                               sample_triple_scene_params,
                               triple_scene_geometry)
from .particles import ClusterParticles
from .pipeline import (attach_field_to_particles, binary_merger_ic,
                       build_merger_models,
                       build_radius_tables, build_speed_tables,
                       merger_ic_fused, sample_merger_ic)
from .profiles import *  # noqa: F401,F403
from .profiles import __all__ as _profile_names
from .profiles import relations
from .profiles.relations import (convert_ne_to_density, f_gas, m_bcg, m_sat,
                                 r_bcg)
from .virial import VirialEquilibrium

__all__ = ["attach_field_to_particles", "binary_merger_ic",
           "binary_scene_geometry", "merger_scene_batches",
           "sample_merger_scene_params", "sample_triple_scene_params",
           "triple_scene_geometry", "ClusterField", "GaussianRandomField",
           "RadialRandomMagneticField", "RadialRandomMagneticVectorPotential",
           "RadialRandomVelocityField", "RandomMagneticField",
           "RandomMagneticVectorPotential", "RandomVelocityField",
           "build_ensemble", "build_merger_models",
           "build_radius_tables", "build_speed_tables", "datagen_batches",
           "merger_ic_fused", "prorate_species_counts",
           "sample_ensemble_params", "sample_merger_ic",
           "ClusterModel", "HydrostaticEquilibrium", "VirialEquilibrium",
           "ClusterParticles", "ClusterICs", "compute_centers_for_binary",
           "resample_arepo_ics", "setup_arepo_ics", "setup_flash_ics",
           "setup_gamer_ics", "setup_ramses_ics", "Cosmology", "default_cosmology", "G",
           "kboltz", "mp", "mu", "mue", "cgparams", "log_radius_grid",
           "mylog", "relations", "convert_ne_to_density", "f_gas", "m_bcg",
           "m_sat", "r_bcg", *_profile_names]

__version__ = "0.1.0"
