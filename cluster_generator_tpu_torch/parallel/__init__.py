"""Ensembles of clusters and merger scenes (the batch programs and their
HDF5 catalogs) and the multi-device layer: meshes over a
``torch.distributed`` world, the pencil FFT, sharded fields, sharded export
and the dry run."""

from .mesh import make_mesh
from .ensemble import (build_ensemble, catalog_batches, catalog_to_particles,
                       datagen_batches, ensemble_datagen,
                       ensemble_datagen_multihost, prorate_species_counts,
                       read_catalog, sample_ensemble_params, verify_catalog)
from .mergers import (binary_scene_geometry, halo_mass_weights,
                      merger_datagen, merger_datagen_multihost,
                      merger_scene_batches, read_merger_catalog,
                      sample_merger_scene_params, sample_triple_scene_params,
                      scene_to_particles, triple_scene_geometry,
                      verify_merger_catalog, verify_scene_batch)

__all__ = ["make_mesh", "build_ensemble", "catalog_batches",
           "catalog_to_particles", "datagen_batches", "ensemble_datagen",
           "ensemble_datagen_multihost", "prorate_species_counts",
           "read_catalog", "sample_ensemble_params", "verify_catalog",
           "binary_scene_geometry", "halo_mass_weights", "merger_datagen",
           "merger_datagen_multihost", "merger_scene_batches",
           "read_merger_catalog", "sample_merger_scene_params",
           "sample_triple_scene_params", "scene_to_particles",
           "triple_scene_geometry", "verify_merger_catalog",
           "verify_scene_batch"]
