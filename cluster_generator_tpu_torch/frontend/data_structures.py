"""yt Dataset, Hierarchy and Grid classes for the chunked-grid files.

Every chunk of the on-disk layout (one ``(chunksize,)^3`` block per row of
the per-field datasets) is one yt grid patch at a single refinement level;
its edges are the chunkmap's cell indices times the cell width.
"""

from __future__ import annotations

import os
import pathlib as pt
import weakref

import numpy as np
from yt.data_objects.index_subobjects.grid_patch import AMRGridPatch
from yt.data_objects.static_output import Dataset
from yt.geometry.grid_geometry_handler import GridIndex
from yt.utilities.file_handler import HDF5FileHandler

from .fields import ClusterGeneratorFieldInfo

_FLUID = "cluster_generator"


class ClusterGeneratorGrid(AMRGridPatch):
    _id_offset = 0

    def __init__(self, id, index, level):
        super().__init__(id, filename=index.index_filename, index=index)
        self.Parent = None
        self.Children = []
        self.Level = level


class ClusterGeneratorHierarchy(GridIndex):
    grid = ClusterGeneratorGrid

    def __init__(self, ds, dataset_type=_FLUID):
        self.dataset_type = dataset_type
        self.dataset = weakref.proxy(ds)
        self._handle = ds._handle
        self.index_filename = self.dataset.parameter_filename
        self.directory = os.path.dirname(self.index_filename)
        self.float_type = np.float64
        super().__init__(ds, dataset_type)

    def _detect_output_fields(self):
        self.field_list = [
            (_FLUID, name) for name in self._handle["grid"].keys()
        ]

    def _count_grids(self):
        self.num_grids = self.dataset.parameters["NGRID"]

    def _chunk_edges(self):
        """Physical (left, right) edges of every chunk: chunkmap cell
        indices scaled by the cell width."""
        ds = self.dataset
        dx = ((ds.domain_right_edge - ds.domain_left_edge)
              / ds.parameters["domain_dimensions"])
        cm = self._handle["chunks"]["chunkmap"][:]
        return (cm[:, 0, :].T * dx + ds.domain_left_edge,
                cm[:, 1, :].T * dx + ds.domain_left_edge)

    def _parse_index(self):
        n = self.num_grids
        cs = self.dataset.parameters["chunksize"]
        self.grid_dimensions = np.full((n, 3), cs, dtype="int32")
        self.grid_left_edge, self.grid_right_edge = self._chunk_edges()
        self.grid_particle_count = np.zeros((n, 1), dtype="int32")
        self.grid_levels = np.zeros((n, 1), dtype="int32")
        self.max_level = 0
        self.grids = np.array(
            [self.grid(i, self, 0) for i in range(n)], dtype="object")

    def _populate_grid_objects(self):
        for g in self.grids:
            g._prepare_grid()
            g._setup_dx()


class ClusterGeneratorDataset(Dataset):
    _index_class = ClusterGeneratorHierarchy
    _field_info_class = ClusterGeneratorFieldInfo
    _load_requirements = ["h5py"]
    _handle = None

    def __init__(self, filename, dataset_type=_FLUID, storage_filename=None,
                 units_override=None, unit_system="cgs",
                 default_species_fields=None):
        self._handle = HDF5FileHandler(filename)
        self.fluid_types += (_FLUID,)
        super().__init__(filename, dataset_type,
                         units_override=units_override,
                         unit_system=unit_system,
                         default_species_fields=default_species_fields)
        self.storage_filename = storage_filename

    def _set_code_unit_attributes(self):
        # galactic code units throughout (kpc / Msun / Myr / gauss)
        self.length_unit = self.quan(1.0, "kpc")
        self.mass_unit = self.quan(1.0, "Msun")
        self.time_unit = self.quan(1.0, "Myr")
        self.velocity_unit = self.quan(1.0, "kpc/Myr")
        self.magnetic_unit = self.quan(1.0, "gauss")

    def _parse_parameter_file(self):
        self.parameters = {}
        for key in self._handle.attrs.keys():
            self.parameters[key] = self._handle.attrs[key]
        self.domain_left_edge = self.parameters["bbox"][:, 0]
        self.domain_right_edge = self.parameters["bbox"][:, 1]
        self.dimensionality = 3
        self.domain_dimensions = self.parameters["domain_dimensions"]
        self.current_time = 0
        self.cosmological_simulation = 0
        self.current_redshift = 0
        self.omega_lambda = 0
        self.omega_matter = 0
        self.hubble_constant = 0
        self._periodicity = (True, True, True)
        self.mu = self.parameters.get("mu", 1.2)
        self.parameters["NGRID"] = self._handle["chunks"]["chunkmap"].shape[-1]

    @classmethod
    def _is_valid(cls, filename: str, *args, **kwargs) -> bool:
        import h5py

        required = ["domain_dimensions", "bbox", "chunksize", "model_count"]
        if pt.Path(filename).suffix not in [".h5", ".hdf5"]:
            return False
        try:
            with h5py.File(filename, "r") as f:
                attrs = list(f.attrs.keys())
                return all(a in attrs for a in required)
        except OSError:  # not an HDF5 file
            return False

    def close(self):
        self._handle.close()
