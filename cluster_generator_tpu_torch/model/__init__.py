"""Equilibrium-model layer."""

from .builders import (
    build_from_dens_and_tden,
    build_from_dens_and_temp,
    build_no_gas,
    derive_secondary_fields,
)
from .cluster_model import ClusterModel, HydrostaticEquilibrium

__all__ = ["ClusterModel", "HydrostaticEquilibrium",
           "build_from_dens_and_tden", "build_from_dens_and_temp",
           "build_no_gas", "derive_secondary_fields"]
