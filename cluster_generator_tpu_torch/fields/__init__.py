"""3D random fields (magnetic fields, turbulent velocities, vector
potentials) on a uniform grid, with ``torch.fft``."""

from .grf import (
    ClusterField,
    GaussianRandomField,
    RadialRandomMagneticField,
    RadialRandomMagneticVectorPotential,
    RadialRandomVelocityField,
    RandomMagneticField,
    RandomMagneticVectorPotential,
    RandomVelocityField,
    parse_value,
)

__all__ = [
    "ClusterField", "GaussianRandomField", "RadialRandomMagneticField",
    "RadialRandomMagneticVectorPotential", "RadialRandomVelocityField",
    "RandomMagneticField", "RandomMagneticVectorPotential",
    "RandomVelocityField", "parse_value",
]
