"""Flat-LCDM critical density (yt's default cosmology, h = 0.71)."""

from __future__ import annotations

import math
from dataclasses import dataclass

from .constants import G, KPC_M, MYR_S

__all__ = ["Cosmology", "default_cosmology"]


@dataclass(frozen=True)
class Cosmology:
    hubble_constant: float = 0.71  # in 100 km/s/Mpc
    omega_matter: float = 0.27
    omega_lambda: float = 0.73
    omega_radiation: float = 0.0
    omega_curvature: float = 0.0

    def hubble_parameter(self, z: float) -> float:
        """H(z) in 1/Myr."""
        H0 = self.hubble_constant * 100.0 * 1.0e3 / (1.0e3 * KPC_M) * MYR_S
        zp1 = 1.0 + z
        E2 = (self.omega_radiation * zp1**4 + self.omega_matter * zp1**3
              + self.omega_curvature * zp1**2 + self.omega_lambda)
        return H0 * math.sqrt(E2)

    def critical_density(self, z: float = 0.0) -> float:
        """rho_crit(z) in Msun/kpc^3."""
        H = self.hubble_parameter(z)
        return 3.0 * H * H / (8.0 * math.pi * G)


def default_cosmology() -> Cosmology:
    return Cosmology()
