"""Flat-LCDM critical density (yt's default cosmology, h = 0.71)."""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .constants import G, KPC_M, MYR_S

__all__ = ["Cosmology", "default_cosmology"]


@dataclass(frozen=True)
class Cosmology:
    hubble_constant: float = 0.71  # in 100 km/s/Mpc
    omega_matter: float = 0.27
    omega_lambda: float = 0.73
    omega_radiation: float = 0.0
    omega_curvature: float = 0.0

    def hubble_parameter(self, z=0.0):
        """H(z) in 1/Myr: a float for a float ``z``, a tensor for a 0-d
        float64 tensor ``z`` (so that a captured program takes ``z`` as an
        input, as the JAX package traces it)."""
        H0 = self.hubble_constant * 100.0 * 1.0e3 / (1.0e3 * KPC_M) * MYR_S
        zp1 = 1.0 + z
        E2 = (self.omega_radiation * zp1**4 + self.omega_matter * zp1**3
              + self.omega_curvature * zp1**2 + self.omega_lambda)
        if isinstance(E2, torch.Tensor):
            return H0 * torch.sqrt(E2)
        return H0 * math.sqrt(E2)

    def critical_density(self, z=0.0):
        """rho_crit(z) in Msun/kpc^3, of the kind of ``z`` (see
        :meth:`hubble_parameter`)."""
        H = self.hubble_parameter(z)
        return 3.0 * H * H / (8.0 * math.pi * G)


def default_cosmology() -> Cosmology:
    return Cosmology()
