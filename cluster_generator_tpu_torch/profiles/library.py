"""The radial profiles the canonical merger cluster is built from."""

from __future__ import annotations

import math

from .algebra import Profile

__all__ = ["snfw_density_profile", "snfw_mass_profile", "snfw_total_mass",
           "vikhlinin_density_profile"]


def _snfw_density_profile_fn(p, r):
    M, a = p
    x = r / a
    return 3.0 * M / (16.0 * math.pi * a**3) / (x * (1.0 + x) ** 2.5)


def snfw_density_profile(M, a):
    """Super-NFW density (Lilley+18)."""
    return Profile(_snfw_density_profile_fn, (M, a))


def _snfw_mass_profile_fn(p, r):
    M, a = p
    x = r / a
    return M * (1.0 - (2.0 + 3.0 * x) / (2.0 * (1.0 + x) ** 1.5))


def snfw_mass_profile(M, a):
    """Super-NFW enclosed mass."""
    return Profile(_snfw_mass_profile_fn, (M, a))


def snfw_total_mass(mass, radius, a):
    """Total-mass parameter from a reference (mass, radius)."""
    x = radius / a
    frac = 1.0 - (2.0 + 3.0 * x) / (2.0 * (1.0 + x) ** 1.5)
    return mass / frac


def _vikhlinin_density_profile_fn(p, r):
    rho_0, r_c, r_s, alpha, beta, epsilon, gamma = p
    return (rho_0 * (r / r_c) ** (-0.5 * alpha)
            * (1.0 + (r / r_c) ** 2) ** (-1.5 * beta + 0.25 * alpha)
            * (1.0 + (r / r_s) ** gamma) ** (-0.5 * epsilon / gamma))


def vikhlinin_density_profile(rho_0, r_c, r_s, alpha, beta, epsilon,
                              gamma=None):
    """Vikhlinin+06 modified beta-model density."""
    if gamma is None:
        gamma = 3.0
    return Profile(_vikhlinin_density_profile_fn,
                   (rho_0, r_c, r_s, alpha, beta, epsilon, gamma))
