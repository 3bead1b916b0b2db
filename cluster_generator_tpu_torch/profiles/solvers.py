"""Profile solvers: enclosed mass and overdensity radii (batched bisection)."""

from __future__ import annotations

import math

import torch

from ..core.cosmology import Cosmology, default_cosmology
from ..core.quadrature import gauss_legendre
from .algebra import Profile

__all__ = ["mass_within", "find_overdensity_radius", "find_radius_mass"]

_BISECT_ITERS = 100
_BRACKET = (0.01, 10000.0)


def mass_within(profile: Profile, radius, order: int = 64):
    """4 pi int_0^R rho(r) r^2 dr with r = R u^2 (resolves integrable
    cusps); ``radius`` has the profile's batch shape."""
    radius = torch.as_tensor(radius, dtype=torch.float64)
    x, w = gauss_legendre(order, radius)
    u = 0.5 * (x + 1.0)
    wu = 0.5 * w
    R = radius[..., None]
    r = R * u * u
    dr = R * 2.0 * u
    return 4.0 * math.pi * torch.sum(profile(r) * r * r * dr * wu, dim=-1)


def find_overdensity_radius(m, delta, z=0.0, cosmo: Cosmology | None = None):
    """Radius enclosing mass ``m`` at overdensity ``delta``."""
    if cosmo is None:
        cosmo = default_cosmology()
    rho_crit = cosmo.critical_density(z)
    return (3.0 * m / (4.0 * math.pi * delta * rho_crit)) ** (1.0 / 3.0)


def find_radius_mass(m_r: Profile, delta, z=0.0,
                     cosmo: Cosmology | None = None, like=None):
    """(r_delta, M(r_delta)) for a mass profile: bisection on
    f(r) = 3 M(r) / (4 pi r^3) - delta rho_crit over [0.01, 10000] kpc
    with a fixed 100 halvings, every halo of the batch at once.

    NaN where the bracket does not straddle a root.  ``like`` gives the
    batch shape and device of the bracket (a tensor parameter of ``m_r``).
    Forward value only: no implicit gradient.
    """
    if cosmo is None:
        cosmo = default_cosmology()
    rho_crit = cosmo.critical_density(z)

    def f(r):
        return 3.0 * m_r(r) / (4.0 * math.pi * r**3) - delta * rho_crit

    shape = () if like is None else like.shape
    device = None if like is None else like.device
    lo = torch.full(shape, _BRACKET[0], dtype=torch.float64, device=device)
    hi = torch.full(shape, _BRACKET[1], dtype=torch.float64, device=device)
    flo = f(lo)
    bracketed = torch.sign(flo) != torch.sign(f(hi))
    for _ in range(_BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        fmid = f(mid)
        go_right = torch.sign(fmid) == torch.sign(flo)
        lo = torch.where(go_right, mid, lo)
        flo = torch.where(go_right, fmid, flo)
        hi = torch.where(go_right, hi, mid)
    r_delta = torch.where(bracketed, 0.5 * (lo + hi),
                          torch.full_like(lo, math.nan))
    return r_delta, m_r(r_delta)
