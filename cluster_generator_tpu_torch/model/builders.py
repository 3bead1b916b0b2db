"""Hydrostatic-equilibrium field builders.

Each builder maps (profiles, radius grid) to a dict of float64 field
tensors in galactic units.  Grids have shape ``(..., n)`` with one leading
entry per halo; profile parameters carry the same leading shape.
"""

from __future__ import annotations

import math

import torch

from ..core import constants as C
from ..core import units
from ..core.interp import cubic_spline, spline_eval
from ..core.quadrature import (cumtrapz, integrate_from, integrate_mass,
                               integrate_tail_to_inf)
from .gravity import field_for_law

__all__ = ["build_from_dens_and_tden", "derive_secondary_fields",
           "potential_from_field"]


def potential_from_field(rr, g):
    """Phi(r) = Phi(rmax) + int_r^rmax g dr, anchored at
    Phi(rmax) = g(rmax) rmax (the field continued as 1/r^2 outside)."""
    g_sp = cubic_spline(rr, g)
    return g[..., -1:] * rr[..., -1:] + integrate_from(
        lambda r: spline_eval(g_sp, r), rr)


def derive_secondary_fields(fields: dict, stellar_density=None,
                            total_density_fn=None, potential=None) -> dict:
    """Potential, gas mass, stellar and dark-matter fields (with the
    negative-DM clamp), gas fraction, electron density and entropy."""
    rr = fields["radius"]

    if potential is not None:
        fields["gravitational_potential"] = potential
    else:
        # Phi = -G [ M(<r)/r + 4 pi int_r^rmax rho_tot(r') r' dr' ]
        if total_density_fn is None:
            tdens_sp = cubic_spline(rr, fields["total_density"])

            def total_density_fn(r):
                return spline_eval(tdens_sp, r)
        gpot2 = 4.0 * math.pi * integrate_from(
            lambda r: total_density_fn(r) * r, rr)
        gpot1 = fields["total_mass"] / rr
        fields["gravitational_potential"] = -C.G * (gpot1 + gpot2)

    if "density" in fields and "gas_mass" not in fields:
        m0 = fields["density"][..., :1] * rr[..., :1] ** 3 / 3.0
        fields["gas_mass"] = (4.0 * math.pi
                              * cumtrapz(fields["density"] * rr * rr, rr)
                              + m0)

    if stellar_density is not None:
        fields["stellar_density"] = stellar_density(rr)
        fields["stellar_mass"] = integrate_mass(stellar_density, rr)

    mdm = fields["total_mass"]
    ddm = fields["total_density"]
    if "density" in fields:
        mdm = mdm - fields["gas_mass"]
        ddm = ddm - fields["density"]
    if "stellar_mass" in fields:
        mdm = mdm - fields["stellar_mass"]
        ddm = ddm - fields["stellar_density"]
    # negative-DM clamp: the mass takes its largest value where rho < 0
    neg = ddm < 0.0
    mdm = torch.where(neg, torch.amax(mdm, dim=-1, keepdim=True), mdm)
    ddm = torch.where(neg, torch.zeros_like(ddm), ddm)
    fields["dark_matter_density"] = ddm
    fields["dark_matter_mass"] = mdm

    if "density" in fields:
        fields["gas_fraction"] = fields["gas_mass"] / fields["total_mass"]
        fields["electron_number_density"] = units.density_to_ne(
            fields["density"])
        # entropy S = T[keV] * n_e^(-2/3)
        fields["entropy"] = (fields["temperature"]
                             * fields["electron_number_density"]
                             ** (-2.0 / 3.0))
    return fields


def build_from_dens_and_tden(rr, density, total_density, stellar_density=None,
                             order: int = 16,
                             gravity: str = "newtonian") -> dict:
    """Fields from a gas density and a total density profile.

    P(r) = - int_r^{rmax} rho_g g dr - int_{rmax}^inf rho_g g(rmax)(rmax/r)^2 dr
    with g = -G M_tot / r^2.
    """
    fields: dict = {}
    fields["radius"] = rr
    fields["density"] = density(rr)
    fields["total_density"] = total_density(rr)
    fields["total_mass"] = integrate_mass(total_density, rr, order=order)
    fields["gas_mass"] = integrate_mass(density, rr, order=order)
    phi = None
    if gravity == "newtonian":
        g = -C.G * fields["total_mass"] / rr**2
    else:
        g = field_for_law(rr, fields["total_mass"], gravity)
        phi = potential_from_field(rr, g)
    fields["gravitational_field"] = g

    g_sp = cubic_spline(rr, g)
    P = -integrate_from(lambda r: density(r) * spline_eval(g_sp, r), rr,
                        order=order)
    # outer tail: field continued as 1/r^2 beyond rmax
    g_out = g[..., -1:]
    r_out = rr[..., -1:]
    tail = integrate_tail_to_inf(
        lambda r: density(r) * g_out * (r_out / r) ** 2, rr[..., -1])
    P = P - tail[..., None]
    fields["pressure"] = P
    # T[keV] = P mu m_p / rho, with the constant folded on the host
    fields["temperature"] = P / fields["density"] * (C.mu * C.mp / C.keV)
    return derive_secondary_fields(fields, stellar_density,
                                   total_density_fn=total_density,
                                   potential=phi)
