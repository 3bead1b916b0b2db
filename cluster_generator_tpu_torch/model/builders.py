"""Hydrostatic-equilibrium field builders.

Each builder maps (profiles, radius grid) to a dict of float64 field
tensors in galactic units.  Grids have shape ``(..., n)`` with one leading
entry per halo; profile parameters carry the same leading shape.

The three builders are captured programs (:func:`..core.compiled.function`),
as the JAX package jits them with ``order`` and ``gravity`` static: the
profiles' parameters and ``gravity_params`` are inputs, the profiles'
structure and the configuration's gravity constants
(:func:`..core.compiled.config_key`) are the key.
"""

from __future__ import annotations

import math

import torch

from ..core import compiled
from ..core import constants as C
from ..core import units
from ..core.interp import cubic_spline, spline_eval
from ..core.quadrature import (cumtrapz, integrate_from, integrate_mass,
                               integrate_tail_to_inf)
from .gravity import dynamical_mass, field_for_law

__all__ = ["build_from_dens_and_tden", "build_from_dens_and_temp",
           "build_no_gas", "derive_secondary_fields",
           "potential_from_field"]


def potential_from_field(rr, g):
    """Phi(r) = Phi(rmax) + int_r^rmax g dr, anchored at
    Phi(rmax) = g(rmax) rmax (the field continued as 1/r^2 outside).  For
    the MOND laws the true field falls as ~1/r outside and the potential
    has no finite zero at infinity; this anchor keeps psi = -Phi finite and
    shifts it uniformly, which is what the DF machinery uses."""
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


def _field_and_potential(rr, m_tot, gravity, gravity_params):
    """``(g, phi)`` of the matter mass ``m_tot`` under the named law;
    ``phi`` is None under Newton (the mass-integral form serves there).
    EMOND's A0 depends on the potential, which depends on the field: a
    fixed point of 4 unrolled steps from the Newtonian field (A0 is a
    bounded tanh of log|phi|, so the map is a strong contraction)."""
    if gravity == "newtonian":
        return -C.G * m_tot / rr**2, None
    if gravity == "emond":
        g = -C.G * m_tot / rr**2
        for _ in range(4):
            phi = potential_from_field(rr, g)
            g = field_for_law(rr, m_tot, gravity, phi=phi,
                              params=gravity_params)
    else:
        g = field_for_law(rr, m_tot, gravity, params=gravity_params)
    return g, potential_from_field(rr, g)


@compiled.function(static=("order", "gravity"))
def build_from_dens_and_tden(rr, density, total_density, stellar_density=None,
                             order: int = 16, gravity: str = "newtonian",
                             gravity_params=None) -> dict:
    """Fields from a gas density and a total density profile.

    P(r) = - int_r^{rmax} rho_g g dr - int_{rmax}^inf rho_g g(rmax)(rmax/r)^2 dr
    with g = -G M_tot / r^2 under Newton; for a registered MOND law
    (``gravity="aqual" | "qumond" | "emond"``) the matter mass from
    ``total_density`` maps to the field by the law's forward relation.
    """
    fields: dict = {}
    fields["radius"] = rr
    fields["density"] = density(rr)
    fields["total_density"] = total_density(rr)
    fields["total_mass"] = integrate_mass(total_density, rr, order=order)
    fields["gas_mass"] = integrate_mass(density, rr, order=order)
    g, phi = _field_and_potential(rr, fields["total_mass"], gravity,
                                  gravity_params)
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
    # T[keV] = P mu m_p / rho, with the constant folded on the host as in
    # the JAX package, so that both round the same way
    fields["temperature"] = P / fields["density"] * (C.mu * C.mp / C.keV)
    return derive_secondary_fields(fields, stellar_density,
                                   total_density_fn=total_density,
                                   potential=phi)


@compiled.function(static=("order", "gravity"))
def build_from_dens_and_temp(rr, density, temperature, stellar_density=None,
                             order: int = 16, gravity: str = "newtonian",
                             gravity_params=None) -> dict:
    """Fields from a gas density and a temperature profile.

    P = rho T / (mu m_p); g = (dP/dr)/rho; then the dynamical (matter)
    mass per the gravity law (:func:`~.gravity.dynamical_mass`);
    rho_tot = (dM/dr) / (4 pi r^2).  Here g comes straight from
    hydrostatic equilibrium, so EMOND's phi is computed directly from the
    field, with no fixed point.
    """
    fields: dict = {}
    fields["radius"] = rr
    fields["density"] = density(rr)
    fields["temperature"] = temperature(rr)
    # T[keV] -> galactic energy, the constant folded on the host
    fields["pressure"] = (fields["density"] * fields["temperature"]
                          * (C.keV / (C.mu * C.mp)))
    p_sp = cubic_spline(rr, fields["pressure"])
    dPdr = spline_eval(p_sp, rr, nu=1)
    g = dPdr / fields["density"]
    fields["gravitational_field"] = g
    fields["gas_mass"] = integrate_mass(density, rr, order=order)
    phi = None
    if gravity != "newtonian":
        phi = potential_from_field(rr, g)
    fields["total_mass"] = dynamical_mass(rr, g, gravity, phi=phi,
                                          params=gravity_params)
    m_sp = cubic_spline(rr, fields["total_mass"])
    dMdr = spline_eval(m_sp, rr, nu=1)
    fields["total_density"] = dMdr / (4.0 * math.pi * rr**2)
    return derive_secondary_fields(fields, stellar_density, potential=phi)


@compiled.function(static=("order", "gravity"))
def build_no_gas(rr, total_density, stellar_density=None, order: int = 16,
                 gravity: str = "newtonian", gravity_params=None) -> dict:
    """Fields of a model without gas, with the same gravity-law wiring as
    :func:`build_from_dens_and_tden`."""
    fields: dict = {}
    fields["radius"] = rr
    fields["total_density"] = total_density(rr)
    fields["total_mass"] = integrate_mass(total_density, rr, order=order)
    g, phi = _field_and_potential(rr, fields["total_mass"], gravity,
                                  gravity_params)
    fields["gravitational_field"] = g
    return derive_secondary_fields(fields, stellar_density,
                                   total_density_fn=total_density,
                                   potential=phi)
