"""Gravity laws: enclosed-mass profile -> gravitational field.

A registry of named laws mapping an enclosed matter mass to a field, with
Newton as the default and the three MOND laws of
``cluster_generator_tpu.model.gravity`` (QUMOND, AQUAL, EMOND) for the
simple interpolation pair.  A law is a callable
``law(rr, m_tot, params) -> g`` (g < 0, kpc/Myr^2) on float64 tensors of
shape ``(..., n)``; the leading axes (one per halo) are carried through.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..core import constants as C
from ..core.config import cgparams

__all__ = ["register_gravity", "get_gravity", "newtonian_field",
           "qumond_field", "aqual_field", "emond_field", "emond_a0",
           "dynamical_mass", "field_for_law"]

_REGISTRY: dict[str, Callable] = {}


def register_gravity(name: str, law: Callable):
    """Register a gravity law under ``name`` (by a call, never from the
    configuration file)."""
    _REGISTRY[name] = law


def get_gravity(name: str) -> Callable:
    """The field function of the named law; an unknown name raises."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"Unknown gravity law {name!r}; registered: "
                       f"{sorted(_REGISTRY)}") from None


def newtonian_field(rr, m_tot, params=None):
    """g = -G M(<r) / r^2."""
    return -C.G * m_tot / (rr * rr)


def _nu_simple(y):
    """QUMOND simple interpolation function nu(y) = 1/2 + sqrt(1/4 + 1/y)."""
    return 0.5 * (torch.sqrt(1.0 + 4.0 / y) + 1.0)


def _a0_galactic(params):
    a0_si = (params or {}).get("a0_m_s2",
                               cgparams["gravity"]["mond"]["a0_m_s2"])
    return a0_si * C.MYR_S**2 / C.KPC_M  # m/s^2 -> kpc/Myr^2


def qumond_field(rr, m_tot, params=None):
    """QUMOND field from the Newtonian one: g = nu(|g_N|/a0) g_N, with a0
    from ``params["a0_m_s2"]`` or the configuration."""
    a0 = _a0_galactic(params)
    g_n = newtonian_field(rr, m_tot)
    y = torch.abs(g_n) / a0
    return _nu_simple(y) * g_n


def _simple_mu_inverse(g_n, a0):
    """Closed-form inversion of the spherical relation mu(x) x = y for
    the simple interpolation function mu(x) = x/(1+x), with
    y = |g_N|/a0 and x = |g|/a0:

        x^2 / (1 + x) = y  =>  x = (y + sqrt(y (y + 4))) / 2.

    Returns the (negative, inward) field -a0 x; x -> sqrt(y) as y -> 0.
    Shared by AQUAL and EMOND (EMOND passes a pointwise A0(phi) tensor as
    ``a0``)."""
    y = torch.abs(g_n) / a0
    x = 0.5 * (y + torch.sqrt(y * (y + 4.0)))
    return -a0 * x


def aqual_field(rr, m_tot, params=None):
    """AQUAL field with the simple interpolation function
    mu(x) = x / (1 + x).

    In spherical symmetry the AQUAL field equation reduces exactly to
    the algebraic relation mu(|g|/a0) g = g_N, and for the simple mu the
    inversion is closed-form (:func:`_simple_mu_inverse`).  Limits:
    x -> y (Newtonian) as y -> inf, x -> sqrt(y) (deep MOND) as y -> 0.
    """
    a0 = _a0_galactic(params)
    return _simple_mu_inverse(newtonian_field(rr, m_tot), a0)


def emond_a0(phi, params=None):
    """EMOND's potential-dependent acceleration scale A0(phi)
    (Zhao & Famaey 2012 / Hodson & Zhao 2017 form):

        A0(phi) = a + (A - a) * (tanh(log10((phi/p0)^2)) + 1) / 2

    with a = 0.003868, A = 0.30944, p0 = -7.614 and phi the gravitational
    potential in (100 km/s)^2, the convention of the EMOND literature;
    ``phi`` is given in galactic units (kpc^2/Myr^2) and the result is
    returned in galactic units (kpc/Myr^2), scaled so that A0 -> a
    reproduces the standard a0.  The shape is even in phi, so either sign
    convention of the potential is accepted; |phi/p0| is clamped at 1e-30
    before the log.  The constants are overridable via ``params`` keys
    a, A, p0."""
    p = params or {}
    a = p.get("a", 0.003868)
    A = p.get("A", 0.30944)
    p0 = p.get("p0", -7.614)
    # phi in (100 km/s)^2: 1 kpc^2/Myr^2 = (977.79 km/s)^2
    phi_units = (torch.as_tensor(phi, dtype=torch.float64)
                 * (C.KPC_M / C.MYR_S / 1.0e5) ** 2)
    ratio = torch.clamp_min(torch.abs(phi_units / p0), 1e-30)
    shape = 0.5 * (torch.tanh(torch.log10(ratio * ratio)) + 1.0)
    A0 = a + (A - a) * shape
    # normalize: the literature's a corresponds to the standard a0
    return A0 / a * _a0_galactic(params)


def emond_field(rr, m_tot, params=None):
    """EMOND field: AQUAL's simple-mu closed-form inversion with the
    acceleration scale promoted to A0(phi) (:func:`emond_a0`).

    Needs the potential: pass ``params={"phi": <(..., n) potential on
    rr>}`` (galactic units, negative)."""
    if params is None or params.get("phi") is None:
        raise ValueError("emond_field needs params={'phi': potential "
                         "tensor on rr} (EMOND's A0 depends on the "
                         "potential)")
    a0 = emond_a0(params["phi"], params)
    return _simple_mu_inverse(newtonian_field(rr, m_tot), a0)


register_gravity("newtonian", newtonian_field)
register_gravity("qumond", qumond_field)
register_gravity("aqual", aqual_field)
register_gravity("emond", emond_field)


def dynamical_mass(rr, g, gravity="newtonian", phi=None, params=None):
    """Invert a gravity law: observed hydrostatic field ``g`` (negative,
    inward, kpc/Myr^2) -> matter ("dynamical") mass M_dyn(<r).

    * ``newtonian``: M = -r^2 g / G.
    * ``aqual``/``qumond``: in spherical symmetry with the simple
      interpolation pair the two theories coincide, so one closed form
      serves both: g_N = mu(|g|/a0) g with mu(x) = x/(1+x),
      M = -r^2 g_N / G.
    * ``emond``: the same with a0 -> A0(phi) pointwise (pass ``phi``).
    """
    if gravity == "newtonian":
        return -rr * rr * g / C.G
    if gravity == "emond":
        if phi is None:
            raise ValueError("emond dynamical_mass needs phi")
        a0 = emond_a0(phi, params)
    elif gravity in ("aqual", "qumond"):
        a0 = _a0_galactic(params)
    else:
        raise KeyError(f"Unknown gravity law {gravity!r} for "
                       "dynamical_mass")
    x = torch.abs(g) / a0
    g_n = g * x / (1.0 + x)  # mu(x) g
    return -rr * rr * g_n / C.G


def field_for_law(rr, m_tot, gravity="newtonian", phi=None, params=None):
    """Matter mass profile -> field per the named law, with EMOND's
    potential threaded through ``params``."""
    law = get_gravity(gravity)
    if gravity == "emond":
        p = dict(params or {})
        p["phi"] = phi
        return law(rr, m_tot, p)
    return law(rr, m_tot, params)
