"""Unit layer for the I/O boundary.

Tensors and arrays inside the compute path are plain float64 in galactic
units (kpc, Msun, Myr, with temperature carried in keV and magnetic field
in gauss).  Unit handling is a small registry of named units with
conversion factors to and from the galactic base, used by writers, readers
and the user-facing setters.  Every function takes a ``torch.Tensor``
(which stays on its device) or anything ``numpy.asarray`` accepts; the
registry and the factors are those of ``cluster_generator_tpu.core.units``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import constants as C

__all__ = ["unit_factor", "conversion_factor", "to_galactic", "from_galactic",
           "to_field_units", "keV_to_K", "K_to_keV", "galactic_to_cgs_factor",
           "ne_to_density", "density_to_ne", "FIELD_UNITS", "CGS_UNITS"]


def _f64(x):
    """``x`` as float64: a tensor stays a tensor on its device."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64)
    return np.asarray(x, dtype=np.float64)

# Dimension signature: (mass, length, time, temperature) exponents over the
# galactic base (Msun, kpc, Myr, K).  "factor" converts FROM the named unit
# TO galactic base units: x_galactic = x_unit * factor.
_G_CM3 = C.MSUN_KG * 1.0e3 / (C.CM_PER_KPC**3)  # 1 Msun/kpc**3 in g/cm**3

_REGISTRY: dict[str, tuple[float, tuple[float, float, float, float]]] = {
    # length
    "kpc": (1.0, (0, 1, 0, 0)),
    "Mpc": (1.0e3, (0, 1, 0, 0)),
    "pc": (1.0e-3, (0, 1, 0, 0)),
    "cm": (1.0 / C.CM_PER_KPC, (0, 1, 0, 0)),
    "m": (100.0 / C.CM_PER_KPC, (0, 1, 0, 0)),
    "km": (1.0e5 / C.CM_PER_KPC, (0, 1, 0, 0)),
    # mass
    "Msun": (1.0, (1, 0, 0, 0)),
    "1e10*Msun": (1.0e10, (1, 0, 0, 0)),
    "g": (1.0e-3 / C.MSUN_KG, (1, 0, 0, 0)),
    "kg": (1.0 / C.MSUN_KG, (1, 0, 0, 0)),
    # time
    "Myr": (1.0, (0, 0, 1, 0)),
    "Gyr": (1.0e3, (0, 0, 1, 0)),
    "yr": (1.0e-6, (0, 0, 1, 0)),
    "s": (1.0 / C.MYR_S, (0, 0, 1, 0)),
    # temperature
    "K": (1.0, (0, 0, 0, 1)),
    # velocity
    "kpc/Myr": (1.0, (0, 1, -1, 0)),
    "km/s": (C.km_s, (0, 1, -1, 0)),
    "cm/s": (C.km_s * 1e-5, (0, 1, -1, 0)),
    # density
    "Msun/kpc**3": (1.0, (1, -3, 0, 0)),
    "1e10*Msun/kpc**3": (1.0e10, (1, -3, 0, 0)),
    "g/cm**3": (1.0 / _G_CM3, (1, -3, 0, 0)),
    # number density (bare; composition conversions live in helpers below)
    "cm**-3": (1.0, (0, -3, 0, 0)),
    # mass / enclosed-mass
    # pressure / energy density
    "Msun/kpc/Myr**2": (1.0, (1, -1, -2, 0)),
    "Msun/(kpc*Myr**2)": (1.0, (1, -1, -2, 0)),
    "Msun/(Myr**2*kpc)": (1.0, (1, -1, -2, 0)),
    # 1 erg/cm**3 = 0.1 kg m^-1 s^-2 -> galactic pressure units
    "erg/cm**3": (0.1 * C.KPC_M * C.MYR_S**2 / C.MSUN_KG, (1, -1, -2, 0)),
    # momentum density
    "Msun/(Myr*kpc**2)": (1.0, (1, -2, -1, 0)),
    # specific energy
    "kpc**2/Myr**2": (1.0, (0, 2, -2, 0)),
    "km**2/s**2": (C.km_s**2, (0, 2, -2, 0)),
    # 1 erg/g = 1e-4 m^2/s^2 -> kpc^2/Myr^2
    "erg/g": (1.0e-4 * (C.MYR_S / C.KPC_M) ** 2, (0, 2, -2, 0)),
    # temperature-as-energy (keV) — stored natively for the temperature field
    "keV": (1.0, (0, 0, 0, 0)),  # opaque: temperature fields carry keV natively
    # magnetic field — stored natively in gauss; dimensions are the true
    # Gaussian-cgs ones (B ~ g^1/2 cm^-1/2 s^-1) so dimension checks can
    # tell a field strength from a velocity or a plain scalar
    "gauss": (1.0, (0.5, -0.5, -1, 0)),
    "G": (1.0, (0.5, -0.5, -1, 0)),
    "uG": (1.0e-6, (0.5, -0.5, -1, 0)),
    # magnetic vector potential (B x length; ClusterField.units for
    # vector_potential=True fields)
    "gauss*kpc": (1.0, (0.5, 0.5, -1, 0)),
    "G*kpc": (1.0, (0.5, 0.5, -1, 0)),
    "uG*kpc": (1.0e-6, (0.5, 0.5, -1, 0)),
    # distribution function
    "Msun*Myr**3/kpc**6": (1.0, (1, -6, 3, 0)),
    # potential gradient
    "kpc/Myr**2": (1.0, (0, 1, -2, 0)),
    "dimensionless": (1.0, (0, 0, 0, 0)),
    "": (1.0, (0, 0, 0, 0)),
}


def unit_factor(unit: str) -> float:
    """Conversion factor from `unit` to galactic base units."""
    try:
        return _REGISTRY[unit][0]
    except KeyError:
        raise KeyError(f"Unknown unit {unit!r}; register it in core/units.py")


def conversion_factor(from_unit: str, to_unit: str) -> float:
    """Factor converting values in ``from_unit`` to ``to_unit``,
    REFUSING dimensionally-incompatible pairs (``unit_factor`` ratios
    alone would happily convert gauss to kpc/Myr)."""
    try:
        f_f, d_f = _REGISTRY[from_unit]
    except KeyError:
        raise KeyError(f"Unknown unit {from_unit!r}; register it in "
                       "core/units.py")
    try:
        f_t, d_t = _REGISTRY[to_unit]
    except KeyError:
        raise KeyError(f"Unknown unit {to_unit!r}; register it in "
                       "core/units.py")
    if d_f != d_t:
        raise ValueError(
            f"Unit {to_unit!r} (dimensions {d_t}) is not convertible "
            f"from {from_unit!r} (dimensions {d_f}).")
    return f_f / f_t


def to_galactic(x, unit: str):
    return _f64(x) * unit_factor(unit)


def from_galactic(x, unit: str):
    return _f64(x) / unit_factor(unit)


# --------------------------------------------------------------- field units
#: canonical unit string for every model field, as stored on disk;
#: "entropy", "electron_number_density" and "magnetic_field_strength" keep
#: their natural units.
FIELD_UNITS: dict[str, str] = {
    "radius": "kpc",
    "density": "Msun/kpc**3",
    "temperature": "keV",
    "pressure": "Msun/(kpc*Myr**2)",
    "entropy": "keV*cm**2",
    "total_density": "Msun/kpc**3",
    "gravitational_potential": "kpc**2/Myr**2",
    "gravitational_field": "kpc/Myr**2",
    "total_mass": "Msun",
    "gas_mass": "Msun",
    "dark_matter_mass": "Msun",
    "dark_matter_density": "Msun/kpc**3",
    "stellar_density": "Msun/kpc**3",
    "stellar_mass": "Msun",
    "gas_fraction": "dimensionless",
    "electron_number_density": "cm**-3",
    "magnetic_field_strength": "gauss",
    "velocity_dispersion": "kpc/Myr",
}

# cgs equivalents used by ``write_model_to_h5(in_cgs=True)``
CGS_UNITS: dict[str, str] = {
    "radius": "cm",
    "density": "g/cm**3",
    "temperature": "K",  # thermal equivalent: T[K] = T[keV]*keV/kboltz
    "pressure": "erg/cm**3",
    "total_density": "g/cm**3",
    "gravitational_potential": "cm**2/s**2",
    "gravitational_field": "cm/s**2",
    "total_mass": "g",
    "gas_mass": "g",
    "dark_matter_mass": "g",
    "dark_matter_density": "g/cm**3",
    "stellar_density": "g/cm**3",
    "stellar_mass": "g",
    "gas_fraction": "dimensionless",
    "velocity_dispersion": "cm/s",
}

# native-unit families for fields stored in non-galactic-base units (the
# keep-units fields and temperature): only same-family units convert
_NATIVE_GROUPS: dict[str, set[str]] = {
    "keV": {"keV"},
    "gauss": {"gauss", "G", "uG"},
    "cm**-3": {"cm**-3"},
    "keV*cm**2": {"keV*cm**2"},
}


def to_field_units(x, unit: str, field: str):
    """Convert ``x`` given in ``unit`` into ``field``'s NATIVE storage unit,
    refusing dimensionally-incompatible conversions.

    Fields stored in galactic base units accept any registered unit of the
    same dimension; fields stored natively in keV / gauss / cm^-3 accept
    only their own unit family (e.g. temperature must come in keV — passing
    Kelvin raises instead of silently storing K values as keV; convert
    thermally with :func:`K_to_keV` first).
    """
    native = FIELD_UNITS.get(field)
    if native is None:
        return to_galactic(x, unit)
    if native in _NATIVE_GROUPS:
        group = _NATIVE_GROUPS[native]
        if unit not in group:
            raise ValueError(
                f"Field {field!r} is stored in {native!r}; cannot convert "
                f"from {unit!r} (accepted: {sorted(group)}). For "
                "temperature in Kelvin use units.K_to_keV first.")
        return _f64(x) * (unit_factor(unit)
                                            / unit_factor(native))
    # one copy of the dimension-check-then-ratio rule (conversion_factor);
    # re-raise with the field name for context
    try:
        return _f64(x) * conversion_factor(unit, native)
    except ValueError as e:
        raise ValueError(f"Field {field!r}: {e}") from None


def keV_to_K(T_keV):
    """Thermal equivalent temperature: T[K] = E[keV] / k_B."""
    return _f64(T_keV) * (C.KEV_SI / C.KBOLTZ_SI)


def K_to_keV(T_K):
    return _f64(T_K) / (C.KEV_SI / C.KBOLTZ_SI)


def galactic_to_cgs_factor(field: str) -> float:
    """Multiplier converting a galactic-units field value to its cgs unit."""
    kpc_cm = C.CM_PER_KPC
    s_per_Myr = C.MYR_S
    g_per_Msun = C.MSUN_KG * 1.0e3
    table = {
        "kpc": kpc_cm,
        "Msun": g_per_Msun,
        "Msun/kpc**3": g_per_Msun / kpc_cm**3,
        "Msun/(kpc*Myr**2)": g_per_Msun / (kpc_cm * s_per_Myr**2),
        "kpc**2/Myr**2": kpc_cm**2 / s_per_Myr**2,
        "kpc/Myr**2": kpc_cm / s_per_Myr**2,
        "kpc/Myr": kpc_cm / s_per_Myr,
        "Msun/(Myr*kpc**2)": g_per_Msun / (s_per_Myr * kpc_cm**2),
    }
    unit = FIELD_UNITS.get(field)
    if field == "temperature":
        return C.KEV_SI / C.KBOLTZ_SI  # keV -> K
    if unit in table:
        return table[unit]
    return 1.0  # keep-units fields and dimensionless


def ne_to_density(ne_cm3):
    """Electron number density [cm^-3] -> gas mass density [Msun/kpc^3].

    rho = n_e * mue * m_p.  Works on tensors, arrays, floats and profiles.
    """
    mp_g = C.MP_SI * 1.0e3
    return ne_cm3 * (C.mue * mp_g / _G_CM3)


def density_to_ne(rho_gal):
    """Gas mass density [Msun/kpc^3] -> electron number density [cm^-3].

    n_e = rho / (mue m_p).  Works on tensors, arrays, floats and profiles.
    """
    mp_g = C.MP_SI * 1.0e3
    return rho_gal * (_G_CM3 / (C.mue * mp_g))
