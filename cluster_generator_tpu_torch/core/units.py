"""Unit conversions the model build needs (galactic units throughout)."""

from __future__ import annotations

from . import constants as C

# 1 Msun/kpc**3 in g/cm**3
_G_CM3 = C.MSUN_KG * 1.0e3 / (C.CM_PER_KPC**3)


def density_to_ne(rho_gal):
    """Gas mass density [Msun/kpc^3] -> electron number density [cm^-3],
    n_e = rho / (mue m_p)."""
    mp_g = C.MP_SI * 1.0e3
    return rho_gal * (_G_CM3 / (C.mue * mp_g))
