"""Gravity laws: enclosed-mass profile -> gravitational field.

Newton is the one law ported; the MOND laws of
``cluster_generator_tpu.model.gravity`` wait for a later slice.
"""

from __future__ import annotations

from ..core import constants as C

__all__ = ["newtonian_field", "get_gravity", "field_for_law"]


def newtonian_field(rr, m_tot, params=None):
    """g = -G M(<r) / r^2."""
    return -C.G * m_tot / (rr * rr)


_LAWS = {"newtonian": newtonian_field}


def get_gravity(name: str):
    """The field function of the named law; an unported name raises."""
    try:
        return _LAWS[name]
    except KeyError:
        raise NotImplementedError(
            f"gravity law {name!r} is not ported; "
            f"available: {sorted(_LAWS)}") from None


def field_for_law(rr, m_tot, gravity="newtonian", phi=None, params=None):
    """Matter mass profile -> field per the named law."""
    return get_gravity(gravity)(rr, m_tot, params)
