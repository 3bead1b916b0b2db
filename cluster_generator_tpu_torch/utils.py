"""The names of upstream's ``cluster_generator.utils`` on top of the
port's core: constants, loggers, config, the radial integrals and the
sampling helpers.

The integrals take a profile (a callable on tensors) and a radius grid;
a tensor grid stays on its device, an array goes to ``device`` (the card
unless ``"cpu"`` is asked for), and the result is a float64 tensor there.
"""

from __future__ import annotations

import numpy as np

from .core.config import cgparams  # noqa: F401
from .core.constants import G, X_H, kboltz, kpc_to_cm, mp, mu, mue  # noqa: F401
from .core.device import tensor_on
from .core.logging import devLogger, mylog  # noqa: F401
from .core.quadrature import integrate_from, integrate_tail_to_inf
from .core.quadrature import integrate_mass as _integrate_mass
from .sampling import generate_particle_radii, parse_prng  # noqa: F401

__all__ = ["G", "mp", "kboltz", "kpc_to_cm", "X_H", "mu", "mue", "mylog",
           "devLogger", "cgparams", "integrate_mass", "integrate",
           "integrate_toinf", "generate_particle_radii", "parse_prng",
           "ensure_list", "field_label_map"]


def integrate_mass(profile, rr, device="cuda"):
    """m(r) = 4 pi int_0^r rho r^2 dr at every grid point."""
    return _integrate_mass(profile, tensor_on(rr, device))


def integrate(profile, rr, device="cuda"):
    """int_r^rmax profile dr at every grid point."""
    return integrate_from(profile, tensor_on(rr, device))


def integrate_toinf(profile, rr, device="cuda"):
    """int_r^rmax profile dr + int_rmax^inf profile dr at every grid
    point."""
    rr = tensor_on(rr, device)
    return integrate_from(profile, rr) + integrate_tail_to_inf(profile,
                                                               rr[-1])


def ensure_list(x):
    if isinstance(x, (list, tuple)):
        return list(x)
    if isinstance(x, np.ndarray):
        return list(x)
    return [x]


field_label_map = {
    "density": "$\\rho_g$ (g cm$^{-3}$)",
    "temperature": "kT (keV)",
    "pressure": "P (erg cm$^{-3}$)",
    "entropy": "S (keV cm$^{2}$)",
    "dark_matter_density": "$\\rho_{\\rm DM}$ (g cm$^{-3}$)",
    "electron_number_density": "n$_e$ (cm$^{-3}$)",
    "stellar_mass": "M$_*$ (M$_\\odot$)",
    "stellar_density": "$\\rho_*$ (g cm$^{-3}$)",
    "dark_matter_mass": "$M_{\\rm DM}$ (M$_\\odot$)",
    "gas_mass": "M$_g$ (M$_\\odot$)",
    "total_mass": "M$_{\\rm tot}$ (M$_\\odot$)",
    "gas_fraction": "f$_{\\rm gas}$",
    "magnetic_field_strength": "B (G)",
    "gravitational_potential": "$\\Phi$ (kpc$^2$ Myr$^{-2}$)",
    "gravitational_field": "g (kpc Myr$^{-2}$)",
}
