"""The named radial-profile library.

Every profile of ``cluster_generator_tpu.profiles.library`` as a
parameterized :class:`~cluster_generator_tpu_torch.profiles.algebra.Profile`
on float64 tensors, the same formulas in the same order.  Parameters are
Python floats or tensors with a leading batch shape (one entry per halo);
the helper functions (``snfw_total_mass``, ``convert_nfw_to_hernquist``,
...) take either and return the same kind.
"""

from __future__ import annotations

import math

import torch

from ..core.cosmology import Cosmology, default_cosmology
from .algebra import Profile, constant_profile, power_law_profile

__all__ = [
    "constant_profile", "power_law_profile", "beta_model_profile",
    "hernquist_density_profile", "cored_hernquist_density_profile",
    "hernquist_mass_profile", "convert_nfw_to_hernquist",
    "nfw_density_profile", "nfw_mass_profile", "nfw_scale_density",
    "tnfw_density_profile", "tnfw_mass_profile", "snfw_density_profile",
    "snfw_mass_profile", "snfw_total_mass", "cored_snfw_density_profile",
    "cored_snfw_mass_profile", "snfw_conc", "cored_snfw_total_mass",
    "einasto_density_profile", "einasto_mass_profile",
    "am06_density_profile", "vikhlinin_density_profile",
    "vikhlinin_temperature_profile", "am06_temperature_profile",
    "baseline_entropy_profile", "broken_entropy_profile",
    "walker_entropy_profile",
]


def _log(x):
    return torch.log(x) if isinstance(x, torch.Tensor) else math.log(x)


def _sqrt(x):
    return torch.sqrt(x) if isinstance(x, torch.Tensor) else math.sqrt(x)


def _tensor(x, like):
    """A parameter (float or tensor) as a float64 tensor beside ``like``."""
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def _nfw_factor(conc):
    """1 / (ln(1+c) - c/(1+c))."""
    return 1.0 / (_log(conc + 1.0) - conc / (1.0 + conc))


def _beta_model_profile_fn(p, r):
    rho_c, r_c, beta = p
    return rho_c * (1.0 + (r / r_c) ** 2) ** (-1.5 * beta)


def beta_model_profile(rho_c, r_c, beta):
    """Beta-model density."""

    return Profile(_beta_model_profile_fn, (rho_c, r_c, beta))


def _hernquist_density_profile_fn(p, r):
    M0, a = p
    return M0 / (2.0 * math.pi * a**3) / ((r / a) * (1.0 + r / a) ** 3)


def hernquist_density_profile(M_0, a):
    """Hernquist 1990 density."""

    return Profile(_hernquist_density_profile_fn, (M_0, a))


def _cored_hernquist_density_profile_fn(p, r):
    M0, a, b = p
    return M0 * b / (2.0 * math.pi * a**3) / ((1.0 + b * r / a) * (1.0 + r / a) ** 3)


def cored_hernquist_density_profile(M_0, a, b):
    """Cored Hernquist density."""

    return Profile(_cored_hernquist_density_profile_fn, (M_0, a, b))


def _hernquist_mass_profile_fn(p, r):
    M0, a = p
    return M0 * r**2 / (r + a) ** 2


def hernquist_mass_profile(M_0, a):
    """Hernquist enclosed mass."""

    return Profile(_hernquist_mass_profile_fn, (M_0, a))


def convert_nfw_to_hernquist(M_200, r_200, conc):
    """NFW (M200, r200, c) -> equivalent Hernquist (M0, a)."""
    a = r_200 / (_sqrt(0.5 * conc * conc * _nfw_factor(conc)) - 1.0)
    M0 = M_200 * (r_200 + a) ** 2 / r_200**2
    return M0, a


def _nfw_density_profile_fn(p, r):
    rho_s, r_s = p
    x = r / r_s
    return rho_s / (x * (1.0 + x) ** 2)


def nfw_density_profile(rho_s, r_s):
    """NFW 1996 density."""

    return Profile(_nfw_density_profile_fn, (rho_s, r_s))


def _nfw_mass_profile_fn(p, r):
    rho_s, r_s = p
    x = r / r_s
    return 4.0 * math.pi * rho_s * r_s**3 * (torch.log(1.0 + x) - x / (1.0 + x))


def nfw_mass_profile(rho_s, r_s):
    """NFW enclosed mass."""

    return Profile(_nfw_mass_profile_fn, (rho_s, r_s))


def nfw_scale_density(conc, z=0.0, delta=200.0, cosmo: Cosmology | None = None):
    """NFW scale density from concentration."""
    if cosmo is None:
        cosmo = default_cosmology()
    rho_crit = cosmo.critical_density(z)
    return delta * rho_crit * conc**3 * _nfw_factor(conc) / 3.0


def _tnfw_density_profile_fn(p, r):
    rho_s, r_s, r_t = p
    x = r / r_s
    return rho_s / (x * (1.0 + x) ** 2) / (1.0 + (r / r_t) ** 2)


def tnfw_density_profile(rho_s, r_s, r_t):
    """Truncated NFW density."""

    return Profile(_tnfw_density_profile_fn, (rho_s, r_s, r_t))


def _tnfw_mass_profile_fn(p, r):
    rho_s, r_s, r_t = p
    y = r / r_s
    a = r_t / r_s
    a2 = a * a
    A = a2 * (a2 - 1.0) / (1.0 + a2) ** 2
    B = -a2 / (1.0 + a2)
    C = -A
    D = 2.0 * a2 * a2 / (1.0 + a2) ** 2
    F = (A * torch.log(1.0 + y) + B * y / (1.0 + y)
         + 0.5 * C * torch.log(1.0 + (y / a) ** 2)
         + (D / a) * torch.arctan(y / a))
    return 4.0 * math.pi * rho_s * r_s**3 * F


def tnfw_mass_profile(rho_s, r_s, r_t):
    """Truncated NFW enclosed mass.

    The antiderivative of x / ((1+x)^2 (1+(x/a)^2)) by partial fractions
    (held against quadrature of the density in the tests):

        F(y; a) = A ln(1+y) + B y/(1+y) + (C/2) ln(1+(y/a)^2)
                  + (D/a) arctan(y/a)
        A = a^2 (a^2-1)/(1+a^2)^2,  B = -a^2/(1+a^2),
        C = -A,                     D = 2 a^4/(1+a^2)^2.
    """

    return Profile(_tnfw_mass_profile_fn, (rho_s, r_s, r_t))


def _snfw_density_profile_fn(p, r):
    M, a = p
    x = r / a
    return 3.0 * M / (16.0 * math.pi * a**3) / (x * (1.0 + x) ** 2.5)


def snfw_density_profile(M, a):
    """Super-NFW density."""

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


def _cored_snfw_density_profile_fn(p, r):
    M, a, r_c = p
    b = a / r_c
    x = r / a
    return 3.0 * M * b / (16.0 * math.pi * a**3) / ((1.0 + b * x) * (1.0 + x) ** 2.5)


def cored_snfw_density_profile(M, a, r_c):
    """Cored super-NFW density."""

    return Profile(_cored_snfw_density_profile_fn, (M, a, r_c))


def _cored_snfw_mass_profile_fn(p, r):
    M, a, r_c = p
    b = _tensor(a / r_c, r)
    x = r / a
    y = torch.sqrt(x + 1.0)
    e = b * (b - 1.0) ** 2
    ret = (1.0 - 1.0 / y) * (b - 2.0) / (b - 1.0) ** 2
    ret = ret + (1.0 / y**3 - 1.0) / (3.0 * (b - 1.0))
    # third term: Re[d (arctan(y d) - arctan(d))] with d = sqrt(b/(1-b)).
    # For b < 1, d is real and the arctans evaluate directly; for b > 1,
    # d = i g with g = sqrt(b/(b-1)) > 1 and the principal branch gives
    # Re[d arctan(i z g-ish)] = -g artanh(1/z), so the difference becomes
    # g (artanh(1/g) - artanh(1/(y g))), all real (the inner ``where``
    # guards keep the inactive branch finite).
    sub = b < 1.0
    one = torch.ones_like(b)
    d_lt = torch.sqrt(b / torch.where(sub, 1.0 - b, one))
    t_lt = d_lt * (torch.arctan(y * d_lt) - torch.arctan(d_lt))
    g = torch.sqrt(b / torch.where(sub, one, b - 1.0))
    g_safe = torch.where(sub, 2.0 * one, g)
    t_gt = g_safe * (torch.arctanh(1.0 / g_safe)
                     - torch.arctanh(1.0 / (y * g_safe)))
    ret = ret + torch.where(sub, t_lt, t_gt) / e
    return 1.5 * M * b * ret


def cored_snfw_mass_profile(M, a, r_c):
    """Cored super-NFW enclosed mass.

    The closed form has a complex-valued arctan branch; it is evaluated
    real-valued with the principal-branch identity per the b <-> 1
    regimes (tested against quadrature of the density on both sides of
    b = 1)."""

    return Profile(_cored_snfw_mass_profile_fn, (M, a, r_c))


def snfw_conc(conc_nfw):
    """sNFW concentration from NFW concentration."""
    return 0.76 * conc_nfw + 1.36


def cored_snfw_total_mass(mass, radius, a, r_c, device="cuda"):
    """Total-mass parameter for the cored sNFW model: a tensor, on the
    device of ``radius`` when that is one and else on ``device`` (the
    closed form of the mass profile is tensor code)."""
    mp = cored_snfw_mass_profile(1.0, a, r_c)
    return mass / mp(radius, device=device)


def _dn(n):
    """Einasto d_n series."""
    return 3.0 * n - 1.0 / 3.0 + 8.0 / (1215.0 * n) + 184.0 / (229635.0 * n * n)


def _einasto_density_profile_fn(p, r):
    M, r_s, n = p
    alpha = 1.0 / n
    h = r_s / _dn(n) ** n
    # gamma(3n) = exp(gammaln(3n))
    n = _tensor(n, r)
    rho_0 = M / (4.0 * math.pi * h**3 * n
                 * torch.exp(torch.special.gammaln(3.0 * n)))
    s = r / h
    return rho_0 * torch.exp(-(s**alpha))


def einasto_density_profile(M, r_s, n):
    """Einasto density."""

    return Profile(_einasto_density_profile_fn, (M, r_s, n))


def _einasto_mass_profile_fn(p, r):
    M, r_s, n = p
    alpha = 1.0 / n
    h = r_s / _dn(n) ** n
    s = r / h
    a3 = _tensor(3.0 * n, r)
    return M * torch.special.gammainc(a3.expand(s.shape), s**alpha)


def einasto_mass_profile(M, r_s, n):
    """Einasto enclosed mass.

    M(r) = M * (1 - gammaincc(3n, s^alpha)) = M * gammainc(3n, s^alpha)
    with the regularized lower incomplete gamma.
    """

    return Profile(_einasto_mass_profile_fn, (M, r_s, n))


def _am06_density_profile_fn(p, r):
    rho_0, a, a_c, c, n = p
    alpha = -1.0 - n * (c - 1.0) / (c - a / a_c)
    beta = 1.0 - n * (1.0 - a / a_c) / (c - a / a_c)
    return (rho_0 * (1.0 + r / a_c) * (1.0 + r / (a_c * c)) ** alpha
            * (1.0 + r / a) ** beta)


def am06_density_profile(rho_0, a, a_c, c, n):
    """Ascasibar & Markevitch 2006 density."""

    return Profile(_am06_density_profile_fn, (rho_0, a, a_c, c, n))


def _vikhlinin_density_profile_fn(p, r):
    rho_0, r_c, r_s, alpha, beta, epsilon, gamma = p
    return (rho_0 * (r / r_c) ** (-0.5 * alpha)
            * (1.0 + (r / r_c) ** 2) ** (-1.5 * beta + 0.25 * alpha)
            * (1.0 + (r / r_s) ** gamma) ** (-0.5 * epsilon / gamma))


def vikhlinin_density_profile(rho_0, r_c, r_s, alpha, beta, epsilon, gamma=None):
    """Vikhlinin+06 modified beta-model density.  The default ``gamma`` is
    the integer 3, so that its power stays an exact cube in a captured
    program, where a float parameter becomes an input."""
    if gamma is None:
        gamma = 3

    return Profile(_vikhlinin_density_profile_fn, (rho_0, r_c, r_s, alpha, beta, epsilon, gamma))


def _vikhlinin_temperature_profile_fn(p, r):
    T_0, a, b, c, r_t, T_min, r_cool, a_cool = p
    x = (r / r_cool) ** a_cool
    t = (r / r_t) ** (-a) / (1.0 + (r / r_t) ** b) ** (c / b)
    return T_0 * t * (x + T_min / T_0) / (x + 1.0)


def vikhlinin_temperature_profile(T_0, a, b, c, r_t, T_min, r_cool, a_cool):
    """Vikhlinin+06 temperature."""

    return Profile(_vikhlinin_temperature_profile_fn, (T_0, a, b, c, r_t, T_min, r_cool, a_cool))


def _am06_temperature_profile_fn(p, r):
    T_0, a, a_c, c = p
    return T_0 / (1.0 + r / a) * (c + r / a_c) / (1.0 + r / a_c)


def am06_temperature_profile(T_0, a, a_c, c):
    """AM06 temperature."""

    return Profile(_am06_temperature_profile_fn, (T_0, a, a_c, c))


def _baseline_entropy_profile_fn(p, r):
    K_0, K_200, r_200, alpha = p
    return K_0 + K_200 * (r / r_200) ** alpha


def baseline_entropy_profile(K_0, K_200, r_200, alpha):
    """Voit+05 baseline entropy."""

    return Profile(_baseline_entropy_profile_fn, (K_0, K_200, r_200, alpha))


def _broken_entropy_profile_fn(p, r):
    r_s, K_scale, alpha, K_0 = p
    x = r / r_s
    ret = (x**alpha) * (1.0 + x**5) ** (0.2 * (1.1 - alpha))
    return K_scale * (K_0 + ret)


def broken_entropy_profile(r_s, K_scale, alpha, K_0=0.0):
    """Broken power-law entropy."""

    return Profile(_broken_entropy_profile_fn, (r_s, K_scale, alpha, K_0))


def _walker_entropy_profile_fn(p, r):
    r_200, A, B, K_scale, alpha = p
    x = r / r_200
    return K_scale * (A * x**alpha) * torch.exp(-((x / B) ** 2))


def walker_entropy_profile(r_200, A, B, K_scale, alpha=1.1):
    """Walker+12-style entropy."""

    return Profile(_walker_entropy_profile_fn, (r_200, A, B, K_scale, alpha))
