"""Plain NumPy reference of the equilibrium cluster model, its Eddington
DFs and its inverse speed-CDF tables, written from the physics the
configuration files state and from nothing of the package under test.

The cluster: a super-NFW total density (Lilley et al. 2018) from M200 and c,
a Vikhlinin et al. (2006) gas density scaled to f_gas(M500) M500 inside r500,
stars at 2% of the total density, dark matter the rest (clipped at zero),
hydrostatic gas pressure under Newtonian gravity, on a log-radius grid of
0.1-10000 kpc.  The total mass, the potential and the field are closed forms
of the sNFW profile; the gas mass and the pressure are quadratures of the
closed-form densities (Gauss-Legendre panels in ln r).

The DF is Eddington's formula as cluster_generator evaluates it: a
not-a-knot cubic spline of the density against psi through the grid nodes
(its end pieces extended), g(E) = int_0^E rho'(psi) dpsi / sqrt(E - psi),
and f(E) = g'(E) / (sqrt(8) pi^2) from a not-a-knot spline of g.  Here g is
a Gauss-Legendre sum in t = sqrt(E - psi) over each spline piece, on which
the integrand is a polynomial of degree 4, so three nodes a piece are exact.

Every step runs in the NumPy type ``dt`` (float64 unless a control asks for
less); SciPy's splines always work in float64, so a lower ``dt`` rounds their
inputs and outputs.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.interpolate import CubicSpline

# ------------------------------------------------------------ units
# kpc, Msun, Myr (cluster_generator's unit system)
G_SI = 6.67430e-11
MP_SI = 1.67262192369e-27
KEV_SI = 1.602176634e-16
AU_M = 1.495978707e11
KPC_M = 1.0e3 * 648000.0 / math.pi * AU_M
MYR_S = 1.0e6 * 365.25 * 86400.0
MSUN_KG = 1.98892e30
G = G_SI * MSUN_KG * MYR_S**2 / KPC_M**3
MP = MP_SI / MSUN_KG
KEV = KEV_SI * MYR_S**2 / (MSUN_KG * KPC_M**2)
X_H = 0.76
MU = 1.0 / (2.0 * X_H + 0.75 * (1.0 - X_H))      # mean molecular weight
MUE = 1.0 / (X_H + 0.5 * (1.0 - X_H))             # per electron
GRAM_PER_CM3 = MSUN_KG * 1.0e3 / (KPC_M * 100.0) ** 3   # 1 Msun/kpc^3

F64 = np.float64


def critical_density(z, h=0.71, omega_m=0.27, omega_l=0.73):
    """rho_crit(z) of a flat LCDM cosmology in Msun/kpc^3."""
    h0 = h * 100.0 * 1.0e3 / (1.0e3 * KPC_M) * MYR_S          # 1/Myr
    hz2 = h0 * h0 * (omega_m * (1.0 + z) ** 3 + omega_l)
    return 3.0 * hz2 / (8.0 * math.pi * G)


def f_gas(m500, h=0.7):
    """Vikhlinin et al. (2009) gas fraction inside r500, as cluster_generator
    writes it."""
    return (0.72 / h) ** 1.5 * (0.125 + 0.037 * np.log10(m500 * 1.0e-15 / h))


# ------------------------------------------------------------ quadrature
def _gl(order, dt):
    x, w = np.polynomial.legendre.leggauss(order)
    return x.astype(dt), w.astype(dt)


def integral_log(fn, a, b, dt, order=12):
    """int_a^b fn(r) dr over panels with edges ``a`` and ``b`` (arrays of one
    shape), by Gauss-Legendre in ln r on each panel."""
    x, w = _gl(order, dt)
    la, lb = np.log(a), np.log(b)
    half = (0.5 * (lb - la))[..., None]
    s = (0.5 * (la + lb))[..., None] + half * x
    r = np.exp(s)
    return np.sum(fn(r) * r * w, axis=-1) * half[..., 0]


def integral_from_zero(fn, b, dt, order=24):
    """int_0^b fn(r) dr for a weak cusp at 0, by r = b t^2."""
    x, w = _gl(order, dt)
    t = 0.5 * (x + 1.0)
    bb = b[..., None]
    r = bb * t * t
    return np.sum(fn(r) * 2.0 * bb * t * (0.5 * w), axis=-1)


# ------------------------------------------------------------ one cluster
class Cluster:
    """The closed forms of one cluster from (M200, c, z), on the grid of
    ``num_points`` log-spaced radii over 0.1-10000 kpc."""

    def __init__(self, m200, conc, z, num_points, dt=F64):
        self.dt = dt
        m200, conc = dt(m200), dt(conc)
        rho_c = dt(critical_density(float(z)))
        self.r200 = (3.0 * m200 / (4.0 * math.pi * 200.0 * rho_c)) ** (
            dt(1.0) / 3)
        self.a = self.r200 / conc
        self.M = m200 / self._shape(conc)
        self.rho_c = rho_c
        self.r500 = self._radius_of_mean_density(500.0 * rho_c)
        self.m500 = self.total_mass(self.r500)
        # the gas: Vikhlinin's shape with r_s = r200, normalised inside r500
        self.gas_scale = dt(1.0)
        target = f_gas(self.m500) * self.m500
        self.gas_scale = target / self.gas_mass_to(self.r500)
        self.r = (10.0 ** np.linspace(-1.0, 4.0, num_points)).astype(dt)

    # sNFW
    @staticmethod
    def _shape(x):
        """M(<r)/M at x = r/a: 1 - (2 + 3x) / (2 (1+x)^1.5), written as
        (s-1)^2 (2s+1) / (2 s^3) with s = sqrt(1+x), s - 1 = x / (s+1), so
        that it does not cancel at small x."""
        s = np.sqrt(1.0 + x)
        sm1 = x / (s + 1.0)
        return sm1 * sm1 * (2.0 * s + 1.0) / (2.0 * s * s * s)

    def total_density(self, r):
        x = r / self.a
        return 3.0 * self.M / (16.0 * math.pi * self.a**3) / (
            x * (1.0 + x) ** 2.5)

    def total_mass(self, r):
        return self.M * self._shape(r / self.a)

    def _radius_of_mean_density(self, target):
        dt = self.dt
        lo, hi = np.log(dt(0.01)), np.log(dt(10000.0))
        for _ in range(200):
            mid = 0.5 * (lo + hi)
            r = np.exp(mid)
            mean = 3.0 * self.total_mass(r) / (4.0 * math.pi * r**3)
            lo, hi = (mid, hi) if mean > target else (lo, mid)
        return np.exp(0.5 * (lo + hi))

    def potential(self, r, r_out):
        """Phi(r) of the mass inside ``r_out``: -G (M(r)/r + 4 pi
        int_r^r_out rho r' dr'), the integral in closed form."""
        x, xo = r / self.a, r_out / self.a
        outer = self.M / (2.0 * self.a) * (
            (1.0 + x) ** -1.5 - (1.0 + xo) ** -1.5)
        return -G * (self.total_mass(r) / r + outer)

    # gas
    def gas_density(self, r):
        rc, beta, eps, gamma, alpha = 100.0, 0.67, 3.0, 3.0, 1.0
        y = r / rc
        return self.gas_scale * (
            y ** (-0.5 * alpha) * (1.0 + y * y) ** (-1.5 * beta + 0.25 * alpha)
            * (1.0 + (r / self.r200) ** gamma) ** (-0.5 * eps / gamma))

    def _gas_integrand(self, r):
        return 4.0 * math.pi * self.gas_density(r) * r * r

    def gas_mass_to(self, R):
        dt = self.dt
        inner = R * dt(1e-6)
        edges = np.exp(np.linspace(np.log(inner), np.log(R), 401)).astype(dt)
        return (integral_from_zero(self._gas_integrand, np.asarray(inner),
                                   dt)
                + np.sum(integral_log(self._gas_integrand, edges[:-1],
                                      edges[1:], dt)))

    # the grid
    def fields(self):
        """The model fields on the grid, keyed as the package names them."""
        dt, r = self.dt, self.r
        f = {"radius": r}
        f["density"] = self.gas_density(r)
        f["total_density"] = self.total_density(r)
        f["total_mass"] = self.total_mass(r)
        panels = integral_log(self._gas_integrand, r[:-1], r[1:], dt)
        first = integral_from_zero(self._gas_integrand, r[:1], dt)
        f["gas_mass"] = np.concatenate([first, first + np.cumsum(panels)])
        f["gravitational_field"] = -G * f["total_mass"] / (r * r)
        r_out = r[-1]
        m_out = f["total_mass"][-1]

        def dp(rr):   # -dP/dr = rho_gas G M(<r) / r^2
            return self.gas_density(rr) * G * self.total_mass(rr) / (rr * rr)

        inner = integral_log(dp, r[:-1], r[1:], dt)
        # beyond the grid the mass is the grid's: int_{r_out}^inf rho G m /
        # r^2 dr = G m / r_out int_0^1 rho(r_out / t) dt
        x, w = _gl(48, dt)
        t = 0.5 * (x + 1.0)
        tail = G * m_out / r_out * np.sum(
            self.gas_density(r_out / t) * 0.5 * w)
        f["pressure"] = np.concatenate(
            [np.cumsum(inner[::-1])[::-1], np.zeros(1, dt)]) + tail
        f["temperature"] = f["pressure"] / f["density"] * (MU * MP / KEV)
        f["gravitational_potential"] = self.potential(r, r_out)
        f["stellar_density"] = 0.02 * f["total_density"]
        f["stellar_mass"] = 0.02 * f["total_mass"]
        ddm = f["total_density"] - f["density"] - f["stellar_density"]
        mdm = f["total_mass"] - f["gas_mass"] - f["stellar_mass"]
        clipped = ddm < 0.0
        f["dark_matter_density"] = np.where(clipped, 0.0, ddm).astype(dt)
        f["dark_matter_mass"] = np.where(clipped, np.max(mdm), mdm).astype(dt)
        f["gas_fraction"] = f["gas_mass"] / f["total_mass"]
        f["electron_number_density"] = f["density"] * (
            GRAM_PER_CM3 / (MUE * MP_SI * 1.0e3))
        f["entropy"] = f["temperature"] * f["electron_number_density"] ** (
            -2.0 / 3.0)
        return f


# ------------------------------------------------------------ the DF
def eddington(psi, rho, dt=F64):
    """f(E) at the nodes ``psi`` (ascending) of a density ``rho(psi)``."""
    psi, rho = np.asarray(psi, dt), np.asarray(rho, dt)
    spl = CubicSpline(psi.astype(F64), rho.astype(F64), bc_type="not-a-knot")
    drho = spl.derivative()
    x, w = _gl(3, dt)
    lo = np.concatenate([np.zeros(1, dt), psi[:-1]])[None, :]
    hi = psi[None, :]
    E = psi[:, None]
    inside = hi <= E                            # the pieces below E
    ta = np.sqrt(np.where(inside, E - hi, 0.0))
    tb = np.sqrt(np.where(inside, E - lo, 0.0))
    half = 0.5 * (tb - ta)
    t = (0.5 * (ta + tb))[..., None] + half[..., None] * x
    vals = drho((E[..., None] - t * t).astype(F64)).astype(dt)
    g = np.sum(2.0 * np.sum(vals * w, axis=-1) * half, axis=-1)
    gs = CubicSpline(psi.astype(F64), g.astype(F64), bc_type="not-a-knot")
    return (gs(psi.astype(F64), 1) / (math.sqrt(8.0) * math.pi**2)).astype(dt)


def df_in_radial_order(fields, key, dt=F64):
    """The DF of the component ``key`` at the grid radii."""
    psi = -fields["gravitational_potential"][::-1]
    return eddington(psi, fields[key][::-1], dt)[::-1]


# ------------------------------------------------------------ speed tables
def speed_fractions(psi, f_nodes, row_psi, n_s, n_q, dt=F64):
    """(rows, n_q): at each row's psi, the speed fraction s = v / v_esc at
    the quantiles m / (n_q - 1) of the distribution s^2 f(psi (1 - s^2)) on
    [0, 1], with f a cubic spline through the DF's nodes (clamped at 0),
    its CDF the trapezoid rule on ``n_s`` uniform nodes, ties broken by
    1e-7 per node, and inverted linearly between nodes."""
    f_spl = CubicSpline(np.asarray(psi, F64), np.asarray(f_nodes, F64),
                        bc_type="not-a-knot")
    s = np.linspace(0.0, 1.0, n_s).astype(dt)
    E = np.asarray(row_psi, dt)[:, None] * (1.0 - s * s)
    pdf = s * s * np.maximum(f_spl(E.astype(F64)), 0.0).astype(dt)
    inc = 0.5 * (pdf[:, 1:] + pdf[:, :-1]) * (s[1] - s[0])
    cdf = np.concatenate([np.zeros((len(E), 1), dt), np.cumsum(inc, axis=1)],
                         axis=1)
    cdf = cdf / cdf[:, -1:] + np.arange(n_s, dtype=dt) * dt(1e-7)
    cdf = cdf / cdf[:, -1:]
    q = (np.arange(n_q) / (n_q - 1)).astype(dt)
    return np.stack([np.interp(q, c, s) for c in cdf]).astype(dt)
