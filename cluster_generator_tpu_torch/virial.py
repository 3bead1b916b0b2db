"""Eddington-inversion distribution functions and inverse speed-CDF tables.

* :func:`compute_df`: the ergodic DF from the closed-form Abel integral of
  the density spline's derivative (no quadrature).
* :func:`om_extended_df` / :func:`compute_df_truncated`: the same inversion
  with a power-law continuation of the density below the grid's lowest
  binding energy, for Osipkov-Merritt augmented densities;
  :func:`check_virial_density` reconstructs the density from f(E) in
  closed form.
* :func:`speed_inverse_cdf_table`: for each row energy psi, the speed
  fraction s = v / sqrt(2 psi) at uniform quantiles of the CDF
  C(s) ∝ int_0^s u^2 f(psi (1 - u^2)) du.  The inversion runs through
  kernel K1 (:mod:`.ops.cdf_inverse`), one launch for every halo and row.
* :func:`build_joint_speed_pairs` / :func:`sample_speeds_joint`: that table
  folded onto radius-quantile nodes as absolute speeds, and the speed draw
  from it; :func:`sample_speeds`: the bilinear draw from the table itself.
* :class:`VirialEquilibrium`: one collisionless component of a
  :class:`~.model.cluster_model.ClusterModel`, with its DF, its virial
  check and its cached speed tables, all on the model's device.

The functions work along the last axis with leading batch axes (one per
halo); the class holds one model.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .core.config import cgparams
from .core.draws import uniform
from .core.grid import linspace
from .core.interp import (_gather, bracket_indices, cubic_spline,
                          interp_monotone, spline_eval, spline_eval_uniform)
from .core.logging import mylog
from .ops.cdf_inverse import invert_cdf_rows

__all__ = ["VirialEquilibrium", "sample_speeds", "compute_df", "om_extended_df", "compute_df_truncated",
           "check_virial_density", "speed_cdf_rows",
           "speed_inverse_cdf_table", "speed_table_defaults",
           "build_joint_speed_pairs", "sample_speeds_joint"]


def speed_table_defaults():
    """Speed-table builder arguments from ``cgparams['numerical']`` (the
    same knobs, and defaults, as the JAX package)."""
    num = cgparams["numerical"]
    return {
        "n_s": int(num["velocity_table_speeds"]),
        "n_q": int(num["velocity_table_quantiles"]),
        "table_dtype": (torch.float32 if num["velocity_table_float32"]
                        else None),
        "nf1": int(num.get("df_node_grid_body", 4096)),
        "nf2": int(num.get("df_node_grid_top", 4096)),
    }


def _safe_sqrt(x):
    """sqrt clamped at 0."""
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def _abel_g_exact(sp, ee):
    """g(E_i) = int_0^{E_i} rho'(psi)/sqrt(E_i - psi) dpsi, exactly.

    rho'(psi) on spline interval k is b_k + 2 c_k tau + 3 d_k tau^2
    (tau = psi - x_k), so with u = sqrt(E - psi) each interval contributes

        G(u) = 2 (k0 u + k2 u^3/3 + k4 u^5/5),   evaluated lo->hi,
        k0 = b + 2cA + 3dA^2,  k2 = -(2c + 6dA),  k4 = 3d,  A = E - x_k.

    The region psi in [0, x_0) uses interval 0's polynomial extrapolated.
    Works on ``(..., N)`` with an ``(..., N, N)`` temporary per batch entry.
    """
    x = sp.x
    zero = torch.zeros_like(x[..., :1])
    lo = torch.cat([zero, x[..., :-1]], dim=-1)[..., None, :]
    hi = torch.cat([x[..., :1], x[..., 1:]], dim=-1)[..., None, :]
    xk = torch.cat([x[..., :1], x[..., :-1]], dim=-1)[..., None, :]
    b = torch.cat([sp.b[..., :1], sp.b], dim=-1)[..., None, :]
    c = torch.cat([sp.c[..., :1], sp.c], dim=-1)[..., None, :]
    d = torch.cat([sp.d[..., :1], sp.d], dim=-1)[..., None, :]

    E = ee[..., :, None]
    u_lo = _safe_sqrt(E - torch.minimum(lo, E))
    u_hi = _safe_sqrt(E - torch.minimum(hi, E))
    A = E - xk
    k0 = b + 2.0 * c * A + 3.0 * d * A * A
    k2 = -(2.0 * c + 6.0 * d * A)
    k4 = 3.0 * d

    def G(u):
        u2 = u * u
        return 2.0 * u * (k0 + u2 * (k2 / 3.0 + u2 * (k4 / 5.0)))

    return torch.sum(G(u_lo) - G(u_hi), dim=-1)


def compute_df(ee: torch.Tensor, pden: torch.Tensor):
    """Eddington inversion on an ascending relative-potential grid.

    ``ee``: (..., N) ascending psi = -Phi (the reversed radial grid);
    ``pden``: (..., N) particle density on the same grid.  Returns f(E) at
    E = ee in Msun Myr^3 / kpc^6.
    """
    dens_sp = cubic_spline(ee, pden)
    g = _abel_g_exact(dens_sp, ee)
    g_sp = cubic_spline(ee, g)
    return spline_eval(g_sp, ee, nu=1) / (math.sqrt(8.0) * math.pi**2)


def om_extended_df(ee, pden, n_ext: int = 192, factor: float = 256.0):
    """Eddington inversion with a power-law continuation of the density
    BELOW the grid's lowest binding energy; returns the extended grid
    ``(ee_ext, f_ext)``, each (..., n_ext + N).

    :func:`compute_df` models rho(psi) on [0, ee[0]) by the boundary
    spline polynomial.  For a density with a non-zero slope at the
    truncation (the Osipkov-Merritt augmented rho_Q = (1 + r^2/r_a^2) rho)
    that cubic is a poor model.  This variant prepends ``n_ext`` log-spaced
    knots on [ee[0]/factor, ee[0]) carrying rho(psi) = rho(ee[0])
    (psi/ee[0])^m, m the boundary log-log slope from the first two points,
    and inverts on the extended grid.  Consumers spline f over ``ee_ext``:
    the speed tables evaluate f at E = psi (1 - s^2) down to E = 0, below
    ee[0] for every row near r_max, where f may diverge as E^(m - 3/2).
    """
    e0, p0 = ee[..., :1], pden[..., :1]
    mslope = ((torch.log(pden[..., 1:2]) - torch.log(p0))
              / (torch.log(ee[..., 1:2]) - torch.log(e0)))
    lin = linspace(-math.log(factor), 0.0, n_ext + 1, dtype=ee.dtype,
                   device=ee.device)[:-1]
    psi_ext = e0 * torch.exp(lin)
    rho_ext = p0 * (psi_ext / e0) ** mslope
    ee_ext = torch.cat([psi_ext, ee], dim=-1)
    return ee_ext, compute_df(ee_ext, torch.cat([rho_ext, pden], dim=-1))


def compute_df_truncated(ee, pden, n_ext: int = 192, factor: float = 256.0):
    """f of :func:`om_extended_df` at the ORIGINAL knots (fixed grid
    length).  Table builders and the virial check use the extended grid."""
    return om_extended_df(ee, pden, n_ext=n_ext, factor=factor)[1][..., n_ext:]


def check_virial_density(ee, f_vals):
    """rho(psi_i) = 4 pi int_0^psi_i f(E) sqrt(2 (psi_i - E)) dE, exactly.

    With E = psi - u^2 the integrand is a polynomial in u on every spline
    interval of f (cubic in tau = E - x_k = A - u^2, A = psi - x_k), so
    each interval has a closed-form antiderivative.  ``(..., N)`` in and
    out, with an ``(..., N, N)`` temporary.
    """
    sp = cubic_spline(ee, f_vals)
    x = sp.x
    zero = torch.zeros_like(x[..., :1])
    lo = torch.cat([zero, x[..., :-1]], dim=-1)[..., None, :]
    hi = x[..., None, :]
    xk = torch.cat([x[..., :1], x[..., :-1]], dim=-1)[..., None, :]
    a = torch.cat([sp.a[..., :1], sp.a], dim=-1)[..., None, :]
    b = torch.cat([sp.b[..., :1], sp.b], dim=-1)[..., None, :]
    c = torch.cat([sp.c[..., :1], sp.c], dim=-1)[..., None, :]
    d = torch.cat([sp.d[..., :1], sp.d], dim=-1)[..., None, :]

    psi = ee[..., :, None]
    # u decreases as E increases: E = lo -> the larger u
    u_at_lo = _safe_sqrt(psi - torch.minimum(lo, psi))
    u_at_hi = _safe_sqrt(psi - torch.minimum(hi, psi))
    A = psi - xk
    m0 = a + A * (b + A * (c + A * d))
    m2 = -(b + A * (2.0 * c + 3.0 * A * d))
    m4 = c + 3.0 * A * d
    m6 = -d

    def F(u):
        u2 = u * u
        return u2 * u * (m0 / 3.0 + u2 * (m2 / 5.0 + u2 * (m4 / 7.0
                                                           + u2 * m6 / 9.0)))

    return (8.0 * math.sqrt(2.0) * math.pi
            * torch.sum(F(u_at_lo) - F(u_at_hi), dim=-1))


def speed_cdf_rows(ee, f_vals, n_s: int = 1024, table_dtype=None,
                   row_ee=None, nf1: int = 4096, nf2: int = 4096):
    """Speed CDF at each row energy: (..., rows, n_s) on the uniform grid
    s_k = k / (n_s - 1), normalised to end at 1 and strictly increasing.

    ``ee``/``f_vals``: (..., N) f(E) spline grid; ``row_ee``: (..., rows)
    row energies (default ``ee``).  ``table_dtype=torch.float32`` evaluates
    f(E) through a node table (the exact float64 spline at NF1 uniform
    nodes over [0, 0.9 e_max) and NF2 over [0.9 e_max, e_max], then one
    lerp per query) and builds the CDF in float32; ``None`` evaluates the
    spline at every query in the input precision.
    """
    f_sp = cubic_spline(ee, f_vals)
    if row_ee is None:
        row_ee = ee
    dev = ee.device
    s = linspace(0.0, 1.0, n_s, device=dev)
    E = row_ee[..., :, None] * (1.0 - (s * s))  # (..., rows, n_s)
    if table_dtype is not None:
        NF1, NF2 = nf1, nf2
        if NF1 < 2 or NF2 < 2:
            raise ValueError(
                f"df node grids need >= 2 nodes per segment (got "
                f"nf1={NF1}, nf2={NF2})")
        fmax = torch.amax(torch.abs(f_vals), dim=-1, keepdim=True)
        e_max = torch.amax(row_ee, dim=-1)
        b = 0.9 * e_max
        step1 = b / NF1
        step2 = (e_max - b) / (NF2 - 1)
        fu = torch.cat([
            spline_eval_uniform(f_sp, torch.zeros_like(b), step1, NF1),
            spline_eval_uniform(f_sp, b, step2, NF2)], dim=-1)
        # scaled into float32 range (f ~ 1e12 in galactic DF units)
        fu = torch.clamp_min(fu / fmax, 0.0).to(table_dtype)
        s = s.to(table_dtype)
        Ef = E.to(table_dtype).reshape(E.shape[:-2] + (-1,))
        bt = b.to(table_dtype)[..., None]
        et = e_max.to(table_dtype)[..., None]
        # segment 1: interval k covers [k, k+1) * b/NF1; its last interval
        # ends at b, the first segment-2 node
        x1 = torch.clamp(Ef / bt * NF1, 0.0, NF1 - 1e-4)
        k1 = torch.clamp_max(x1.to(torch.int64), NF1 - 1)
        w1 = x1 - k1.to(table_dtype)
        x2 = torch.clamp((Ef - bt) / (et - bt) * (NF2 - 1), 0.0,
                         NF2 - 1 - 1e-4)
        k2 = torch.clamp_max(x2.to(torch.int64), NF2 - 2)
        w2 = x2 - k2.to(table_dtype)
        in1 = Ef < bt
        k = torch.where(in1, k1, NF1 + k2)
        w = torch.where(in1, w1, w2)
        f_lo = torch.gather(fu, -1, k)
        f_hi = torch.gather(fu, -1, k + 1)
        f_E = ((1.0 - w) * f_lo + w * f_hi).reshape(E.shape)
        pdf = (s * s) * f_E
        pdf = pdf / torch.clamp_min(torch.amax(pdf, dim=-1, keepdim=True),
                                    1e-30)
    else:
        pdf = (s * s) * torch.clamp_min(spline_eval(f_sp, E), 0.0)
    ds = s[1] - s[0]
    # the trapezoid increments are summed in float64 and rounded once: the
    # card's float32 scan and the CPU's sum in another order differ by
    # ~1e-6 at the top of a row, which a flat CDF stretches to ~1e-4 in s
    inc = 0.5 * (pdf[..., 1:] + pdf[..., :-1]) * ds
    cdf = torch.cat([torch.zeros_like(pdf[..., :1]),
                     torch.cumsum(inc.to(torch.float64),
                                  dim=-1).to(pdf.dtype)], dim=-1)
    total = cdf[..., -1:]
    cdf = cdf / torch.where(total > 0.0, total, torch.ones_like(total))
    # a strictly increasing ramp keeps every bin invertible
    eps_val = 1e-12 if cdf.dtype == torch.float64 else 1e-7
    eps = torch.arange(n_s, dtype=cdf.dtype, device=dev) * eps_val
    cdf = cdf + eps
    return cdf / cdf[..., -1:]


def speed_inverse_cdf_table(ee, f_vals, n_s: int = 1024, n_q: int = 512,
                            table_dtype=None, row_ee=None, nf1: int = 4096,
                            nf2: int = 4096):
    """Tabulated inverse speed-CDF at each row energy: ``s_inv`` (..., rows,
    n_q) float32, ``s_inv[j, m]`` the speed fraction at quantile
    m/(n_q-1) of :func:`speed_cdf_rows` (same arguments).  Every row of
    every leading index is inverted by one launch of kernel K1.

    K1 is a float32 kernel.  With ``table_dtype=None`` (the configuration's
    ``velocity_table_float32: false``) the CDF is built in float64 from the
    spline at every query, rounded once to float32, given the float32
    path's strictly increasing ramp (the float64 ramp of 1e-12 per bin
    does not survive the rounding, and a flat top would put the last
    quantile one bin low) and inverted by K1, so the table is float32
    either way: the option buys the exact f(E) evaluation, not float64
    quantiles (the rounding moves a quantile by at most ~1e-7 / (dC/ds),
    below the table's 1/n_q resolution)."""
    cdf = speed_cdf_rows(ee, f_vals, n_s=n_s, table_dtype=table_dtype,
                         row_ee=row_ee, nf1=nf1, nf2=nf2)
    lead = cdf.shape[:-1]
    if cdf.dtype != torch.float32:
        cdf = cdf.to(torch.float32)
        cdf = cdf + torch.arange(n_s, dtype=cdf.dtype,
                                 device=cdf.device) * 1e-7
        cdf = cdf / cdf[..., -1:]
    s_inv = invert_cdf_rows(cdf.reshape(-1, n_s).contiguous(), n_q=n_q)
    return s_inv.reshape(lead + (n_q,))


def _banded_row_lerp(sd, j, w):
    """Row interpolation ``(1-w) sd[j] + w sd[j+1]`` as a banded-weight
    matmul: W (..., rq, n_rows) holds (1-w, w) at columns (j, j+1), and
    ``W @ sd`` runs in full float32 (TF32 must be off)."""
    n_rows = sd.shape[-2]
    k = torch.arange(n_rows, device=sd.device)
    jj = j[..., :, None]
    ww = w[..., :, None]
    zero = torch.zeros((), dtype=sd.dtype, device=sd.device)
    W = (torch.where(k == jj, 1.0 - ww, zero)
         + torch.where(k == jj + 1, ww, zero)).to(sd.dtype)
    return torch.matmul(W, sd)


def build_joint_speed_pairs(rr, psi_grid, row_ee, s_inv, r_q,
                            dtype=torch.float32, psi_q=None):
    """Joint ABSOLUTE-speed table at radius-quantile nodes: (..., RQ, n_q).

    Folds the (..., n_rows, n_q) inverse speed-fraction table ``s_inv``
    (rows at the ascending energies ``row_ee``) onto the radius-quantile
    nodes ``r_q`` and multiplies by v_esc = sqrt(2 psi) there, so a speed
    draw needs its radius-quantile row and a quantile column and no psi
    lookup.  Entry ``[k, m]`` and its neighbour ``[k, m + 1]`` are the pair
    that the JAX package stores as row ``k (n_q - 1) + m`` of its paired
    table.
    """
    if psi_q is None:
        psi_q = interp_monotone(r_q, rr, psi_grid)
    j = bracket_indices(row_ee, psi_q)
    e0, e1 = _gather(row_ee, j), _gather(row_ee, j + 1)
    w = torch.clamp((psi_q - e0) / (e1 - e0), 0.0, 1.0).to(dtype)
    srow = _banded_row_lerp(s_inv.to(dtype), j, w)
    return srow * torch.sqrt(2.0 * psi_q).to(dtype)[..., None]


def sample_speeds_joint(joint, kq, wq, generator=None, uniforms=None):
    """Speed draw from a joint table (..., RQ, n_q) of
    :func:`build_joint_speed_pairs`.

    ``kq``/``wq``: each particle's radius-quantile index and fractional
    weight, (..., n).  The table row is picked between the two nodes
    bracketing the radius by a Bernoulli draw on ``wq``; the speed is the
    lerp along the quantile axis.  ``uniforms``: ``(u_quantile, u_row)``,
    else two draws from ``generator``.
    """
    dtype = joint.dtype
    n_q = joint.shape[-1]
    if uniforms is None:
        uq = uniform(generator, kq.shape, dtype, joint.device)
        ub = uniform(generator, kq.shape, dtype, joint.device)
    else:
        uq, ub = uniforms
    qm = torch.clamp(uq * (n_q - 1), 0.0, n_q - 1 - 1e-6)
    # integer clamp: in float32 the 1e-6 margin is below the ulp at
    # n_q - 1, so qm can round to n_q - 1 and m + 1 would spill into the
    # next radius row of the flattened table
    m = torch.clamp_max(qm.to(torch.int64), n_q - 2)
    wm = qm - m.to(dtype)
    k_row = kq + (ub < wq.to(dtype)).to(torch.int64)
    flat = joint.reshape(joint.shape[:-2] + (-1,))
    idx = k_row * n_q + m
    return ((1.0 - wm) * _gather(flat, idx) + wm * _gather(flat, idx + 1))


def sample_speeds(radius, psi_p, ee, s_inv, generator=None, uniforms=None):
    """Bilinear inverse-CDF speed sampling for every particle, straight
    from the table (no joint fold).

    ``radius``/``psi_p``: (n,) particle radii and relative potentials;
    ``ee``: (N,) ascending psi grid; ``s_inv``: (N, n_q) inverse-CDF table.
    ``uniforms``: the (n,) quantile draws in the table's dtype, else one
    draw from ``generator``.  Returns speeds in kpc/Myr."""
    n, n_q = s_inv.shape
    dtype = s_inv.dtype
    u = (uniform(generator, radius.shape, dtype, s_inv.device)
         if uniforms is None else uniforms)
    j = torch.clamp(torch.searchsorted(ee.contiguous(), psi_p.contiguous(),
                                       right=True) - 1, 0, n - 2)
    e0, e1 = ee[j], ee[j + 1]
    wj = torch.clamp((psi_p - e0) / (e1 - e0), 0.0, 1.0).to(dtype)
    qpos = u * (n_q - 1)
    m = torch.clamp(qpos.to(torch.int64), 0, n_q - 2)
    wm = qpos - m.to(dtype)
    flat = s_inv.reshape(-1)
    lo = j * n_q + m
    hi = lo + n_q
    s = ((1.0 - wj) * ((1.0 - wm) * flat[lo] + wm * flat[lo + 1])
         + wj * ((1.0 - wm) * flat[hi] + wm * flat[hi + 1]))
    return s * torch.sqrt(2.0 * psi_p)


class VirialEquilibrium:
    """Virial equilibrium model of one collisionless component
    (``"dark_matter"`` or ``"stellar"``) of a model.

    ``df``: a DF on the model's radial grid to resume from (as read from
    a model file), else it is computed.  ``r_a``: Osipkov-Merritt
    anisotropy radius (kpc).  ``None`` is the ergodic, isotropic model.  A
    finite ``r_a`` builds the OM distribution function f(Q),
    Q = E - L^2/(2 r_a^2), radially anisotropic with
    beta(r) = r^2 / (r^2 + r_a^2).  The OM inversion is the same Abel
    integral with the augmented density rho_Q(r) = (1 + r^2/r_a^2) rho(r)
    in place of rho, so every table and draw path is shared; only the
    velocity directions change at sample time.

    The DF and the cached speed tables are float64 and float32 tensors on
    the model's device.  The inverse speed-CDF table is kept per
    ``n_rows`` (it does not depend on ``r_max``); what a draw folds it
    into for one ``r_max`` is kept beside it, one entry at a time."""

    def __init__(self, model, ptype: str = "dark_matter", df=None,
                 r_a=None):
        self.num_elements = model.num_elements
        self.ptype = ptype
        self.model = model
        self.r_a = None if r_a is None else float(r_a)
        if self.r_a is not None and self.r_a <= 0:
            raise ValueError(f"r_a must be positive, got {r_a}")
        self._ext = None
        if df is None:
            self._generate_df()
        else:
            radius = model["radius"]
            self.df = torch.as_tensor(
                df if isinstance(df, torch.Tensor) else np.array(df),
                dtype=torch.float64, device=radius.device)
        self._s_inv = {}
        # this species' draw tables (sampling._draw_tables)
        self._draw_tables = None

    # ------------------------------------------------------------ DF build
    @property
    def ee(self):
        """Ascending relative potential grid."""
        return -torch.flip(self.model["gravitational_potential"], (0,))

    @property
    def ff(self):
        """f(E) on the ascending ``ee`` grid."""
        return torch.flip(self.df, (0,))

    def _augmented_density(self):
        """rho (isotropic) or the OM rho_Q = (1 + r^2/r_a^2) rho, in
        radial ordering."""
        pden = self.model[f"{self.ptype}_density"]
        if self.r_a is None:
            return pden
        return pden * (1.0 + (self.model["radius"] / self.r_a) ** 2)

    @property
    def _df_grid(self):
        """``(ee_spline, f_spline)``: the grid that consumers spline f(E)
        over.  Ergodic: the model grid.  OM: the power-law-extended grid
        (speed tables and the virial reconstruction query E below
        ``ee[0]``), rebuilt lazily from the density when the DF was
        resumed from a file."""
        if self.r_a is None:
            return self.ee, self.ff
        if self._ext is None:
            self._ext = om_extended_df(
                self.ee, torch.flip(self._augmented_density(), (0,)))
        return self._ext

    def _generate_df(self):
        mylog.info("Computing the %s particle DF%s.", self.ptype,
                   "" if self.r_a is None
                   else f" (Osipkov-Merritt, r_a={self.r_a:g} kpc)")
        if self.r_a is None:
            f = compute_df(self.ee,
                           torch.flip(self._augmented_density(), (0,)))
        else:
            # OM: rho_Q's non-zero boundary slope needs the power-law
            # continuation below the grid
            self._ext = None
            ee_ext, f_ext = self._df_grid
            f = f_ext[ee_ext.shape[0] - self.num_elements:]
        # stored reversed (radially increasing)
        self.df = torch.flip(f, (0,))
        if self.r_a is not None:
            fmin, fmax = float(self.df.min()), float(self.df.max())
            if fmin < -1e-12 * fmax:
                mylog.warning(
                    "The Osipkov-Merritt f(Q) for r_a=%g goes negative "
                    "(min %g): the model cannot support this much radial "
                    "anisotropy; increase r_a.", self.r_a, fmin)

    def check_virial(self):
        """``(rho_from_df, relative error)`` on the radial grid.

        For an OM model the isotropic-form reconstruction integral returns
        the AUGMENTED density, so the residual is taken against rho_Q
        (reconstructed on the extended grid, reported at the model
        knots)."""
        ee_sp, ff_sp = self._df_grid
        rho_full = check_virial_density(ee_sp, ff_sp)
        rho = torch.flip(rho_full[rho_full.shape[0] - self.num_elements:],
                         (0,))
        pden = self._augmented_density()
        chk = (rho - pden) / pden
        mylog.info("The maximum relative deviation of this profile from "
                   "virial equilibrium is %g", float(chk.abs().max()))
        return rho, chk

    # ----------------------------------------------------------- sampling
    def _speed_table_inputs(self, n_rows: int = 256):
        """Arguments of :func:`speed_inverse_cdf_table` for this
        component: rows on an ``n_rows``-point subsample of the MODEL's
        energy grid, f(E) splined over :attr:`_df_grid` (OM: the extended
        grid, since rows near r_max query E below ``ee[0]``), resolutions
        from the configuration."""
        ee = self.ee
        n = ee.shape[0]
        idx = np.unique(np.round(
            np.linspace(0, n - 1, min(n_rows, n))).astype(int))
        ee_sp, ff_sp = self._df_grid
        return dict(speed_table_defaults(), ee=ee_sp, f_vals=ff_sp,
                    row_ee=ee[torch.as_tensor(idx, device=ee.device)])

    def _speed_table(self, n_rows: int = 256):
        """``(row_ee, s_inv)``: the inverse speed-CDF table on an
        ``n_rows``-point subsample of the energy grid (the f(E) spline
        still uses every grid point; rows are interpolated at sample
        time).  Built once per ``n_rows`` by one launch of kernel K1 and
        cached."""
        if n_rows not in self._s_inv:
            kw = self._speed_table_inputs(n_rows)
            self._s_inv[n_rows] = (kw["row_ee"],
                                   speed_inverse_cdf_table(**kw))
        return self._s_inv[n_rows]

    def generate_particles(self, num_particles, r_max=None, sub_sample=1,
                           compute_potential=False, prng=None,
                           uniforms=None):
        """Sample positions (inverse CDF of the mass profile) and speeds
        (inverse CDF of the Eddington DF), with isotropic angles; see
        :func:`~.sampling.generate_collisionless_particles`."""
        from .sampling import generate_collisionless_particles

        return generate_collisionless_particles(
            self, num_particles, r_max=r_max, sub_sample=sub_sample,
            compute_potential=compute_potential, prng=prng,
            uniforms=uniforms)
