"""Eddington-inversion distribution functions and inverse speed-CDF tables.

* :func:`compute_df`: the ergodic DF from the closed-form Abel integral of
  the density spline's derivative (no quadrature).
* :func:`speed_inverse_cdf_table`: for each row energy psi, the speed
  fraction s = v / sqrt(2 psi) at uniform quantiles of the CDF
  C(s) ∝ int_0^s u^2 f(psi (1 - u^2)) du.  The inversion runs through
  kernel K1 (:mod:`.ops.cdf_inverse`), one launch for every halo and row.

All functions work along the last axis with leading batch axes (one per
halo).
"""

from __future__ import annotations

import math

import torch

from .core.config import cgparams
from .core.grid import linspace
from .core.interp import cubic_spline, spline_eval, spline_eval_uniform
from .ops.cdf_inverse import invert_cdf_rows

__all__ = ["compute_df", "speed_cdf_rows", "speed_inverse_cdf_table",
           "speed_table_defaults"]


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
    every leading index is inverted by one launch of kernel K1."""
    cdf = speed_cdf_rows(ee, f_vals, n_s=n_s, table_dtype=table_dtype,
                         row_ee=row_ee, nf1=nf1, nf2=nf2)
    lead = cdf.shape[:-1]
    s_inv = invert_cdf_rows(
        cdf.to(torch.float32).reshape(-1, n_s).contiguous(), n_q=n_q)
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
