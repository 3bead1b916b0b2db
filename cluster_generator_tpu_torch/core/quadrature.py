"""Fixed-order Gauss-Legendre quadrature on (batched) radial grids.

Every cumulative integral is one batched evaluation: each interval of the
log grid gets a GL panel, the integrand is evaluated at all panel nodes at
once, and panel sums plus ``torch.cumsum`` give the integral at every grid
point.  Grids have shape ``(..., n)``; the leading axes (one per halo) are
carried through, so one call serves every halo.  Integrands take radii of
shape ``(..., n-1, K)`` (or ``(..., K)`` for the central panel and the
tail) and must broadcast over the same leading axes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["gauss_legendre", "cumulative_integral", "integrate_mass",
           "integrate_from", "integrate_tail_to_inf", "cumtrapz"]

_DEFAULT_ORDER = 16


def gauss_legendre(order: int, like: torch.Tensor):
    """GL nodes/weights on [-1, 1] as float64 tensors on ``like``'s device."""
    x, w = np.polynomial.legendre.leggauss(order)
    return (torch.as_tensor(x, dtype=torch.float64, device=like.device),
            torch.as_tensor(w, dtype=torch.float64, device=like.device))


def _panel_nodes(rr: torch.Tensor, order: int):
    """GL nodes/weights of every interval of ``rr``: shape (..., n-1, order)."""
    x, w = gauss_legendre(order, rr)
    a = rr[..., :-1, None]
    b = rr[..., 1:, None]
    half = 0.5 * (b - a)
    nodes = a + half * (x + 1.0)
    weights = half * w
    return nodes, weights


def cumulative_integral(fn, rr, order: int = _DEFAULT_ORDER,
                        from_zero: bool = True):
    """F(r_i) = int_0^{r_i} fn(r) dr on grid ``rr`` (..., n).

    The [0, r_0] panel substitutes r = u^2, which turns the r^p cusps of
    the mass integrands into smooth u^{2p+1}.  ``from_zero=False`` starts
    at ``rr[..., 0]``.
    """
    nodes, weights = _panel_nodes(rr, order)
    panel = torch.sum(fn(nodes) * weights, dim=-1)
    csum = torch.cat([torch.zeros_like(panel[..., :1]),
                      torch.cumsum(panel, dim=-1)], dim=-1)
    if from_zero:
        x, w = gauss_legendre(max(order, 32), rr)
        u_max = torch.sqrt(rr[..., :1])
        u = 0.5 * u_max * (x + 1.0)
        wu = 0.5 * u_max * w
        first = torch.sum(fn(u * u) * 2.0 * u * wu, dim=-1, keepdim=True)
        csum = csum + first
    return csum


def integrate_mass(density_fn, rr, order: int = _DEFAULT_ORDER):
    """m(r_i) = 4 pi int_0^{r_i} rho(r) r^2 dr."""
    def f(r):
        return density_fn(r) * r * r

    return 4.0 * math.pi * cumulative_integral(f, rr, order=order,
                                               from_zero=True)


def integrate_from(fn, rr, order: int = _DEFAULT_ORDER):
    """I(r_i) = int_{r_i}^{r_max} fn(r) dr, as reversed cumulative panel
    sums; I(r_max) = 0."""
    nodes, weights = _panel_nodes(rr, order)
    panel = torch.sum(fn(nodes) * weights, dim=-1)
    rev = torch.flip(torch.cumsum(torch.flip(panel, (-1,)), dim=-1), (-1,))
    return torch.cat([rev, torch.zeros_like(rev[..., :1])], dim=-1)


def integrate_tail_to_inf(fn, r_max, order: int = 64):
    """int_{r_max}^inf fn(r) dr via r = r_max / s^2, s in (0, 1].

    ``r_max`` has the batch shape (or is 0-d); ``fn`` gets radii of shape
    ``r_max.shape + (order,)``.  Smooth for every power-law tail r^-p with
    p >= 1.5.
    """
    r_max = torch.as_tensor(r_max, dtype=torch.float64)
    x, w = gauss_legendre(order, r_max)
    s = 0.5 * (x + 1.0)
    ws = 0.5 * w
    rm = r_max[..., None]
    r = rm / (s * s)
    return torch.sum(fn(r) * 2.0 * rm / (s * s * s) * ws, dim=-1)


def cumtrapz(y, x):
    """Cumulative trapezoid along the last axis, with initial 0."""
    dx = x[..., 1:] - x[..., :-1]
    incr = 0.5 * (y[..., 1:] + y[..., :-1]) * dx
    return torch.cat([torch.zeros_like(incr[..., :1]),
                      torch.cumsum(incr, dim=-1)], dim=-1)
