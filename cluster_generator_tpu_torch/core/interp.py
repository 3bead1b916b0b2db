"""Interpolation primitives: linear interpolation and C2 cubic splines.

Every function works along the LAST axis and carries any leading axes
(one per halo) through, so one call serves a whole batch of grids:
``cubic_spline(x, y)`` with ``x``, ``y`` of shape ``(..., n)`` returns
per-interval coefficients of shape ``(..., n-1)``.  The spline is the
not-a-knot C2 spline (FITPACK's interpolating spline), solved by parallel
cyclic reduction as in ``cluster_generator_tpu.core.interp``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

__all__ = ["CubicSpline", "cubic_spline", "spline_eval",
           "bracket_for_spline", "spline_eval_at", "spline_eval_uniform",
           "spline_eval_loguniform", "interp", "bracket_indices",
           "interp_monotone", "loguniform_lerp", "is_loguniform"]


class CubicSpline(NamedTuple):
    """Per-interval polynomial y = a + b t + c t^2 + d t^3, t = x - x_i."""

    x: torch.Tensor  # knots, (..., n)
    a: torch.Tensor  # (..., n-1)
    b: torch.Tensor
    c: torch.Tensor
    d: torch.Tensor


def _pcr(dl, dm, du, rhs):
    """Tridiagonal solve along the last axis by parallel cyclic reduction:
    ceil(log2 n) elimination rounds, each doubling the coupling distance
    (out-of-range neighbours enter as identity rows)."""
    n = dm.shape[-1]
    zero = torch.zeros_like(dm[..., :1])
    a = torch.cat([zero, dl], dim=-1)   # row i, col i-s
    b = dm
    c = torch.cat([du, zero], dim=-1)   # row i, col i+s
    d = rhs
    s = 1
    for _ in range(int(math.ceil(math.log2(max(int(n), 2))))):
        def dn(x, fill):
            pad = torch.full(x.shape[:-1] + (s,), fill, dtype=x.dtype,
                             device=x.device)
            return torch.cat([pad, x[..., :-s]], dim=-1)

        def up(x, fill):
            pad = torch.full(x.shape[:-1] + (s,), fill, dtype=x.dtype,
                             device=x.device)
            return torch.cat([x[..., s:], pad], dim=-1)

        alpha = -a / dn(b, 1.0)
        gamma = -c / up(b, 1.0)
        b = b + alpha * dn(c, 0.0) + gamma * up(a, 0.0)
        d = d + alpha * dn(d, 0.0) + gamma * up(d, 0.0)
        a, c = alpha * dn(a, 0.0), gamma * up(c, 0.0)
        s *= 2
    return d / b


def cubic_spline(x: torch.Tensor, y: torch.Tensor) -> CubicSpline:
    """Not-a-knot C2 cubic spline through (x, y) along the last axis; x
    strictly increasing.  The not-a-knot conditions are folded into rows 1
    and n-2 so the system stays tridiagonal."""
    n = x.shape[-1]
    h = x[..., 1:] - x[..., :-1]  # (..., n-1)
    slope = (y[..., 1:] - y[..., :-1]) / h
    h0, h1 = h[..., 0], h[..., 1]
    hn2, hn1 = h[..., -2], h[..., -1]

    # interior rows i=1..n-2:
    #   h[i-1] s_{i-1} + 2(h[i-1]+h[i]) s_i + h[i] s_{i+1} = 6 (slope[i] - slope[i-1])
    dm = torch.zeros_like(x)
    dl = torch.zeros_like(h)  # sub-diagonal (row i, col i-1)
    du = torch.zeros_like(h)  # super-diagonal (row i, col i+1)
    rhs = torch.zeros_like(x)
    dm[..., 1:-1] = 2.0 * (h[..., :-1] + h[..., 1:])
    dl[..., : n - 2] = h[..., :-1]
    du[..., 1:] = h[..., 1:]
    rhs[..., 1:-1] = 6.0 * (slope[..., 1:] - slope[..., :-1])

    # row 1 with s0 = ((h0+h1) s1 - h0 s2) / h1 substituted
    dm[..., 1] = h0 * (h0 + h1) / h1 + 2.0 * (h0 + h1)
    du[..., 1] = h1 - h0 * h0 / h1
    # row n-2 with s_{n-1} = ((h_{n-2}+h_{n-1}) s_{n-2} - h_{n-1} s_{n-3}) / h_{n-2}
    dm[..., -2] = 2.0 * (hn2 + hn1) + hn1 * (hn2 + hn1) / hn2
    dl[..., n - 3] = hn2 - hn1 * hn1 / hn2

    # decoupled boundary placeholders (s0, s_{n-1} recovered afterwards)
    dm[..., 0] = 1.0
    du[..., 0] = 0.0
    dm[..., -1] = 1.0
    dl[..., -1] = 0.0
    dl[..., 0] = 0.0
    du[..., n - 2] = 0.0

    sigma = _pcr(dl, dm, du, rhs)
    s0 = ((h0 + h1) * sigma[..., 1] - h0 * sigma[..., 2]) / h1
    sn = ((hn2 + hn1) * sigma[..., -2] - hn1 * sigma[..., -3]) / hn2
    sigma = torch.cat([s0[..., None], sigma[..., 1:-1], sn[..., None]],
                      dim=-1)

    a = y[..., :-1]
    b = slope - h * (2.0 * sigma[..., :-1] + sigma[..., 1:]) / 6.0
    c = sigma[..., :-1] / 2.0
    d = (sigma[..., 1:] - sigma[..., :-1]) / (6.0 * h)
    return CubicSpline(x=x, a=a, b=b, c=c, d=d)


def _batched_queries(x, xq):
    """Queries as ``x.shape[:-1] + (m,)`` for a batched searchsorted, and
    the shape to restore afterwards."""
    xq = torch.as_tensor(xq, dtype=x.dtype, device=x.device)
    shape = xq.shape
    batch = x.shape[:-1]
    if not batch:
        return xq.reshape(-1), shape
    return xq.reshape(batch + (-1,)), shape


def _gather(t, idx):
    return torch.gather(t, -1, idx) if t.ndim > 1 else t[idx]


def spline_eval(sp: CubicSpline, xq, nu: int = 0):
    """Spline (or its nu-th derivative, nu <= 2) at ``xq``.  ``xq`` has the
    spline's batch shape followed by any query shape.  Out-of-range
    queries extrapolate with the boundary polynomial."""
    q, shape = _batched_queries(sp.x, xq)
    idx = torch.clamp(torch.searchsorted(sp.x.contiguous(), q.contiguous(),
                                         right=True) - 1,
                      0, sp.x.shape[-1] - 2)
    t = q - _gather(sp.x, idx)
    a, b = _gather(sp.a, idx), _gather(sp.b, idx)
    c, d = _gather(sp.c, idx), _gather(sp.d, idx)
    if nu == 0:
        out = a + t * (b + t * (c + t * d))
    elif nu == 1:
        out = b + t * (2.0 * c + 3.0 * t * d)
    elif nu == 2:
        out = 2.0 * c + 6.0 * t * d
    else:
        raise ValueError("nu must be 0, 1 or 2")
    return out.reshape(shape)


def bracket_for_spline(x, xq):
    """One bracketing search over the knots ``x`` for the queries ``xq``,
    to be shared by several splines on the same knots through
    :func:`spline_eval_at`."""
    q, shape = _batched_queries(x, xq)
    idx = torch.clamp(torch.searchsorted(x.contiguous(), q.contiguous(),
                                         right=True) - 1,
                      0, x.shape[-1] - 2)
    return idx.reshape(shape)


def spline_eval_at(sp: CubicSpline, xq, idx):
    """:func:`spline_eval` with the bracket indices of
    :func:`bracket_for_spline` on the same knots; the same values."""
    q, shape = _batched_queries(sp.x, xq)
    idx = idx.reshape(q.shape)
    t = q - _gather(sp.x, idx)
    out = _gather(sp.a, idx) + t * (_gather(sp.b, idx) + t * (
        _gather(sp.c, idx) + t * _gather(sp.d, idx)))
    return out.reshape(shape)


def spline_eval_loguniform(sp: CubicSpline, xq):
    """A spline whose knots are exactly log-uniform, at queries inside the
    knot range: the bracketing interval is computed from ``log(xq)``, not
    searched.  Queries are clamped to the knot range (boundary value, no
    extrapolation).  A query that sits on a knot may take either
    neighbouring interval, depending on the device's ``log``; the spline
    is continuous, so the values agree to roundoff."""
    x = sp.x
    n = x.shape[-1]
    q, shape = _batched_queries(x, xq)
    lg0 = torch.log(x[..., :1])
    dlg = (torch.log(x[..., -1:]) - lg0) / (n - 1)
    t = torch.clamp((torch.log(q) - lg0) / dlg, 0.0, n - 1 - 1e-6)
    j = torch.clamp_max(t.to(torch.int64), n - 2)
    u = torch.minimum(torch.maximum(q, x[..., :1]), x[..., -1:]) - _gather(x, j)
    out = _gather(sp.a, j) + u * (_gather(sp.b, j) + u * (
        _gather(sp.c, j) + u * _gather(sp.d, j)))
    return out.reshape(shape)


def spline_eval_uniform(sp: CubicSpline, lo, step, n: int):
    """The spline at the uniform nodes ``lo + i*step, i in [0, n)``, with
    no per-node search: one count per breakpoint is scattered onto the
    node grid at its computed index and prefix-summed, so
    ``idx_i = (# x_k <= node_i) - 1``.  ``lo``/``step`` have the spline's
    batch shape.  Bit-identical to :func:`spline_eval` at the same nodes,
    including the boundary-polynomial extrapolation."""
    x = sp.x
    lo = torch.as_tensor(lo, dtype=x.dtype, device=x.device)[..., None]
    step = torch.as_tensor(step, dtype=x.dtype, device=x.device)[..., None]
    # first node index at-or-above x_k: node_i >= x_k  <=>  i >= (x_k-lo)/step
    pos = torch.clamp(torch.ceil((x - lo) / step).to(torch.int64), 0, n)
    cnt = torch.zeros(x.shape[:-1] + (n + 1,), dtype=torch.int64,
                      device=x.device)
    cnt.scatter_add_(-1, pos, torch.ones_like(pos))
    count = torch.cumsum(cnt, dim=-1)[..., :n]  # breakpoints <= node_i
    idx = torch.clamp(count - 1, 0, x.shape[-1] - 2)
    t = (lo + step * torch.arange(n, dtype=x.dtype, device=x.device)
         - _gather(x, idx))
    return (_gather(sp.a, idx)
            + t * (_gather(sp.b, idx)
                   + t * (_gather(sp.c, idx) + t * _gather(sp.d, idx))))


def interp(xq, x, y, left=None, right=None):
    """``np.interp`` along the last axis (batched over leading axes), with
    ``jnp.interp``'s arithmetic; queries outside the grid take ``left`` /
    ``right`` (default: the end values)."""
    q, shape = _batched_queries(x, xq)
    n = x.shape[-1]
    i = torch.clamp(torch.searchsorted(x.contiguous(), q.contiguous(),
                                       right=True), 1, n - 1)
    x0, x1 = _gather(x, i - 1), _gather(x, i)
    y0, y1 = _gather(y, i - 1), _gather(y, i)
    dx = x1 - x0
    # np.spacing(finfo.eps) in x's dtype: only exact-duplicate knots
    eps = torch.tensor(torch.finfo(x.dtype).eps, dtype=x.dtype)
    spacing = float(torch.nextafter(eps, torch.tensor(math.inf,
                                                      dtype=x.dtype)) - eps)
    dx0 = torch.abs(dx) <= spacing
    f = torch.where(dx0, y0,
                    y0 + ((q - x0) / torch.where(dx0, torch.ones_like(dx),
                                                 dx)) * (y1 - y0))
    lo = y[..., :1] if left is None else torch.as_tensor(
        left, dtype=y.dtype, device=y.device)
    hi = y[..., -1:] if right is None else torch.as_tensor(
        right, dtype=y.dtype, device=y.device)
    f = torch.where(q < x[..., :1], lo, f)
    f = torch.where(q > x[..., -1:], hi, f)
    return f.reshape(shape)


def bracket_indices(grid, queries):
    """Bracketing interval of each query in an ascending ``grid`` (last
    axis): ``grid[j] <= q < grid[j+1]``, i.e. ``searchsorted(side='right')
    - 1`` clipped to valid intervals, by one comparison matrix."""
    j = torch.sum(grid[..., None, :] <= queries[..., :, None], dim=-1) - 1
    return torch.clamp(j, 0, grid.shape[-1] - 2)


def interp_monotone(xq, x, y):
    """``interp`` on an ascending grid via :func:`bracket_indices`, for
    table-sized query counts.  Flat intervals take the left value."""
    j = bracket_indices(x, xq)
    x0, x1 = _gather(x, j), _gather(x, j + 1)
    dx = x1 - x0
    pos = dx > 0
    w = torch.where(pos, (xq - x0) / torch.where(pos, dx, torch.ones_like(dx)),
                    torch.zeros_like(dx))
    w = torch.clamp(w, 0.0, 1.0)
    return (1.0 - w) * _gather(y, j) + w * _gather(y, j + 1)


def loguniform_lerp(xq, x, y):
    """``y`` at ``xq`` on an exactly log-uniform ascending grid ``x`` (last
    axis, leading batch axes shared with ``xq``): the bracketing interval
    is computed from ``log(xq)``, not searched, and the lerp weight is
    linear in x (``np.interp`` semantics).  Works in ``y``'s dtype.  This
    is how a field is evaluated at DRAWN radii; queries are clamped to the
    grid."""
    n = x.shape[-1]
    dt = y.dtype
    x = x.to(dt)
    xq = xq.to(dt)
    lg0 = torch.log(x[..., :1])
    dlg = (torch.log(x[..., -1:]) - lg0) / (n - 1)
    t = torch.clamp((torch.log(xq) - lg0) / dlg, 0.0, n - 1 - 1e-6)
    # integer clamp too: the 1e-6 margin is below the float32 ulp at n - 1
    j = torch.clamp_max(t.to(torch.int64), n - 2)
    x0, x1 = _gather(x, j), _gather(x, j + 1)
    w = torch.clamp((xq - x0) / (x1 - x0), 0.0, 1.0)
    return (1.0 - w) * _gather(y, j) + w * _gather(y, j + 1)


def is_loguniform(x, rtol=1e-8):
    """True when the grid ``x`` (1D) is log-uniform: the gate of the
    computed-index evaluators.  Reads one boolean back to the host."""
    d = torch.diff(torch.log(torch.as_tensor(x, dtype=torch.float64)))
    return bool(torch.all(torch.abs(d - d[0])
                          <= 1e-12 + rtol * torch.abs(d[0])))
