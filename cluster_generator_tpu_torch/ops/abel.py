"""Eddington's Abel sums: g(E) = int_0^E rho'(psi) / sqrt(E - psi) dpsi.

For each row energy E_i, the closed-form Abel integral of the density
spline's derivative summed over every spline interval (the DFs of
:func:`~..virial.compute_df`).  On a CUDA tensor :func:`abel_g_rows`
launches the hand-written kernel ``csrc/abel_g_rows.cu`` (one launch for
every row of every entry); on a CPU tensor it runs
:func:`abel_g_rows_plain`, the same terms written literally in torch over
an (..., rows, N) temporary.  The kernel replaces no TPU kernel; the
source note in the ``.cu`` file gives why it was added, its design and its
bound.

The launch goes on PyTorch's current stream, so inside a captured program
(:mod:`..core.compiled`) it is recorded into the graph;
``abel_g_rows.launches`` counts the launches the card runs, a replay
adding the nodes of its graph.  Where an input requires grad with grad
enabled, the launch sits inside a :class:`torch.autograd.Function` whose
backward differentiates the plain version, recomputed.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from .build import launch

__all__ = ["abel_g_rows", "abel_g_rows_plain", "safe_sqrt"]

# the C entry point's arguments before the stream: x, b, c, d, ee, out,
# entries, n, rows, log2 of the lanes a row pair
ARGTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 4

# threads the launch aims at (about two of the card's 132 x 2048): with
# fewer row pairs than this, more lanes share each pair's intervals (up
# to a warp)
_TARGET_THREADS = 1 << 18


def safe_sqrt(x):
    """sqrt clamped at 0."""
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def abel_g_rows_plain(x, b, c, d, ee):
    """g(E_i) = int_0^{E_i} rho'(psi)/sqrt(E_i - psi) dpsi, exactly.

    ``x`` (..., N) the spline's ascending knots, ``b``, ``c``, ``d``
    (..., N - 1) its coefficients, ``ee`` (..., rows) the row energies.
    rho'(psi) on spline interval k is b_k + 2 c_k tau + 3 d_k tau^2
    (tau = psi - x_k), so with u = sqrt(E - psi) each interval contributes

        G(u) = 2 (k0 u + k2 u^3/3 + k4 u^5/5),   evaluated lo->hi,
        k0 = b + 2cA + 3dA^2,  k2 = -(2c + 6dA),  k4 = 3d,  A = E - x_k.

    The region psi in [0, x_0) uses interval 0's polynomial extrapolated.
    Works on ``(..., N)`` with an ``(..., rows, N)`` temporary per batch
    entry.
    """
    zero = torch.zeros_like(x[..., :1])
    lo = torch.cat([zero, x[..., :-1]], dim=-1)[..., None, :]
    hi = torch.cat([x[..., :1], x[..., 1:]], dim=-1)[..., None, :]
    xk = torch.cat([x[..., :1], x[..., :-1]], dim=-1)[..., None, :]
    b = torch.cat([b[..., :1], b], dim=-1)[..., None, :]
    c = torch.cat([c[..., :1], c], dim=-1)[..., None, :]
    d = torch.cat([d[..., :1], d], dim=-1)[..., None, :]

    E = ee[..., :, None]
    u_lo = safe_sqrt(E - torch.minimum(lo, E))
    u_hi = safe_sqrt(E - torch.minimum(hi, E))
    A = E - xk
    k0 = b + 2.0 * c * A + 3.0 * d * A * A
    k2 = -(2.0 * c + 6.0 * d * A)
    k4 = 3.0 * d

    def G(u):
        u2 = u * u
        return 2.0 * u * (k0 + u2 * (k2 / 3.0 + u2 * (k4 / 5.0)))

    return torch.sum(G(u_lo) - G(u_hi), dim=-1)


def _check(x, b, c, d, ee) -> tuple:
    """The leading shape the five inputs broadcast to; raises on a type,
    device or width the kernel does not take."""
    for name, t in (("x", x), ("b", b), ("c", c), ("d", d), ("ee", ee)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dtype != torch.float64:
            raise TypeError(f"{name} must be torch.float64, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.ndim < 1:
            raise ValueError(f"{name} must have a last axis")
    n = x.shape[-1]
    if n < 2:
        raise ValueError(f"x needs >= 2 knots, got {n}")
    for name, t in (("b", b), ("c", c), ("d", d)):
        if t.shape[-1] != n - 1:
            raise ValueError(f"{name} must have {n - 1} coefficients (N - 1), "
                             f"got {t.shape[-1]}")
    return tuple(np.broadcast_shapes(*(tuple(t.shape[:-1])
                                       for t in (x, b, c, d, ee))))


def lanes_log2(entries: int, rows: int) -> int:
    """log2 of the lanes that share a row pair's intervals: the fewest
    (1 to 32) that give the launch :data:`_TARGET_THREADS` threads."""
    pairs = max(1, entries * ((rows + 1) // 2))
    log_s = 0
    while log_s < 5 and pairs << log_s < _TARGET_THREADS:
        log_s += 1
    return log_s


def _launch(x, b, c, d, ee, lead, log_s=None) -> torch.Tensor:
    n, rows = x.shape[-1], ee.shape[-1]
    entries = int(np.prod(lead, dtype=np.int64))
    out = torch.empty(tuple(lead) + (rows,), dtype=torch.float64,
                      device=x.device)
    if out.numel() == 0:
        return out

    def flat(t, width):
        return t.expand(tuple(lead) + (width,)).reshape(entries,
                                                        width).contiguous()

    x, ee = flat(x, n), flat(ee, rows)
    b, c, d = (flat(t, n - 1) for t in (b, c, d))
    if log_s is None:
        log_s = lanes_log2(entries, rows)
    launch(abel_g_rows, "abel_g_rows", ARGTYPES, x.device, x.data_ptr(),
           b.data_ptr(), c.data_ptr(), d.data_ptr(), ee.data_ptr(),
           out.data_ptr(), entries, n, rows, log_s)
    return out


class _AbelG(torch.autograd.Function):
    """The kernel forward; the backward differentiates the plain version,
    recomputed under grad."""

    @staticmethod
    def forward(ctx, x, b, c, d, ee, lead):
        ctx.save_for_backward(x, b, c, d, ee)
        return _launch(x, b, c, d, ee, lead)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        need = ctx.needs_input_grad
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(w)
                      for t, w in zip(ctx.saved_tensors, need[:5])]
            g = abel_g_rows_plain(*leaves)
            grads = iter(torch.autograd.grad(
                g, [t for t, w in zip(leaves, need) if w], grad))
        return tuple(next(grads) if w else None for w in need[:5]) + (None,)


def abel_g_rows(x, b, c, d, ee):
    """g(E_i) (..., rows) for the spline ``(x, b, c, d)`` at the row
    energies ``ee`` (arguments of :func:`abel_g_rows_plain`), all float64
    on one device, x ascending.

    A CUDA tensor goes through the CUDA kernel (``abel_g_rows.launches``
    counts its launches on the card, a graph's on each replay): the plain
    version's terms, summed in a fixed order of the kernel's own, which is
    all that differs; with grad, through :class:`_AbelG`.  A CPU tensor
    goes through :func:`abel_g_rows_plain`.  Any other device
    raises, as do float32 inputs and inputs on two devices.
    """
    lead = _check(x, b, c, d, ee)
    if x.device.type == "cuda":
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (x, b, c, d, ee)):
            return _AbelG.apply(x, b, c, d, ee, lead)
        return _launch(x, b, c, d, ee, lead)
    if x.device.type == "cpu":
        return abel_g_rows_plain(x, b, c, d, ee)
    raise ValueError(f"abel_g_rows: unsupported device {x.device}")


abel_g_rows.launches = 0
