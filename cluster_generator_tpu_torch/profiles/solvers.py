"""Profile solvers: enclosed mass, mass rescaling and overdensity radii
(batched bisection)."""

from __future__ import annotations

import math

import torch

from ..core import compiled
from ..core.cosmology import Cosmology, default_cosmology
from ..core.device import resolve_device, tensor_on
from ..core.quadrature import gauss_legendre
from .algebra import Profile, _expand

__all__ = ["mass_within", "rescale_profile_by_mass",
           "find_overdensity_radius", "find_radius_mass"]

_BISECT_ITERS = 100
_BRACKET = (0.01, 10000.0)


def mass_within(profile: Profile, radius, order: int = 64, device="cuda"):
    """4 pi int_0^R rho(r) r^2 dr with r = R u^2 (resolves integrable
    cusps); ``radius`` has the profile's batch shape.  A tensor ``radius``
    is integrated on its own device, a float on ``device``."""
    radius = tensor_on(radius, device)
    x, w = gauss_legendre(order, radius)
    u = 0.5 * (x + 1.0)
    wu = 0.5 * w
    R = radius[..., None]
    r = R * u * u
    dr = R * 2.0 * u
    return 4.0 * math.pi * torch.sum(profile(r) * r * r * dr * wu, dim=-1)


def rescale_profile_by_mass(profile: Profile, mass, radius,
                            device="cuda") -> Profile:
    """The density profile rescaled to enclose ``mass`` within ``radius``;
    the factor is a tensor on the device of :func:`mass_within`, where the
    rescaled profile must then be evaluated."""
    rescale = mass / mass_within(profile, radius, device=device)
    return rescale * profile


def find_overdensity_radius(m, delta, z=0.0, cosmo: Cosmology | None = None):
    """Radius enclosing mass ``m`` at overdensity ``delta``; ``z`` a float
    or a 0-d float64 tensor (see :meth:`Cosmology.critical_density`)."""
    if cosmo is None:
        cosmo = default_cosmology()
    rho_crit = cosmo.critical_density(z)
    return (3.0 * m / (4.0 * math.pi * delta * rho_crit)) ** (1.0 / 3.0)


@compiled.function(static=("shape", "device"))
def _bisect(m_r: Profile, target, shape, device):
    """100 halvings of [0.01, 10000] kpc for the root of
    f(r) = 3 M(r) / (4 pi r^3) - target, batched; NaN where the bracket
    does not straddle a root.  One program, as the JAX package's
    ``lax.fori_loop`` is one dispatch."""
    def f(r):
        m = m_r.eval_fn(_expand(m_r.params, r.ndim), r)
        return 3.0 * m / (4.0 * math.pi * r**3) - target

    lo = torch.full(shape, _BRACKET[0], dtype=torch.float64, device=device)
    hi = torch.full(shape, _BRACKET[1], dtype=torch.float64, device=device)
    flo = f(lo)
    bracketed = torch.sign(flo) != torch.sign(f(hi))
    for _ in range(_BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        fmid = f(mid)
        go_right = torch.sign(fmid) == torch.sign(flo)
        lo = torch.where(go_right, mid, lo)
        flo = torch.where(go_right, fmid, flo)
        hi = torch.where(go_right, hi, mid)
    return torch.where(bracketed, 0.5 * (lo + hi),
                       torch.full_like(lo, math.nan))


class _OverdensityRoot(torch.autograd.Function):
    """r_delta with the implicit-function gradient: forward, the bisection
    of f(r; theta) = 3 M(r) / (4 pi r^3) - delta rho_crit; backward,
    dr/dtheta = -(df/dtheta) / (df/dr) at the root, with the profile's
    tensor parameters ``theta`` as the inputs (the JAX package's
    ``lax.custom_root``).  An unbracketed root (NaN) passes no gradient."""

    @staticmethod
    def forward(ctx, eval_fn, struct, target, shape, device, *leaves):
        r = _bisect(Profile(eval_fn, compiled.unflatten(struct, leaves)),
                    target, shape, device)
        ctx.eval_fn, ctx.struct, ctx.target = eval_fn, struct, target
        ctx.save_for_backward(r, *leaves)
        return r

    @staticmethod
    def backward(ctx, grad_r):
        r, *leaves = ctx.saved_tensors
        wanted = [i for i, t in enumerate(leaves) if ctx.needs_input_grad[5 + i]]
        grads = [None] * len(leaves)
        if wanted:
            with torch.enable_grad():
                thetas = [t.detach().requires_grad_(i in wanted)
                          for i, t in enumerate(leaves)]
                root = torch.where(torch.isfinite(r), r,
                                   torch.ones_like(r)).requires_grad_()
                m = ctx.eval_fn(_expand(compiled.unflatten(ctx.struct, thetas),
                                        root.ndim), root)
                f = 3.0 * m / (4.0 * math.pi * root**3) - ctx.target
                (dfdr,) = torch.autograd.grad(f.sum(), root, retain_graph=True)
                v = torch.where(torch.isfinite(r), -grad_r / dfdr,
                                torch.zeros_like(r))
                got = torch.autograd.grad(f, [thetas[i] for i in wanted],
                                          grad_outputs=v, allow_unused=True)
            for i, g in zip(wanted, got):
                grads[i] = g
        return (None, None, None, None, None, *grads)


def find_radius_mass(m_r: Profile, delta, z=0.0,
                     cosmo: Cosmology | None = None, like=None,
                     device="cuda"):
    """(r_delta, M(r_delta)) for a mass profile: bisection on
    f(r) = 3 M(r) / (4 pi r^3) - delta rho_crit over [0.01, 10000] kpc
    with a fixed 100 halvings, every halo of the batch at once.

    NaN where the bracket does not straddle a root.  ``like`` gives the
    batch shape and device of the bracket (a tensor parameter of ``m_r``);
    without it the result is a pair of 0-d tensors on ``device``.
    r_delta carries the implicit gradient with respect to the profile's
    tensor parameters (see :class:`_OverdensityRoot`).
    """
    if cosmo is None:
        cosmo = default_cosmology()
    rho_crit = cosmo.critical_density(z)
    shape = () if like is None else like.shape
    device = resolve_device(device) if like is None else like.device
    leaves = []
    struct = compiled.flatten(m_r.params, leaves)
    r_delta = _OverdensityRoot.apply(m_r.eval_fn, struct, delta * rho_crit,
                                     shape, device, *leaves)
    return r_delta, m_r(r_delta)
