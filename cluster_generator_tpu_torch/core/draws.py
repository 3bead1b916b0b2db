"""Random draws shared by the merger pipeline and the ensemble datagen.

Every draw takes a ``torch.Generator`` on the tensors' device, or the
pre-drawn uniforms a caller wants at that random site (how the tests feed
both packages the same numbers).  ``n`` is a length or a whole shape: the
ensemble draws ``(batch, n_part)`` at once.  ``out`` (the uniforms' own
functions): tensors of the same tree, filled in place with the numbers the
call would return (a captured program's static buffers).
"""

from __future__ import annotations

import math

import torch

__all__ = ["uniform", "isotropic", "isotropic_uniforms",
           "collisionless_uniforms", "gas_uniforms"]


def uniform(gen, n, dtype, device, lo=0.0, hi=1.0, out=None):
    """Uniform numbers of shape ``n`` in ``[lo, hi)`` (into ``out``)."""
    if out is None:
        u = torch.rand(n, generator=gen, dtype=dtype, device=device)
        if (lo, hi) != (0.0, 1.0):
            u = u * (hi - lo) + lo
        return u
    # torch.rand is empty + uniform_: the same numbers
    out.uniform_(generator=gen)
    if (lo, hi) != (0.0, 1.0):
        out.mul_(hi - lo).add_(lo)
    return out


def isotropic(n, dtype, device, gen=None, uniforms=None):
    """Unit vectors ``n + (3,)`` uniform on the sphere; ``uniforms`` is
    ``(cos_theta in [-1, 1), u_phi in [0, 1))``."""
    cos_t, u_phi = (isotropic_uniforms(gen, n, dtype, device)
                    if uniforms is None else uniforms)
    phi = (2.0 * math.pi) * u_phi
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    return torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi),
                        cos_t], dim=-1)


def isotropic_uniforms(gen, n, dtype, device, out=None):
    """``(cos_theta, u_phi)`` for :func:`isotropic`, drawn from ``gen``."""
    out = out or (None, None)
    return (uniform(gen, n, dtype, device, -1.0, 1.0, out=out[0]),
            uniform(gen, n, dtype, device, out=out[1]))


def collisionless_uniforms(gen, n, dtype, device, out=None):
    """Every uniform of a DM or star draw, in the order the draw takes them
    from ``gen``: ``(u_radius, u_speed, u_row, pos_dir, vel_dir)``."""
    out = out or (None,) * 5
    return (uniform(gen, n, dtype, device, out=out[0]),
            uniform(gen, n, dtype, device, out=out[1]),
            uniform(gen, n, dtype, device, out=out[2]),
            isotropic_uniforms(gen, n, dtype, device, out=out[3]),
            isotropic_uniforms(gen, n, dtype, device, out=out[4]))


def gas_uniforms(gen, n, dtype, device, out=None):
    """Every uniform of a gas (or tracer) draw, in its order:
    ``(u_radius, dir)``."""
    out = out or (None, None)
    return (uniform(gen, n, dtype, device, out=out[0]),
            isotropic_uniforms(gen, n, dtype, device, out=out[1]))
