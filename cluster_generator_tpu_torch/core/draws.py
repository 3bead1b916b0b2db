"""Random draws shared by the merger pipeline and the ensemble datagen.

Every draw takes a ``torch.Generator`` on the tensors' device, or the
pre-drawn uniforms a caller wants at that random site (how the tests feed
both packages the same numbers).  ``n`` is a length or a whole shape: the
ensemble draws ``(batch, n_part)`` at once.
"""

from __future__ import annotations

import math

import torch

__all__ = ["uniform", "isotropic"]


def uniform(gen, n, dtype, device, lo=0.0, hi=1.0):
    """Uniform numbers of shape ``n`` in ``[lo, hi)``."""
    u = torch.rand(n, generator=gen, dtype=dtype, device=device)
    if (lo, hi) != (0.0, 1.0):
        u = u * (hi - lo) + lo
    return u


def isotropic(n, dtype, device, gen=None, uniforms=None):
    """Unit vectors ``n + (3,)`` uniform on the sphere; ``uniforms`` is
    ``(cos_theta in [-1, 1), u_phi in [0, 1))``."""
    if uniforms is None:
        cos_t = uniform(gen, n, dtype, device, -1.0, 1.0)
        u_phi = uniform(gen, n, dtype, device)
    else:
        cos_t, u_phi = uniforms
    phi = (2.0 * math.pi) * u_phi
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    return torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi),
                        cos_t], dim=-1)
