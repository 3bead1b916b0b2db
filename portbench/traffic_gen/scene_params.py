"""The binary-merger scenes of the merger-scene cells.

A frozen copy of the port's ``parallel.mergers.sample_merger_scene_params``
and ``binary_scene_geometry``, so that a change to the program cannot
change the traffic.  Drawn from a ``torch.Generator`` in the port's order:
the primary's log10 M200 and the mass ratio (uniform), the (n, 2) normals
of the concentrations' log-normal scatter, then the separation, the
impact parameter's fraction of it and the relative speed (uniform); every
one float64.  c(M) = 5 (M200 / 1e15 Msun)^-0.1 times exp(scatter * normal),
clamped.  The geometry: the halos ``sqrt(d^2 - b^2)`` apart along x and
``b`` along y about the origin, closing along x at ``v_rel`` with zero
total momentum.
"""

from __future__ import annotations

import numpy as np
import torch


def _uniform(gen, n, lo_hi):
    u = torch.rand(n, generator=gen, dtype=torch.float64, device=gen.device)
    return u * (lo_hi[1] - lo_hi[0]) + lo_hi[0]


def sample(generator, n, p):
    """``n`` scenes with the parameters of a configuration's ``scenes``
    entry ``p``: ``(M200 (n, 2), conc (n, 2), centers (n, 2, 3),
    velocities (n, 2, 3))``, float64 on the generator's device."""
    dev = generator.device
    logm = _uniform(generator, n, p["log10_m200_range"])
    ratio = _uniform(generator, n, p["mass_ratio_range"])
    normals = torch.randn((n, 2), generator=generator, dtype=torch.float64,
                          device=dev)
    d = _uniform(generator, n, p["separation_kpc_range"])
    b = d * _uniform(generator, n, p["impact_fraction_range"])
    v_rel = _uniform(generator, n, p["v_rel_kpc_per_myr_range"])
    m1 = 10.0 ** logm
    M200 = torch.stack([m1, ratio * m1], dim=1)
    c_mean = 5.0 * (M200 / 1.0e15) ** (-0.1)
    conc = torch.clamp(c_mean * torch.exp(normals * p["conc_scatter"]),
                       *p["conc_range"])
    centers, velocities = geometry(M200.cpu().numpy(), d.cpu().numpy(),
                                   b.cpu().numpy(), v_rel.cpu().numpy())
    return (M200, conc, torch.as_tensor(centers, device=dev),
            torch.as_tensor(velocities, device=dev))


def geometry(M200, d, b, v_rel):
    """Centres and bulk velocities, float64 numpy ``(n, 2, 3)`` each."""
    n = M200.shape[0]
    diff = np.stack([np.sqrt(d * d - b * b), b, np.zeros_like(d)], axis=1)
    centers = np.stack([-0.5 * diff, 0.5 * diff], axis=1)
    w1 = M200[:, 1] / M200.sum(axis=1)
    velocities = np.zeros((n, 2, 3))
    velocities[:, 0, 0] = v_rel * w1
    velocities[:, 1, 0] = -v_rel * (1.0 - w1)
    return centers, velocities
