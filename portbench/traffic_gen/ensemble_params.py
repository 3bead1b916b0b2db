"""An ensemble of (M200, c) for the datagen cells.

A frozen copy of the port's ``parallel.ensemble.sample_ensemble_params``:
log-uniform M200 over ``logM_range``; c from the power law
5 (M200 / 1e15 Msun)^-0.1 with a log-normal scatter of ``scatter`` dex in
natural-log units, clamped to ``conc_range``.  Float64 tensors on the
generator's device, drawn in two calls.
"""

from __future__ import annotations

import torch


def sample(generator, n, logM_range=(14.0, 15.3), conc_range=(3.0, 8.0),
           scatter=0.3):
    dev = generator.device
    u = torch.rand(n, generator=generator, dtype=torch.float64, device=dev)
    logM = u * (logM_range[1] - logM_range[0]) + logM_range[0]
    M200 = 10.0 ** logM
    c_mean = 5.0 * (M200 / 1.0e15) ** (-0.1)
    eps = torch.randn(n, generator=generator, dtype=torch.float64,
                      device=dev) * scatter
    conc = torch.clamp(c_mean * torch.exp(eps), conc_range[0], conc_range[1])
    return M200, conc
