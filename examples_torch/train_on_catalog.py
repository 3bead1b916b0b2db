"""Train an emulator on an ensemble-datagen catalog — the consumption
loop the catalog product is built for.

    python examples_torch/train_on_catalog.py [--device cpu]

The pipeline: `ensemble_datagen` streams full-species cluster draws to
one HDF5 catalog; `catalog_batches` feeds shuffled, fixed-shape training
batches (prefetched on a background thread, `fields=` subsetting so the
loop only pays for the arrays it uses); an Adam step trains an MLP
mapping (M200, conc) to the clusters' radial velocity-dispersion profile
measured from the drawn DM particles.  Every batch has one shape
(`drop_remainder=True`), and host reads overlap the device's compute.
"""

import argparse
import os
import tempfile

import numpy as np
import torch
from torch import nn

from cluster_generator_tpu_torch.parallel import (
    catalog_batches,
    ensemble_datagen,
    sample_ensemble_params,
)

ap = argparse.ArgumentParser(description="train on a datagen catalog")
ap.add_argument("--device", default="cuda", help="torch device")
DEV = ap.parse_args().device

SCALE = float(os.environ.get("CG_EXAMPLE_SCALE", "1"))
N_CL = max(12, int(256 / SCALE))
N_DM = max(2_000, int(50_000 / SCALE))
BATCH = 4
EDGES = torch.tensor([50.0, 200.0, 500.0, 1000.0, 2000.0], device=DEV)  # kpc
K = EDGES.shape[0] - 1

# ---------------------------------------------------------------- catalog
M200, conc = sample_ensemble_params(torch.Generator(DEV).manual_seed(0),
                                    N_CL, device=DEV)
fn = os.path.join(tempfile.mkdtemp(), "train_catalog.h5")
ensemble_datagen(M200, conc, fn, {"dm": N_DM, "gas": 0, "star": 0},
                 batch_size=min(64, N_CL), num_points=256, seed=1,
                 device=DEV)
print(f"catalog: {N_CL} clusters x {N_DM} DM particles -> {fn}")


# ------------------------------------------------------- targets + model
def sigma_profile(pos, vel):
    """Radial velocity-dispersion profiles of a batch of clusters
    ((B, n, 3) positions and velocities): sigma_r in fixed radial bins,
    kpc/Myr, (B, K)."""
    r = pos.float().square().sum(dim=-1).sqrt()
    v2 = vel.float().square().sum(dim=-1)
    idx = (torch.bucketize(r, EDGES) - 1).clamp(0, K - 1)
    w = ((r >= EDGES[0]) & (r < EDGES[-1])).float()
    cnt = torch.zeros(r.shape[0], K, device=r.device).scatter_add_(1, idx, w)
    s2 = torch.zeros(r.shape[0], K, device=r.device).scatter_add_(
        1, idx, w * v2)
    return (s2 / cnt.clamp(min=1.0) / 3.0).sqrt()


def features(m200, c):
    return torch.stack([torch.log10(m200.float()) - 15.0,
                        c.float() / 5.0], dim=1)


torch.manual_seed(2)
mlp = nn.Sequential(nn.Linear(2, 64), nn.GELU(), nn.Linear(64, 64),
                    nn.GELU(), nn.Linear(64, K)).to(DEV)
opt = torch.optim.Adam(mlp.parameters(), lr=3e-3)


def train_step(m200, c, pos, vel):
    target = sigma_profile(pos, vel)
    loss = ((mlp(features(m200, c)) - target) ** 2).mean()
    opt.zero_grad()
    loss.backward()
    opt.step()
    return loss.detach()


# --------------------------------------------------------------- training
first = last = None
for epoch in range(8):
    losses = []
    for b in catalog_batches(fn, BATCH,
                             generator=torch.Generator().manual_seed(
                                 10 + epoch),
                             fields=["dm_position", "dm_velocity"]):
        losses.append(train_step(
            *(torch.as_tensor(b[k], device=DEV)
              for k in ("M200", "conc", "dm_position", "dm_velocity"))))
    mean = float(torch.stack(losses).mean())
    first = mean if first is None else first
    last = mean
    print(f"epoch {epoch}: loss {mean:.5f}")

print(f"loss {first:.5f} -> {last:.5f} "
      f"({'improved' if last < first else 'NOT improved'})")
assert last < first, "training loss did not improve"
