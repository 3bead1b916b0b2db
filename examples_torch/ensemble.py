"""Batched ensemble datagen: hundreds of equilibrium clusters per call.

    python examples_torch/ensemble.py [--device cpu]

A caller with a ``torch.distributed`` world can spread the batch over its
ranks: ``make_mesh()`` puts every rank on the 'ens' axis, and
``ensemble_datagen(..., mesh=mesh)`` has each rank build and draw its
share of every batch with no communication but the gather for the writer.
This example stays one process.
"""

import argparse
import os
import tempfile

import torch

from cluster_generator_tpu_torch.parallel import (
    build_ensemble,
    sample_ensemble_params,
)

ap = argparse.ArgumentParser(description="ensemble datagen")
ap.add_argument("--device", default="cuda", help="torch device")
DEV = ap.parse_args().device

B = max(8, int(256 / float(os.environ.get("CG_EXAMPLE_SCALE", "1"))))
M200, conc = sample_ensemble_params(torch.Generator(DEV).manual_seed(0), B,
                                    device=DEV)

fields = build_ensemble(M200, conc, num_points=512, device=DEV)
Tmax = fields["temperature"].amax(dim=1)
print(f"built {B} clusters: kT range "
      f"{float(Tmax.min()):.2f}..{float(Tmax.max()):.2f} keV")
print("every f(E) >= 0:", bool((fields["dm_df"] >= 0).all()))

# Full DATAGEN: stream every cluster's draws to one HDF5 catalog
# (group per cluster).  An int count draws DM phase space; a dict draws
# the complete full-species product -- DM + stars with per-species
# Eddington DFs, gas with thermal energies.
from cluster_generator_tpu_torch.parallel import ensemble_datagen

with tempfile.TemporaryDirectory() as td:
    fn = ensemble_datagen(M200[:8], conc[:8], f"{td}/catalog.h5",
                          20_000, batch_size=8, num_points=256, seed=1,
                          device=DEV)
    import h5py

    with h5py.File(fn) as f:
        print(f"datagen catalog: {f.attrs['n_clusters']} clusters x "
              f"{f.attrs['n_particles_per_cluster']} particles")

    # full-species variant: every species per cluster in one program
    fn2 = ensemble_datagen(M200[:4], conc[:4], f"{td}/full.h5",
                           {"dm": 10_000, "gas": 8_000, "star": 2_000},
                           batch_size=4, num_points=256, seed=2, device=DEV)
    with h5py.File(fn2) as f:
        g = f["cluster_000000"]
        print("full-species datasets:", sorted(g.keys()))

    # consume it back (raw pread at the datasets' offsets)
    from cluster_generator_tpu_torch.parallel import read_catalog

    for i, cl in read_catalog(fn2, indices=[0, 2]):
        print(f"cluster {i}: M200={cl['M200']:.3e}, "
              f"dm={cl['dm_position'].shape}, "
              f"e_gas range=({cl['gas_thermal_energy'].min():.3g}, "
              f"{cl['gas_thermal_energy'].max():.3g})")

    # training-loop form: shuffled stacked batches with prefetch
    from cluster_generator_tpu_torch.parallel import catalog_batches

    for batch in catalog_batches(fn2, 2,
                                 generator=torch.Generator().manual_seed(3)):
        x = torch.as_tensor(batch["dm_position"], device=DEV)  # (2, 10000, 3)
        print(f"train batch: dm {tuple(x.shape)}, M200 {batch['M200']}")

    # physics QA gate before training on a catalog: rebuild each model
    # and check the draws (finite, r in grid, v < v_esc, e = 1.5 P/rho)
    from cluster_generator_tpu_torch.parallel import verify_catalog

    rep = verify_catalog(fn2, indices=[0, 1], device=DEV)
    print(f"QA: {rep['n_particles_checked']} particles, "
          f"max v/v_esc {rep['max_speed_frac']:.4f}, "
          f"violations: {len(rep['violations'])}")
