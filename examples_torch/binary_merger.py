"""Binary cluster merger via the ClusterICs scene API.

    python examples_torch/binary_merger.py [--device cpu]
"""

import argparse
import os

import cluster_generator_tpu_torch as cg

ap = argparse.ArgumentParser(description="binary merger ICs")
ap.add_argument("--device", default="cuda", help="torch device")
DEV = ap.parse_args().device

SCALE = float(os.environ.get("CG_EXAMPLE_SCALE", "1"))
N = lambda n: max(1000, int(n / SCALE))

# build and save two (identical, for brevity) cluster models first —
# see single_cluster.py; here we assume single_cluster.h5 exists.
c1, c2 = cg.compute_centers_for_binary([7000.0, 7000.0, 7000.0],
                                       d=3000.0, b=500.0)
ics = cg.ClusterICs(
    "merger", 2, ["single_cluster.h5", "single_cluster.h5"],
    [c1, c2], [[0.35, 0.0, 0.0], [-0.35, 0.0, 0.0]],
    num_particles={"dm": N(4_000_000), "gas": N(2_000_000), "star": N(800_000)},
    r_max=5000.0, device=DEV)
ics.to_file("merger.yaml", overwrite=True)

parts = ics.setup_particle_ics(prng=11)
parts.write_to_gadget_file("merger_ic.h5", 14000.0, overwrite=True,
                           code="arepo")
print("merger IC written:", parts.num_particles)

# magnetic field scaled by each cluster's B(r), divergence-cleaned
B = cg.RadialRandomMagneticField(
    [0.0] * 3, [14000.0] * 3, [128 if SCALE <= 1 else 32] * 3, 50.0, 500.0,
    ctr1=c1, profile1="single_cluster.h5",
    ctr2=c2, profile2="single_cluster.h5", prng=13, device=DEV)
B.write_file("merger_B.h5", overwrite=True)
