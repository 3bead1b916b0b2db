"""Build one equilibrium cluster, sample particles, export for Gadget.

The canonical configuration: super-NFW total mass profile fit to
M200 = 1.5e15 Msun at z = 0.1, Vikhlinin gas density rescaled to the
observed gas fraction, 2% stellar component, beta = 100 magnetic field.

    python examples_torch/single_cluster.py [--device cpu]
"""

import argparse
import os

import cluster_generator_tpu_torch as cg

ap = argparse.ArgumentParser(description="one equilibrium cluster")
ap.add_argument("--device", default="cuda", help="torch device")
DEV = ap.parse_args().device

# CG_EXAMPLE_SCALE divides all particle counts (used by the test smoke run)
SCALE = float(os.environ.get("CG_EXAMPLE_SCALE", "1"))
N = lambda n: max(1000, int(n / SCALE))

z, M200, conc = 0.1, 1.5e15, 4.0

r200 = cg.find_overdensity_radius(M200, 200.0, z=z)
a = r200 / conc
M = cg.snfw_total_mass(M200, r200, a)
rhot = cg.snfw_density_profile(M, a)
Mt = cg.snfw_mass_profile(M, a)
r500, M500 = cg.find_radius_mass(Mt, z=z, delta=500.0, device=DEV)
f_g = cg.f_gas(M500)

# r500 and M500 are tensors on DEV, so the rescaled profile lives there
rhog = cg.rescale_profile_by_mass(
    cg.vikhlinin_density_profile(1.0, 100.0, r200, 1.0, 0.67, 3),
    f_g * M500, r500)

model = cg.ClusterModel.from_dens_and_tden(0.1, 1.0e4, rhog, rhot,
                                           stellar_density=0.02 * rhot,
                                           device=DEV)
model.set_magnetic_field_from_beta(100.0)
print("HSE residual:", float(model.check_hse().abs().max()))
print("virial residual:", float(model.check_dm_virial()[1].max()))
model.write_model_to_h5("single_cluster.h5", overwrite=True)

parts = (model.generate_dm_particles(N(2_000_000), r_max=5000.0, prng=1)
         + model.generate_star_particles(N(400_000), r_max=5000.0, prng=2)
         + model.generate_gas_particles(N(1_000_000), r_max=5000.0, prng=3))
parts.add_offsets([7000.0] * 3, [0.0] * 3)
parts.write_to_gadget_file("single_cluster_ic.h5", 14000.0, overwrite=True)
print("wrote single_cluster_ic.h5:", parts.num_particles)
