"""The port against the UPSTREAM `cluster_generator` package's own output.

tests/answers/reference_model.h5 and reference_particles.h5 were written
by the upstream package (scripts/generate_reference_answers.py, through
tests/refshim): its from_dens_and_tden, Eddington inversion,
write_model_to_h5 and particle generator.  tests/test_reference_parity.py
holds the JAX package against them; this file holds the port against the
same files at the same bounds, on the CPU in float64, so the port's parity
with the upstream package no longer rests on the JAX tests' tolerances.

Particle parity is distributional (KS, second moment), never bitwise: the
upstream draws come from numpy's MT19937, the port's from torch's.
"""

import os

import h5py
import numpy as np
import pytest
import torch
from scipy.stats import ks_2samp

import cluster_generator_tpu_torch as cg
from cluster_generator_tpu_torch.virial import check_virial_density

torch.set_num_threads(1)

ANSWER_DIR = os.path.join(os.path.dirname(__file__), "answers")
MODEL_FILE = os.path.join(ANSWER_DIR, "reference_model.h5")
PART_FILE = os.path.join(ANSWER_DIR, "reference_particles.h5")

needs_answers = pytest.mark.skipif(
    not (os.path.exists(MODEL_FILE) and os.path.exists(PART_FILE)),
    reason="reference answers not generated "
           "(scripts/generate_reference_answers.py)")

# the fields the upstream package stores, in the units of the port's fields
_FIELDS = [
    "radius", "density", "total_density", "stellar_density",
    "dark_matter_density", "temperature", "pressure", "total_mass",
    "gas_mass", "dark_matter_mass", "stellar_mass", "gas_fraction",
    "gravitational_potential", "gravitational_field",
    "electron_number_density", "entropy", "magnetic_field_strength",
]


@pytest.fixture(scope="module")
def model():
    """The upstream test suite's canonical cluster (tests/conftest.py's
    ``canonical_model``), built by the port on the CPU: sNFW total +
    Vikhlinin gas + 2% stars, from_dens_and_tden on [0.1, 1e4] kpc,
    beta = 100."""
    z, M200, conc, f_g = 0.1, 1.5e15, 4.0, 0.12
    r200 = cg.find_overdensity_radius(M200, 200.0, z=z)
    a = r200 / conc
    M = cg.snfw_total_mass(M200, r200, a)
    rhot = cg.snfw_density_profile(M, a)
    Mt = cg.snfw_mass_profile(M, a)
    r500, M500 = cg.find_radius_mass(Mt, z=z, delta=500.0, device="cpu")
    rhog = cg.rescale_profile_by_mass(
        cg.vikhlinin_density_profile(1.0, 100.0, r200, 1.0, 0.67, 3),
        f_g * M500, r500)
    m = cg.ClusterModel.from_dens_and_tden(0.1, 10000.0, rhog, rhot,
                                           stellar_density=0.02 * rhot,
                                           device="cpu")
    m.set_magnetic_field_from_beta(100.0, gaussian=True)
    return m


@needs_answers
@pytest.mark.parametrize("name", _FIELDS)
def test_model_field_matches_reference(model, name):
    """Every equilibrium field at 1e-6 relative (BASELINE.md's target)."""
    with h5py.File(MODEL_FILE, "r") as f:
        ref = f["fields"][name][()]
    mine = model[name].numpy()
    assert mine.dtype == np.float64 and mine.shape == ref.shape, name
    rel = np.abs(mine - ref) / np.maximum(np.abs(ref), 1e-300)
    assert rel.max() < 1e-6, (name, rel.max())


@needs_answers
@pytest.mark.parametrize("key", ["dm_df", "star_df"])
def test_df_matches_reference_package(model, key):
    """f(E) against the upstream package's own Eddington inversion, at
    that package's quadrature tolerance (epsabs = epsrel = 1.49e-5,
    upstream virial.py:60-61): its error binds, not the port's."""
    virial = model.dm_virial if key == "dm_df" else model.star_virial
    with h5py.File(MODEL_FILE, "r") as f:
        ref = f[key][()]
    rel = np.abs(virial.df.numpy() - ref) / np.abs(ref)
    assert np.median(rel) < 1.49e-5, (key, np.median(rel))
    assert rel.max() < 1e-3, (key, rel.max())


@needs_answers
def test_reference_df_passes_the_ports_virial_check(model):
    """The upstream package's stored DM DF, put through the port's
    density reconstruction, gives back the model's DM density."""
    with h5py.File(MODEL_FILE, "r") as f:
        ref_df = torch.as_tensor(f["dm_df"][()], dtype=torch.float64)
    rho = check_virial_density(model.dm_virial.ee, torch.flip(ref_df, (0,)))
    pden = model["dark_matter_density"]
    chk = (torch.flip(rho, (0,)) - pden) / pden
    assert float(chk.max()) < 1e-4, float(chk.max())


@pytest.fixture(scope="module")
def reference_particles():
    with h5py.File(PART_FILE, "r") as f:
        return {k: v[()] for k, v in f["dm"].items()}


@pytest.fixture(scope="module")
def port_particles(model):
    """200k DM particles drawn by the port, shared by the tests below."""
    return model.generate_dm_particles(
        200_000, r_max=5000.0, prng=torch.Generator().manual_seed(42))


def _norm(a):
    return np.linalg.norm(np.asarray(a), axis=1)


@needs_answers
@pytest.mark.parametrize("field", ["particle_position", "particle_velocity"])
def test_particle_distribution_matches_reference(port_particles,
                                                 reference_particles, field):
    """Two-sample KS on radii and on speeds against the upstream draw at
    the same r_max: a statistic bound (at n = 2e5 KS resolves D ~ 6e-3),
    not a p-value; for speeds also the second moment within 1%."""
    mine = _norm(port_particles["dm", field].numpy())
    ref = _norm(reference_particles[field])
    d, _ = ks_2samp(mine, ref)
    assert d < 0.01, (field, d)
    if field == "particle_velocity":
        assert abs(np.mean(mine**2) / np.mean(ref**2) - 1.0) < 0.01


@needs_answers
def test_particle_masses_match_reference(port_particles,
                                         reference_particles):
    mine = port_particles["dm", "particle_mass"].numpy()
    ref = reference_particles["particle_mass"]
    assert mine.size == ref.size
    assert np.allclose(mine[0], ref[0], rtol=1e-6)
    assert np.allclose(mine.sum(), ref.sum(), rtol=1e-6)
