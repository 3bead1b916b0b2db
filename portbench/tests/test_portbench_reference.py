"""The plain reference against closed forms and textbook results, at small
sizes on the CPU."""

import math

import numpy as np
import pytest
import torch
from scipy.integrate import quad

from portbench.reference import model as M
from portbench.reference import paths

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def cluster():
    return M.Cluster(8e14, 4.5, 0.1, 400)


def test_critical_density_of_the_cosmology():
    # 2.775e11 h^2 Msun/Mpc^3 at h = 0.71
    assert M.critical_density(0.0) == pytest.approx(2.7754e2 * 0.71**2,
                                                    rel=1e-3)


def test_snfw_mass_is_its_closed_form_without_cancelling(cluster):
    x = np.array([1e-6, 1e-4, 1e-2, 0.3, 3.0, 30.0])
    naive = 1.0 - (2.0 + 3.0 * x) / (2.0 * (1.0 + x) ** 1.5)
    series = 0.375 * x**2 - 0.625 * x**3 + 0.8203125 * x**4
    got = M.Cluster._shape(x)
    assert got[3:] == pytest.approx(naive[3:], rel=1e-13)
    assert got[:2] == pytest.approx(series[:2], rel=1e-9)
    r = 0.37 * cluster.a
    want = quad(lambda s: 4 * math.pi * s * s * cluster.total_density(s), 0,
                r, epsrel=1e-12)[0]
    assert cluster.total_mass(r) == pytest.approx(want, rel=1e-10)


def test_r200_and_r500_enclose_their_mean_densities(cluster):
    for r, k in ((cluster.r200, 200.0), (cluster.r500, 500.0)):
        mean = 3.0 * cluster.total_mass(r) / (4.0 * math.pi * r**3)
        assert mean == pytest.approx(k * cluster.rho_c, rel=1e-10)


def test_gas_mass_and_pressure_are_their_integrals(cluster):
    f = cluster.fields()
    r = f["radius"]
    for i in (0, 57, 210, 399):
        want = quad(lambda s: 4 * math.pi * s * s * cluster.gas_density(s),
                    0, r[i], epsrel=1e-12, limit=400)[0]
        assert f["gas_mass"][i] == pytest.approx(want, rel=1e-9)
    # f_gas(M500) M500 of gas inside r500
    inside = quad(lambda s: 4 * math.pi * s * s * cluster.gas_density(s), 0,
                  cluster.r500, epsrel=1e-12, limit=400)[0]
    assert inside == pytest.approx(M.f_gas(cluster.m500) * cluster.m500,
                                   rel=1e-9)

    def dp(s):
        m = cluster.total_mass(min(s, r[-1]))
        return cluster.gas_density(s) * M.G * m / s**2

    for i in (3, 200, 398):
        want = (quad(dp, r[i], r[-1], epsrel=1e-12, limit=400)[0]
                + quad(dp, r[-1], np.inf, epsrel=1e-12, limit=400)[0])
        assert f["pressure"][i] == pytest.approx(want, rel=1e-8)


def test_potential_is_minus_the_integral_of_the_field(cluster):
    f = cluster.fields()
    r, phi = f["radius"], f["gravitational_potential"]
    # Phi(b) - Phi(a) = int_a^b G M / r^2 dr
    a, b = r[40], r[300]
    want = quad(lambda s: M.G * cluster.total_mass(s) / s**2, a, b,
                epsrel=1e-12)[0]
    assert phi[300] - phi[40] == pytest.approx(want, rel=1e-9)
    # outside the grid's mass only -G M(r_out) / r is left
    assert phi[-1] == pytest.approx(-M.G * f["total_mass"][-1] / r[-1],
                                    rel=1e-12)


def test_eddington_df_of_the_hernquist_sphere():
    # G = M = a = 1: psi = 1/(1+r), rho = 1/(2 pi r (1+r)^3), and f(E) of
    # Hernquist 1990, eq. 17
    r = np.logspace(-3, 3, 1200)
    psi = 1.0 / (1.0 + r)
    rho = 1.0 / (2.0 * math.pi * r * (1.0 + r) ** 3)
    f = M.eddington(psi[::-1], rho[::-1])
    q = np.sqrt(psi[::-1])
    want = (1.0 / (8.0 * math.sqrt(2.0) * math.pi**3)
            * (3.0 * np.arcsin(q) + q * np.sqrt(1.0 - q * q)
               * (1.0 - 2.0 * q * q) * (8.0 * q**4 - 8.0 * q * q - 3.0))
            / (1.0 - q * q) ** 2.5)
    mid = (q > 0.2) & (q < 0.9)
    assert np.max(np.abs(f[mid] / want[mid] - 1)) < 2e-3


def test_speed_fractions_invert_a_known_distribution():
    # f constant: s^2 f, its CDF s^3, so s = q^(1/3)
    psi = np.linspace(0.1, 2.0, 50)
    s_inv = M.speed_fractions(psi, np.ones(50), np.array([0.5, 1.5]), 512,
                              512)
    q = np.arange(512) / 511
    keep = q > 0.01
    assert np.max(np.abs(s_inv[:, keep] - np.cbrt(q[keep]))) < 2e-4
    assert np.all(np.diff(s_inv, axis=1) >= 0)
    assert s_inv[0, 0] == 0.0 and s_inv[0, -1] == 1.0


def test_directions_are_unit_and_isotropic():
    gen = paths.generator(7, "cpu")
    d = paths.isotropic(paths.gas_uniforms(gen, (200_000,))[1]).double()
    assert torch.allclose(d.norm(dim=-1), torch.ones(200_000,
                                                     dtype=torch.float64),
                          atol=1e-6)
    assert torch.all(d.mean(0).abs() < 0.01)
    assert torch.allclose(d.pow(2).mean(0), torch.full(
        (3,), 1 / 3, dtype=torch.float64), atol=0.01)


def test_uniform_streams_follow_the_documented_order():
    gen = paths.generator(11, "cpu")
    u = paths.collisionless_uniforms(gen, (5,))
    again = torch.rand(35, generator=paths.generator(11, "cpu"))
    flat = torch.cat([u[0], u[1], u[2], (u[3][0] + 1) / 2, u[3][1],
                      (u[4][0] + 1) / 2, u[4][1]])
    assert torch.allclose(flat, again, atol=1e-7)


def _flat(tree):
    if isinstance(tree, (tuple, list)):
        return torch.cat([_flat(t) for t in tree])
    return tree.reshape(-1)


def test_the_merger_stream_is_the_programs():
    from cluster_generator_tpu_torch.pipeline import merger_uniforms

    counts = {"gas": (7, 5), "dm": (6, 4), "star": (3, 2)}
    prog = merger_uniforms(paths.generator(9, "cpu"), (), counts["gas"],
                           counts["dm"], counts["star"], device="cpu")
    gen = paths.generator(9, "cpu")
    for i in range(2):
        for sp in ("gas", "dm", "star"):
            draw = (paths.gas_uniforms if sp == "gas"
                    else paths.collisionless_uniforms)
            ours = draw(gen, (counts[sp][i],))
            assert torch.equal(_flat(ours), _flat(prog[sp, i]))


def test_merger_ic_draws_the_masses_inside_r_max():
    counts = {"gas": (400, 200), "dm": (300, 150), "star": (80, 40)}
    tables = {"dm": {"rows": 64, "n_s": 128, "n_q": 128},
              "star": {"rows": 32, "n_s": 64, "n_q": 64}}
    centers = [[-1000.0, 0, 0], [2000.0, 0, 0]]
    parts, fields = paths.merger_ic(
        [1e15, 5e14], [4.0, 5.0], centers, [[0.2, 0, 0], [-0.4, 0, 0]],
        5000.0, 0.1, counts, 3, 256, tables, "cpu")
    for sp, key in (("gas", "gas_mass"), ("dm", "dark_matter_mass"),
                    ("star", "stellar_mass")):
        m = parts[sp, "particle_mass"].double()
        inside = [np.interp(5000.0, fields["radius"][i], fields[key][i])
                  for i in (0, 1)]
        assert float(m.sum()) == pytest.approx(sum(inside), rel=1e-5)
        pos = parts[sp, "particle_position"].double()
        n0 = counts[sp][0]
        for i, sl in ((0, slice(0, n0)), (1, slice(n0, None))):
            r = (pos[sl] - torch.tensor(centers[i])).norm(dim=-1)
            assert float(r.max()) <= 5000.0 * (1 + 1e-6)
    assert bool((parts["gas", "thermal_energy"] > 0).all())
    assert bool(torch.isfinite(parts["dm", "particle_velocity"]).all())


def test_datagen_rows_are_the_clusters_own():
    kw = dict(counts={"dm": 50, "gas": 40, "star": 10}, seed=4, batch=3,
              num_points=128,
              tables={"dm": {"rows": 16, "n_s": 64, "n_q": 64},
                      "star": {"rows": 8, "n_s": 32, "n_q": 32}},
              quantiles={"dm": 128, "star": 64, "gas": 128}, z=0.1,
              device="cpu")
    m, c = np.array([2e14, 9e14, 1.5e15]), np.array([5.0, 4.0, 3.5])
    whole = paths.datagen_batch(m, c, **kw)
    one = paths.datagen_batch(m, c, rows=[2], **kw)
    for sp in whole:
        for a, b in zip(whole[sp], one[sp]):
            assert torch.equal(a[2], b[0])
