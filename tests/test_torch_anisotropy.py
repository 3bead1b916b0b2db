"""Osipkov-Merritt anisotropy, tracers and potentials in the PyTorch port,
against the JAX package on the CPU.

* ``om_extended_df``, ``compute_df_truncated`` and ``check_virial_density``
  get the same float64 inputs as their JAX twins (model grids of clusters
  whose (M200, c) come from a numpy seed).  The DF is the derivative of a
  spline through an Abel sum, which amplifies roundoff: on the model grid
  the two packages agree to rtol 1e-8; on the power-law extension below
  it, where f(E) diverges as E -> 0 and the sum cancels over 192 extra
  knots, to rtol 1e-6.  ``check_virial_density`` agrees to rtol 1e-6: with
  splines equal to 5e-14, its closed-form interval terms cancel to ~1e-9
  of their size in mid-grid, so the two packages' summation orders differ
  by up to 3.3e-7 there (each is 3.4e-6 from the target density).
* The OM DF is held to the JAX test's own yardstick
  (tests/test_anisotropy.py): ``check_virial_density`` on the extended grid
  reconstructs the augmented density to 1e-4 inside 150 kpc, 1e-3 inside
  1 Mpc and 1e-2 up to r_max.
* ``merger_ic_fused`` with ``r_a``, tracers and potentials runs through both
  packages with the uniforms ``jax.random`` gives at each of the JAX
  function's random sites, at the tolerances of tests/test_torch_pipeline.py;
  potentials, a lerp of float32 tables like the gas energy, at rtol 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cluster_generator_tpu import pipeline as JP
from cluster_generator_tpu import virial as JV
from cluster_generator_tpu.parallel.ensemble import (
    build_one_cluster as j_build_one_cluster,
)
from cluster_generator_tpu_torch import pipeline as TP
from cluster_generator_tpu_torch import virial as TV
from cluster_generator_tpu_torch.convert import to_numpy

torch.set_num_threads(1)

R_A = 1500.0
N_EXT = 192


@pytest.fixture(scope="module")
def grids():
    """Ascending-energy grids and OM-augmented DM and star densities of
    three clusters: the canonical (1.5e15, 4) and two from a numpy seed."""
    rng = np.random.RandomState(5)
    M200 = np.concatenate([[1.5e15], 10.0 ** rng.uniform(14.0, 15.3, 2)])
    conc = np.concatenate([[4.0], rng.uniform(3.0, 8.0, 2)])
    build = jax.jit(lambda m, c: j_build_one_cluster(m, c, num_points=1000,
                                                     with_df=False))
    ee, dm, star, rr = [], [], [], []
    for m, c in zip(M200, conc):
        f = {k: np.asarray(v) for k, v in build(m, c).items()}
        aug = 1.0 + (f["radius"] / R_A) ** 2
        ee.append(-f["gravitational_potential"][::-1])
        dm.append((f["dark_matter_density"] * aug)[::-1])
        star.append((f["stellar_density"] * aug)[::-1])
        rr.append(f["radius"])
    return {"ee": np.stack(ee), "dm": np.stack(dm), "star": np.stack(star),
            "radius": np.stack(rr)}


@pytest.mark.parametrize("kind", ["dm", "star"])
def test_om_extended_df_matches_jax(grids, kind):
    ee, pden = grids["ee"], grids[kind]
    ee_ext, f_ext = TV.om_extended_df(torch.from_numpy(ee),
                                      torch.from_numpy(pden))
    assert ee_ext.shape == f_ext.shape == (3, N_EXT + 1000)
    for i in range(3):
        j_ee, j_f = JV.om_extended_df(jnp.asarray(ee[i]),
                                      jnp.asarray(pden[i]))
        np.testing.assert_allclose(ee_ext[i].numpy(), np.asarray(j_ee),
                                   rtol=1e-13)
        np.testing.assert_allclose(f_ext[i, N_EXT:].numpy(),
                                   np.asarray(j_f)[N_EXT:], rtol=1e-8)
        np.testing.assert_allclose(f_ext[i, :N_EXT].numpy(),
                                   np.asarray(j_f)[:N_EXT], rtol=1e-6)


def test_compute_df_truncated_matches_jax(grids):
    ee, pden = grids["ee"], grids["dm"]
    got = TV.compute_df_truncated(torch.from_numpy(ee),
                                  torch.from_numpy(pden))
    assert got.shape == ee.shape
    for i in range(3):
        want = JV.compute_df_truncated(jnp.asarray(ee[i]),
                                       jnp.asarray(pden[i]))
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want),
                                   rtol=1e-8)


def test_check_virial_density_matches_jax_and_reconstructs_rho_q(grids):
    ee, pden, rr = grids["ee"], grids["dm"], grids["radius"]
    ee_ext, f_ext = TV.om_extended_df(torch.from_numpy(ee),
                                      torch.from_numpy(pden))
    rho = TV.check_virial_density(ee_ext, f_ext)
    for i in range(3):
        want = JV.check_virial_density(jnp.asarray(ee_ext[i].numpy()),
                                       jnp.asarray(f_ext[i].numpy()))
        np.testing.assert_allclose(rho[i].numpy(), np.asarray(want),
                                   rtol=1e-6)
    # the canonical cluster, at the JAX test's bounds (radial ordering)
    chk = (rho[0, N_EXT:].numpy()[::-1] - pden[0][::-1]) / pden[0][::-1]
    r = rr[0]
    assert np.abs(chk[(r > 0.5) & (r < 150.0)]).max() < 1e-4
    assert np.abs(chk[r < 1000.0]).max() < 1e-3
    assert np.abs(chk).max() < 0.01
    assert (f_ext[0].numpy() >= 0).all()


def test_r_a_must_be_positive():
    for bad in (0.0, -5.0):
        with pytest.raises(ValueError, match="positive"):
            TP.build_merger_models([1.5e15], [4.0], r_a=bad, device="cpu")


# ------------------------------------------- the merger IC with every switch
M200 = [1.5e15, 1.0e15]
CONC = [4.0, 5.0]
CENTERS = [[-1500.0, 0.0, 0.0], [1500.0, 0.0, 0.0]]
VELS = [[0.3, 0.0, 0.0], [-0.45, 0.0, 0.0]]
R_MAX = [5000.0, 5000.0]
NG, ND, NS, NT = (1500, 1000), (1200, 800), (300, 200), (250, 150)


def _jax_uniforms(key):
    """The uniforms of JP.sample_merger_ic at every random site, as the
    port's ``uniforms``: 4H keys (pipeline.py:397), a collisionless key
    split into 5 (:279), a gas or tracer key into 2 (:319), a direction
    key into 2 (:220)."""
    f32 = jnp.float32

    def iso(k, n):
        k1, k2 = jax.random.split(k)
        return (jax.random.uniform(k1, (n,), minval=-1.0, maxval=1.0,
                                   dtype=f32),
                jax.random.uniform(k2, (n,), dtype=f32))

    def t(tree):
        if isinstance(tree, tuple):
            return tuple(t(x) for x in tree)
        return torch.tensor(np.asarray(tree))

    keys = jax.random.split(key, 4 * 2)
    out = {}
    for i in range(2):
        for kind, n, off in (("gas", NG, 0), ("tracer", NT, 3)):
            kr, ka = jax.random.split(keys[4 * i + off])
            out[kind, i] = t((jax.random.uniform(kr, (n[i],), dtype=f32),
                              iso(ka, n[i])))
        for kind, n, off in (("dm", ND, 1), ("star", NS, 2)):
            kr, kv, kb, ka, kva = jax.random.split(keys[4 * i + off], 5)
            out[kind, i] = t(tuple(jax.random.uniform(k, (n[i],), dtype=f32)
                                   for k in (kr, kv, kb))
                             + (iso(ka, n[i]), iso(kva, n[i])))
    return out


@pytest.fixture(scope="module")
def runs():
    key = jax.random.key(3)
    j_parts, j_fields = JP.merger_ic_fused(
        jnp.asarray(M200), jnp.asarray(CONC), jnp.asarray(CENTERS),
        jnp.asarray(VELS), jnp.asarray(R_MAX), key, NG, ND, NS, n_tracer=NT,
        compute_potential=True, r_a=R_A)
    t_parts, t_fields = TP.merger_ic_fused(
        M200, CONC, CENTERS, VELS, R_MAX, NG, ND, NS, n_tracer=NT,
        compute_potential=True, r_a=R_A, uniforms=_jax_uniforms(key),
        device="cpu")
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa
    return (to_np(j_parts), to_np(j_fields), to_numpy(t_parts),
            to_numpy(t_fields))


def test_om_fields_match(runs):
    _, j_fields, _, t_fields = runs
    assert set(t_fields) == set(j_fields)
    for k, want in j_fields.items():
        got = t_fields[k]
        assert got.shape == want.shape and got.dtype == want.dtype, k
        if k.endswith("_df_ext"):
            np.testing.assert_allclose(got[:, N_EXT:], want[:, N_EXT:],
                                       rtol=1e-6, err_msg=k)
            np.testing.assert_allclose(got[:, :N_EXT], want[:, :N_EXT],
                                       rtol=1e-5, err_msg=k)
        else:
            tol = 1e-6 if k.endswith("_df") else 1e-9
            np.testing.assert_allclose(got, want, rtol=tol, err_msg=k)


def test_om_tracer_potential_draws_match(runs):
    j_parts, _, t_parts, _ = runs
    assert set(t_parts) == set(j_parts)
    bulk = {sp: np.concatenate([np.repeat(np.asarray(VELS[i])[None], n[i], 0)
                                for i in range(2)])
            for sp, n in (("dm", ND), ("star", NS))}
    vmax = max(abs(v[0]) for v in VELS)
    for (sp, name), a in j_parts.items():
        b = t_parts[sp, name]
        assert b.shape == a.shape and b.dtype == np.float32, (sp, name)
        a, b = a.astype(np.float64), b.astype(np.float64)
        if sp == "tracer" and name != "particle_position":
            assert not b.any(), (sp, name)  # massless and at rest
        elif name == "particle_velocity" and sp == "gas":
            assert np.abs(a - b).max() < 2e-5 * vmax
        elif name == "particle_velocity":
            # the anisotropic velocity as a vector about the bulk motion
            va, vb = a - bulk[sp], b - bulk[sp]
            rel = (np.linalg.norm(va - vb, axis=1)
                   / np.linalg.norm(va, axis=1))
            assert (rel > 1e-4).mean() <= 2e-3, (sp, rel.max())
        elif a.ndim == 2:
            rel = np.linalg.norm(a - b, axis=1) / np.linalg.norm(a, axis=1)
            assert rel.max() < 2e-5, (sp, name, rel.max())
        else:
            np.testing.assert_allclose(b, a, rtol=2e-5,
                                       err_msg=f"{sp} {name}")


def test_om_draws_are_radially_biased(runs):
    """The drawn DM of halo 1 is radially anisotropic outside r_a and the
    tangential components shrink by gamma(r): beta rises with radius."""
    _, _, t_parts, _ = runs
    n1 = ND[0]
    pos = t_parts["dm", "particle_position"][:n1].astype(np.float64)
    vel = t_parts["dm", "particle_velocity"][:n1].astype(np.float64)
    pos -= np.asarray(CENTERS[0])
    vel -= np.asarray(VELS[0])
    r = np.linalg.norm(pos, axis=1)
    v_r = (vel * pos).sum(axis=1) / r
    v_t2 = (vel ** 2).sum(axis=1) - v_r ** 2
    out = r > R_A
    beta = 1.0 - v_t2[out].mean() / (2.0 * (v_r[out] ** 2).mean())
    assert out.sum() > 200 and beta > 0.3
