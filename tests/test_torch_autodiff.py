"""Gradients through the port's profiles, model build and DF, against
central differences and the JAX package's ``jax.grad``: the four cases of
tests/test_autodiff.py, on the CPU.

r_delta of ``find_radius_mass`` carries the implicit-function gradient
(the JAX package's ``lax.custom_root``); without it the gradient of the
central pressure with respect to M200 was 5.2% off.  Tolerances: the JAX
tests' own (1e-12 for the linear mass profile, 1e-3 and 5e-3 of a central
difference), and 1e-6 between the two packages' autodiff gradients (the
same float64 arithmetic up to libm and summation order; a central
difference agrees with either only to ~1e-7).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cluster_generator_tpu_torch as cg
from cluster_generator_tpu.parallel.ensemble import build_one_cluster as j_build
from cluster_generator_tpu_torch.parallel.ensemble import build_one_cluster

torch.set_num_threads(1)


def _f64(x, grad=False):
    return torch.tensor(np.atleast_1d(x), dtype=torch.float64,
                        requires_grad=grad)


def _central_pressure(m200):
    return build_one_cluster(m200, _f64(4.0), num_points=256,
                             with_df=False)["pressure"][..., 0].sum()


def _grad(fn, x):
    x = _f64(x, grad=True)
    fn(x).backward()
    return float(x.grad[0])


def _central_difference(fn, x, eps):
    with torch.no_grad():
        return (float(fn(_f64(x + eps))) - float(fn(_f64(x - eps)))) / (2 * eps)


def test_profile_param_gradients():
    """d/dM0 of the Hernquist mass profile == M(r)/M0 (linearity)."""

    def mass_at(M0):
        return cg.hernquist_mass_profile(M0, 600.0)(
            torch.tensor([500.0], dtype=torch.float64))[0]

    g = _grad(mass_at, 1.0e15)
    with torch.no_grad():
        expected = float(mass_at(_f64(1.0e15))) / 1.0e15
    assert abs(g - expected) / expected < 1e-12


def test_grad_through_hse_build():
    """d(central pressure)/dM200 through the whole build (profiles ->
    bisection -> quadrature -> splines): within 1e-3 of a central
    difference and within 1e-6 of the JAX package's jax.grad."""
    g = _grad(_central_pressure, 1.5e15)
    fd = _central_difference(_central_pressure, 1.5e15, 1.0e10)
    assert math.isfinite(g)
    assert abs(g - fd) / abs(fd) < 1e-3, (g, fd)

    def j_central_pressure(M200):
        return j_build(M200, 4.0, num_points=256, with_df=False)["pressure"][0]

    jg = float(jax.grad(j_central_pressure)(1.5e15))
    assert abs(g - jg) / abs(jg) < 1e-6, (g, jg)


def test_grad_through_eddington_df():
    """f(E) is differentiable w.r.t. cluster mass too."""

    def df_mid(m200):
        return build_one_cluster(m200, _f64(4.0), num_points=256,
                                 with_df=True)["dm_df"][..., 128].sum()

    g = _grad(df_mid, 1.5e15)
    fd = _central_difference(df_mid, 1.5e15, 5.0e10)
    assert math.isfinite(g)
    assert abs(g - fd) / abs(fd) < 5e-3, (g, fd)


def test_per_halo_gradients_over_a_batch():
    """Each halo of a 3-halo batch gets its own gradient of its max T, and
    hotter clusters come with higher mass; the same numbers as jax.vmap of
    jax.grad over the JAX package's build."""
    M = _f64([1.0e15, 1.5e15, 2.0e15], grad=True)
    c = _f64([4.0, 5.0, 6.0], grad=True)
    f = build_one_cluster(M, c, num_points=128, with_df=False)
    f["temperature"].max(dim=-1).values.sum().backward()
    gM, gc = M.grad.numpy(), c.grad.numpy()
    assert np.isfinite(gM).all() and np.isfinite(gc).all()
    assert (gM > 0).all()

    def tmax(M200, conc):
        return jnp.max(j_build(M200, conc, num_points=128,
                               with_df=False)["temperature"])

    jM, jc = jax.vmap(jax.grad(tmax, argnums=(0, 1)))(
        jnp.asarray([1.0e15, 1.5e15, 2.0e15]), jnp.asarray([4.0, 5.0, 6.0]))
    np.testing.assert_allclose(gM, np.asarray(jM), rtol=1e-6)
    np.testing.assert_allclose(gc, np.asarray(jc), rtol=1e-6)


def test_unbracketed_root_is_nan_and_passes_no_gradient():
    """A halo whose mean density never crosses delta rho_crit in
    [0.01, 10000] kpc (a Hernquist halo of 1e3 Msun) gets NaN, and backward
    through it raises nothing and passes it no gradient; the other halo of
    the batch (1e15 Msun) keeps its own gradient, which matches a central
    difference."""
    A = _f64([1.0e-12, 1.0], grad=True)
    r, m = cg.find_radius_mass(cg.hernquist_mass_profile(A * 1.0e15, 600.0),
                               delta=500.0, like=A)
    assert torch.isnan(r[0]) and torch.isnan(m[0])
    assert torch.isfinite(r[1]) and torch.isfinite(m[1])
    r.sum().backward()
    g = A.grad.numpy()
    assert g[0] == 0.0 and np.isfinite(g[1])
    eps = 1e-4
    with torch.no_grad():
        up, dn = (float(cg.find_radius_mass(
            cg.hernquist_mass_profile(_f64(a * 1.0e15), 600.0), delta=500.0,
            like=A[1:])[0][0]) for a in (1.0 + eps, 1.0 - eps))
    assert abs(g[1] - (up - dn) / (2 * eps)) / abs(g[1]) < 1e-6
