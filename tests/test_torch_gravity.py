"""The port's gravity laws and model build functions against the JAX
package's.

The same numpy inputs go through both.  Tolerances: rtol 1e-12 for the
laws (closed forms), 1e-9 for the built fields (the same quadrature
and splines in another summation order; ``build_from_dens_and_temp``
differentiates splines twice, which is why it is not tighter).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cluster_generator_tpu.model.builders as JB
import cluster_generator_tpu.model.gravity as JG
import cluster_generator_tpu.profiles as JP
import cluster_generator_tpu_torch.model.builders as TB
import cluster_generator_tpu_torch.model.gravity as TG
import cluster_generator_tpu_torch.profiles as TP
from cluster_generator_tpu.core.grid import numpy_log_radius_grid

torch.set_num_threads(1)

LAWS = ["newtonian", "aqual", "qumond", "emond"]
RR = numpy_log_radius_grid(0.1, 1e4, 160)
# enclosed mass of a cluster-sized sNFW halo: Newtonian inside, MONDian
# (|g_N| below a0) in the outskirts
MM = np.asarray(JP.snfw_mass_profile(1.5e15, 550.0)(jnp.asarray(RR)))
PHI = -np.geomspace(6.0, 0.02, RR.size)  # kpc^2/Myr^2, deep to shallow


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _close(got, want, rtol, atol=0.0, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


@pytest.mark.parametrize("law", LAWS)
@pytest.mark.parametrize("params", [None, {"a0_m_s2": 2.0e-10}])
def test_field_for_law_matches_jax(law, params):
    want = JG.field_for_law(jnp.asarray(RR), jnp.asarray(MM), law,
                            phi=jnp.asarray(PHI), params=params)
    got = TG.field_for_law(_t(RR), _t(MM), law, phi=_t(PHI), params=params)
    assert got.dtype == torch.float64 and bool((got < 0).all())
    _close(got.numpy(), np.asarray(want), rtol=1e-12, msg=law)
    # the registered function itself
    p = dict(params or {}, phi=_t(PHI)) if law == "emond" else params
    assert torch.equal(TG.get_gravity(law)(_t(RR), _t(MM), p), got)


def test_mond_limits_and_batched_rows():
    """Deep-MOND and Newtonian limits of the simple-mu inversion (y -> 0
    and y -> inf), and a leading halo axis carried through."""
    a0 = TG._a0_galactic(None)
    g_n = -a0 * _t([1e-12, 1e-6, 1.0, 1e6, 1e12])
    x = -TG._simple_mu_inverse(g_n, a0) / a0
    y = -g_n / a0
    _close(x[:2].numpy(), np.sqrt(y[:2].numpy()), rtol=1e-3)
    _close(x[-2:].numpy(), y[-2:].numpy(), rtol=2e-6)
    assert bool(torch.isfinite(TG._simple_mu_inverse(_t([0.0]), a0)).all())
    rr2 = _t(np.stack([RR, RR]))
    mm2 = _t(np.stack([MM, 0.3 * MM]))
    phi2 = _t(np.stack([PHI, 0.5 * PHI]))
    for law in LAWS:
        both = TG.field_for_law(rr2, mm2, law, phi=phi2)
        one = TG.field_for_law(_t(RR), _t(0.3 * MM), law, phi=_t(0.5 * PHI))
        _close(both[1].numpy(), one.numpy(), rtol=1e-14, msg=law)


@pytest.mark.parametrize("params", [None, {"a": 0.004, "A": 0.25,
                                           "p0": -6.0}])
def test_emond_a0_matches_jax(params):
    phi = np.concatenate([PHI, -PHI, [0.0, -1e-40, -1e3]])
    want = JG.emond_a0(jnp.asarray(phi), params)
    got = TG.emond_a0(_t(phi), params)
    _close(got.numpy(), np.asarray(want), rtol=1e-12)
    # even in phi, monotone in |phi|, the standard a0 in shallow potentials
    n = PHI.size
    assert torch.equal(got[:n], got[n:2 * n])
    assert bool((torch.diff(got[:n]) <= 0).all())
    if params is None:
        _close(float(got[-3]), TG._a0_galactic(None), rtol=1e-12)
        _close(float(got[-1]), TG._a0_galactic(None) * 0.30944 / 0.003868,
               rtol=1e-6)


@pytest.mark.parametrize("law", LAWS)
def test_dynamical_mass_matches_jax_and_inverts_the_law(law):
    g = TG.field_for_law(_t(RR), _t(MM), law, phi=_t(PHI))
    want = JG.dynamical_mass(jnp.asarray(RR), jnp.asarray(g.numpy()), law,
                             phi=jnp.asarray(PHI))
    got = TG.dynamical_mass(_t(RR), g, law, phi=_t(PHI))
    _close(got.numpy(), np.asarray(want), rtol=1e-12, msg=law)
    _close(got.numpy(), MM, rtol=1e-9, msg=law)  # the round trip


def test_unknown_laws_and_missing_potential_raise():
    with pytest.raises(KeyError, match="Unknown gravity law"):
        TG.get_gravity("tensor_vector_scalar")
    with pytest.raises(KeyError, match="Unknown gravity law"):
        TG.dynamical_mass(_t(RR), _t(MM), "tensor_vector_scalar")
    with pytest.raises(ValueError, match="phi"):
        TG.emond_field(_t(RR), _t(MM))
    with pytest.raises(ValueError, match="phi"):
        TG.dynamical_mass(_t(RR), _t(MM), "emond")


def test_register_gravity_adds_a_law():
    def half_newton(rr, m_tot, params=None):
        return 0.5 * TG.newtonian_field(rr, m_tot)

    TG.register_gravity("half_newton", half_newton)
    try:
        got = TG.field_for_law(_t(RR), _t(MM), "half_newton")
        _close(got.numpy(), 0.5 * TG.newtonian_field(_t(RR), _t(MM)).numpy(),
               rtol=0)
    finally:
        TG._REGISTRY.pop("half_newton")


# ------------------------------------------------------------ model builds
def _profiles(P):
    rhot = P.snfw_density_profile(1.9e15, 520.0)
    rhog = P.vikhlinin_density_profile(2.2e5, 100.0, 2000.0, 1.0, 0.67, 3.0)
    temp = P.vikhlinin_temperature_profile(6.0, 0.1, 2.0, 1.2, 900.0, 0.4,
                                           60.0, 1.9)
    return rhog, rhot, temp, 0.02 * rhot


def _compare_fields(got, want, law, rtol=1e-9):
    assert set(got) == set(want), law
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].dtype == torch.float64 and got[k].shape == w.shape
        # dark-matter mass and density pass through zero where the clamp
        # sets in: absolute floor of 1e-12 of the field's largest value
        _close(got[k].numpy(), w, rtol=rtol,
               atol=1e-12 * np.abs(w).max(), msg=f"{law}: {k}")


@pytest.mark.parametrize("law", LAWS)
def test_build_from_dens_and_tden_every_law(law):
    rhog_j, rhot_j, _, star_j = _profiles(JP)
    rhog_t, rhot_t, _, star_t = _profiles(TP)
    want = JB.build_from_dens_and_tden(jnp.asarray(RR), rhog_j, rhot_j,
                                       star_j, gravity=law)
    got = TB.build_from_dens_and_tden(_t(RR), rhog_t, rhot_t, star_t,
                                      gravity=law)
    _compare_fields(got, want, law)


@pytest.mark.parametrize("law", LAWS)
def test_build_from_dens_and_temp_every_law(law):
    rhog_j, _, temp_j, _ = _profiles(JP)
    rhog_t, _, temp_t, _ = _profiles(TP)
    star_j = JP.hernquist_density_profile(2e12, 30.0)
    star_t = TP.hernquist_density_profile(2e12, 30.0)
    want = JB.build_from_dens_and_temp(jnp.asarray(RR), rhog_j, temp_j,
                                       star_j, gravity=law)
    got = TB.build_from_dens_and_temp(_t(RR), rhog_t, temp_t, star_t,
                                      gravity=law)
    _compare_fields(got, want, law)


@pytest.mark.parametrize("law", LAWS)
def test_build_no_gas_every_law(law):
    _, rhot_j, _, star_j = _profiles(JP)
    _, rhot_t, _, star_t = _profiles(TP)
    want = JB.build_no_gas(jnp.asarray(RR), rhot_j, star_j, gravity=law)
    got = TB.build_no_gas(_t(RR), rhot_t, star_t, gravity=law)
    assert "density" not in got and "pressure" not in got
    _compare_fields(got, want, law)


def test_gravity_params_pass_through_every_build():
    rhog_j, rhot_j, temp_j, _ = _profiles(JP)
    rhog_t, rhot_t, temp_t, _ = _profiles(TP)
    params = {"a0_m_s2": 3.0e-10, "A": 0.2}
    for law in ("aqual", "emond"):
        want = JB.build_from_dens_and_tden(jnp.asarray(RR), rhog_j, rhot_j,
                                           gravity=law,
                                           gravity_params=params)
        got = TB.build_from_dens_and_tden(_t(RR), rhog_t, rhot_t,
                                          gravity=law, gravity_params=params)
        _compare_fields(got, want, law)
        base = TB.build_from_dens_and_tden(_t(RR), rhog_t, rhot_t,
                                           gravity=law)
        assert not torch.allclose(base["temperature"], got["temperature"],
                                  rtol=1e-3)
    want = JB.build_from_dens_and_temp(jnp.asarray(RR), rhog_j, temp_j,
                                       gravity="emond", gravity_params=params)
    got = TB.build_from_dens_and_temp(_t(RR), rhog_t, temp_t,
                                      gravity="emond", gravity_params=params)
    _compare_fields(got, want, "emond")


@pytest.mark.parametrize("law", ["aqual", "emond"])
def test_mond_build_carries_a_halo_axis(law):
    """Two halos at once give the rows that each gives alone (the ensemble
    build passes a gravity law down with batched profiles)."""
    M = _t([1.9e15, 6e14])
    a = _t([520.0, 380.0])
    rr2 = _t(np.stack([RR, RR]))
    rhog = TP.vikhlinin_density_profile(_t([2.2e5, 1.1e5]), 100.0,
                                        _t([2000.0, 1500.0]), 1.0, 0.67, 3.0)
    both = TB.build_from_dens_and_tden(rr2, rhog,
                                       TP.snfw_density_profile(M, a),
                                       0.02 * TP.snfw_density_profile(M, a),
                                       gravity=law)
    one = TB.build_from_dens_and_tden(
        _t(RR), TP.vikhlinin_density_profile(1.1e5, 100.0, 1500.0, 1.0, 0.67,
                                             3.0),
        TP.snfw_density_profile(6e14, 380.0),
        0.02 * TP.snfw_density_profile(6e14, 380.0), gravity=law)
    for k, v in one.items():
        _close(both[k][1].numpy(), v.numpy(), rtol=1e-12,
               atol=1e-13 * float(v.abs().max()), msg=k)
