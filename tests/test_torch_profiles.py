"""The port's profile library, profile algebra, relations, units and
interpolation helpers against the JAX package's, on the same numpy radius
grid.

Tolerances: rtol 1e-12 for the closed forms (the same formulas in the
same order; only libm differs; plus 1e-15 of the profile's largest value,
for the mass profiles that cancel near r = 0), 1e-10 where ``gammainc``/``gammaln`` enter
(Einasto), 1e-6 for a mass profile against the quadrature of its density.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cluster_generator_tpu.core.units as JU
import cluster_generator_tpu.profiles as JP
import cluster_generator_tpu.profiles.relations as JR
import cluster_generator_tpu_torch.core.interp as TI
import cluster_generator_tpu_torch.core.units as TU
import cluster_generator_tpu_torch.profiles as TP
import cluster_generator_tpu_torch.profiles.relations as TR
from cluster_generator_tpu.core.quadrature import integrate_mass as j_imass
from cluster_generator_tpu_torch.core.quadrature import (
    integrate_mass as t_imass,
)

# the JAX package's core/__init__ exports a function named ``interp``,
# which hides the module of that name from ``import ... as``
JI = importlib.import_module("cluster_generator_tpu.core.interp")

torch.set_num_threads(1)

RTOL = 1e-12
R = np.geomspace(1e-2, 1e4, 97)

# every profile factory of the library with one parameter set
LIBRARY = {
    "constant_profile": (3.5,),
    "power_law_profile": (2.0e6, 120.0, -1.7),
    "beta_model_profile": (1.0e7, 150.0, 0.67),
    "hernquist_density_profile": (1.0e15, 400.0),
    "cored_hernquist_density_profile": (1.0e15, 400.0, 3.0),
    "hernquist_mass_profile": (1.0e15, 400.0),
    "nfw_density_profile": (2.0e6, 350.0),
    "nfw_mass_profile": (2.0e6, 350.0),
    "tnfw_density_profile": (2.0e6, 350.0, 2500.0),
    "tnfw_mass_profile": (2.0e6, 350.0, 2500.0),
    "snfw_density_profile": (1.2e15, 600.0),
    "snfw_mass_profile": (1.2e15, 600.0),
    "cored_snfw_density_profile": (1.2e15, 600.0, 80.0),
    "cored_snfw_mass_profile": (1.2e15, 600.0, 80.0),
    "einasto_density_profile": (1.0e15, 500.0, 5.0),
    "einasto_mass_profile": (1.0e15, 500.0, 5.0),
    "am06_density_profile": (1.0e6, 600.0, 60.0, 0.17, 5.0),
    "vikhlinin_density_profile": (1.0e6, 100.0, 1500.0, 1.0, 0.67, 3.0),
    "vikhlinin_temperature_profile": (5.0, 0.1, 2.0, 1.2, 900.0, 0.4, 60.0,
                                      1.9),
    "am06_temperature_profile": (8.0, 600.0, 60.0, 0.17),
    "baseline_entropy_profile": (10.0, 1500.0, 2000.0, 1.1),
    "broken_entropy_profile": (300.0, 120.0, 0.6, 0.05),
    "walker_entropy_profile": (2000.0, 4.4, 1.0, 1200.0, 1.1),
}
GAMMA_BASED = {"einasto_density_profile", "einasto_mass_profile"}


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _close(got, want, rtol=RTOL, atol=0.0, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


def test_library_lists_agree():
    """The port exports every name of the JAX package's profile layer."""
    assert set(JP.__all__) <= set(TP.__all__)
    import cluster_generator_tpu.profiles.library as JL
    import cluster_generator_tpu_torch.profiles.library as TL

    assert JL.__all__ == TL.__all__
    factories = {n for n in JL.__all__ if n.endswith("_profile")}
    assert factories == set(LIBRARY)


@pytest.mark.parametrize("name", sorted(LIBRARY))
def test_library_profile_matches_jax(name):
    args = LIBRARY[name]
    want = np.asarray(getattr(JP, name)(*args)(jnp.asarray(R)))
    got = getattr(TP, name)(*args)(_t(R))
    assert got.dtype == torch.float64 and got.shape == R.shape
    assert np.all(np.isfinite(want))
    # atol: the cumulative closed forms (cored sNFW, tNFW) subtract terms
    # of the size of the total mass, so near r = 0 they hold ~1e-16 of it
    # in absolute terms in either package
    _close(got.numpy(), want, rtol=1e-10 if name in GAMMA_BASED else RTOL,
           atol=1e-15 * np.abs(want).max(), msg=name)


@pytest.mark.parametrize("name", ["vikhlinin_density_profile",
                                  "cored_snfw_mass_profile",
                                  "einasto_mass_profile",
                                  "tnfw_mass_profile"])
def test_library_profile_with_batched_parameters(name):
    """Tensor parameters with a leading halo axis give one row per halo,
    each equal to the scalar-parameter profile."""
    args = LIBRARY[name]
    scale = np.array([1.0, 1.3, 0.6])
    batched = tuple(_t(a * scale) for a in args)
    got = getattr(TP, name)(*batched)(_t(np.broadcast_to(R, (3, R.size))))
    assert got.shape == (3, R.size)
    for i, s in enumerate(scale):
        want = getattr(TP, name)(*(a * s for a in args))(_t(R))
        _close(got[i].numpy(), want.numpy(), rtol=1e-13)


@pytest.mark.parametrize("r_c", [80.0, 590.0, 610.0, 4000.0])
def test_cored_snfw_mass_on_both_sides_of_the_core(r_c):
    """b = a / r_c above and below 1, and on both sides of the removable
    singularity at r_c -> a, where the closed form loses ~1/(b-1)^2 of its
    digits in both packages alike (hence rtol 1e-9 and an absolute 1e-11
    of the total mass there, 1e-13 of it elsewhere)."""
    args = (1.2e15, 600.0, r_c)
    want = np.asarray(JP.cored_snfw_mass_profile(*args)(jnp.asarray(R)))
    got = TP.cored_snfw_mass_profile(*args)(_t(R)).numpy()
    near = abs(r_c - 600.0) < 20.0
    assert np.all(np.diff(got[R > 100.0]) > 0) and 0 < got[-1] < 1.2e15
    _close(got, want, rtol=1e-9 if near else RTOL,
           atol=(1e-11 if near else 1e-13) * want.max())
    _close(float(TP.cored_snfw_total_mass(1e15, 2000.0, 600.0, r_c,
                                          device="cpu")),
           float(JP.cored_snfw_total_mass(1e15, 2000.0, 600.0, r_c)),
           rtol=1e-9 if near else RTOL)


@pytest.mark.parametrize("dens,mass,args", [
    ("hernquist_density_profile", "hernquist_mass_profile", (1e15, 400.0)),
    ("nfw_density_profile", "nfw_mass_profile", (2e6, 350.0)),
    ("tnfw_density_profile", "tnfw_mass_profile", (2e6, 350.0, 2500.0)),
    ("snfw_density_profile", "snfw_mass_profile", (1.2e15, 600.0)),
    ("cored_snfw_density_profile", "cored_snfw_mass_profile",
     (1.2e15, 600.0, 80.0)),
    ("cored_snfw_density_profile", "cored_snfw_mass_profile",
     (1.2e15, 600.0, 4000.0)),
    ("einasto_density_profile", "einasto_mass_profile", (1e15, 500.0, 5.0)),
])
def test_mass_profile_is_the_integral_of_its_density(dens, mass, args):
    rr = _t(np.geomspace(1e-2, 1e4, 400))
    want = t_imass(getattr(TP, dens)(*args), rr).numpy()
    got = getattr(TP, mass)(*args)(rr).numpy()
    # atol: a closed form that subtracts terms of the size of the total
    # mass holds ~1e-15 of it near r = 0
    _close(got, want, rtol=1e-6, atol=1e-14 * want.max(), msg=mass)
    # and the port's quadrature is the JAX package's
    _close(want, np.asarray(j_imass(getattr(JP, dens)(*args),
                                    jnp.asarray(rr.numpy()))), rtol=1e-11)


def test_scalar_helpers_match_jax():
    import cluster_generator_tpu.profiles.library as JL
    import cluster_generator_tpu_torch.profiles.library as TL

    for c in (3.0, 7.5):
        _close(TL.nfw_scale_density(c, z=0.2), float(
            JL.nfw_scale_density(c, z=0.2)))
        _close(TL.snfw_conc(c), JL.snfw_conc(c))
        got = TL.convert_nfw_to_hernquist(1e15, 2000.0, c)
        want = JL.convert_nfw_to_hernquist(1e15, 2000.0, c)
        _close([float(g) for g in got], [float(w) for w in want])
        tg = TL.convert_nfw_to_hernquist(_t([1e15, 2e14]), _t([2000.0, 900.]),
                                         _t([c, c]))
        _close(float(tg[1][0]), float(want[1]))
    _close(TL.snfw_total_mass(1e15, 2000.0, 500.0),
           float(JL.snfw_total_mass(1e15, 2000.0, 500.0)))


OPERATORS = {
    "add": lambda a, b: a + b, "radd": lambda a, b: 2.5 + a,
    "sub": lambda a, b: a - b, "sub_scalar": lambda a, b: a - 0.5,
    "mul": lambda a, b: a * b, "rmul": lambda a, b: 0.02 * a,
    "div": lambda a, b: a / b, "div_scalar": lambda a, b: a / 3.0,
    "pow": lambda a, b: a ** 1.5,
    "add_core": lambda a, b: a.add_core(25.0, 2.0),
    "cutoff": lambda a, b: a.cutoff(2000.0),
    "cutoff_k": lambda a, b: a.cutoff(2000.0, k=9),
    "chain": lambda a, b: ((a + b) * 2.0 / (b ** 0.5) - a).add_core(
        10.0, 1.0).cutoff(3000.0),
}


@pytest.mark.parametrize("op", sorted(OPERATORS))
def test_profile_operator_matches_jax(op):
    fn = OPERATORS[op]
    want = fn(JP.beta_model_profile(1e7, 150.0, 0.67),
              JP.nfw_density_profile(2e6, 350.0))(jnp.asarray(R))
    got = fn(TP.beta_model_profile(1e7, 150.0, 0.67),
             TP.nfw_density_profile(2e6, 350.0))(_t(R))
    # the core's 1 - exp(-x) holds ~1e-16 / x of its value, and x falls to
    # 1.6e-7 on this grid: the two libms' exp may differ there by ~1e-9
    rtol = 1e-8 if op in ("add_core", "chain") else RTOL
    _close(got.numpy(), np.asarray(want), rtol=rtol, msg=op)


def test_composed_profiles_keep_batched_parameters():
    """A composition of profiles with per-halo tensor parameters stays
    batched (the ensemble build relies on it for ``c * profile``)."""
    M = _t([1e15, 4e14])
    a = _t([500.0, 300.0])
    rr = _t(np.broadcast_to(R, (2, R.size)))
    comp = (0.02 * TP.snfw_density_profile(M, a)
            + TP.beta_model_profile(_t([1e6, 2e6]), 100.0, 0.6)) ** 2
    got = comp(rr)
    nodes = comp(rr[:, :-1, None] * _t([1.0, 1.5]))  # quadrature-like axes
    assert got.shape == (2, R.size) and nodes.shape == (2, R.size - 1, 2)
    for i in range(2):
        one = (0.02 * TP.snfw_density_profile(float(M[i]), float(a[i]))
               + TP.beta_model_profile([1e6, 2e6][i], 100.0, 0.6)) ** 2
        _close(got[i].numpy(), one(_t(R)).numpy(), rtol=1e-13)


def test_from_array_profile_interpolates_like_jax():
    y = np.asarray(JP.snfw_density_profile(1e15, 500.0)(jnp.asarray(R)))
    rq = np.geomspace(2e-2, 9e3, 211)
    from cluster_generator_tpu.profiles.algebra import (
        from_array_profile as j_from,
    )

    want = np.asarray(j_from(R, y)(jnp.asarray(rq)))
    for prof in (TP.from_array_profile(R, y, device="cpu"),
                 TP.Profile.from_array(R, y, device="cpu"),
                 TP.RadialProfile.from_array(_t(R), _t(y))):
        _close(prof(_t(rq)).numpy(), want, rtol=1e-10)
    # composes and integrates like any profile (quadrature node axes)
    prof = 2.0 * TP.from_array_profile(R, y, device="cpu")
    assert prof(_t(rq).reshape(1, -1).expand(3, -1).reshape(3, -1, 1)).shape \
        == (3, rq.size, 1)
    _close(t_imass(prof, _t(R))[-1].item(),
           2.0 * t_imass(TP.from_array_profile(R, y, device="cpu"),
                         _t(R))[-1].item())
    # radii given as an array go where they are asked to go
    _close(prof(rq, device="cpu").numpy(), 2.0 * want, rtol=1e-10)


def test_rescale_and_relations_match_jax():
    prof = (1.0, 100.0, 2100.0, 1.0, 0.67, 3.0)
    want = JP.rescale_profile_by_mass(JP.vikhlinin_density_profile(*prof),
                                      9e13, 1300.0)
    got = TP.rescale_profile_by_mass(TP.vikhlinin_density_profile(*prof),
                                     9e13, 1300.0, device="cpu")
    _close(got(_t(R)).numpy(), np.asarray(want(jnp.asarray(R))), rtol=1e-11)
    _close(float(TP.mass_within(got, 1300.0, device="cpu")), 9e13,
           rtol=1e-10)
    m = np.array([3e13, 2e14, 1.1e15])
    for name in ("f_gas", "m_bcg", "m_sat"):
        _close(getattr(TR, name)(_t(m)).numpy(),
               np.asarray(getattr(JR, name)(jnp.asarray(m))), msg=name)
        one = getattr(TR, name)(2e14)
        assert isinstance(one, float)  # a float stays one, tied to no device
        _close(one, float(getattr(JR, name)(2e14)))
    _close(TR.r_bcg(_t([900.0, 2100.0])).numpy(),
           np.asarray(JR.r_bcg(jnp.asarray([900.0, 2100.0]))))
    _close(TR.convert_ne_to_density(_t([1e-3, 0.1])).numpy(),
           np.asarray(JR.convert_ne_to_density(jnp.asarray([1e-3, 0.1]))))
    ne = TR.convert_ne_to_density(TP.beta_model_profile(1e-2, 100.0, 0.6))
    _close(ne(_t(R)).numpy(), np.asarray(JR.convert_ne_to_density(
        JP.beta_model_profile(1e-2, 100.0, 0.6))(jnp.asarray(R))))


# -------------------------------------------------------------------- units
def test_units_tables_and_factors_are_the_jax_package_s():
    assert TU.FIELD_UNITS == JU.FIELD_UNITS and TU.CGS_UNITS == JU.CGS_UNITS
    assert TU._REGISTRY == JU._REGISTRY
    for unit in JU._REGISTRY:
        assert TU.unit_factor(unit) == JU.unit_factor(unit)
    for field in JU.FIELD_UNITS:
        assert (TU.galactic_to_cgs_factor(field)
                == JU.galactic_to_cgs_factor(field))
    assert TU.conversion_factor("km/s", "cm/s") == JU.conversion_factor(
        "km/s", "cm/s")
    x = np.array([1.0, 2.5])
    for fn in ("keV_to_K", "K_to_keV", "ne_to_density", "density_to_ne"):
        _close(getattr(TU, fn)(_t(x)).numpy(), getattr(JU, fn)(x), msg=fn)
    _close(TU.to_galactic(_t(x), "Mpc").numpy(), JU.to_galactic(x, "Mpc"))
    _close(TU.from_galactic(x, "km/s"), JU.from_galactic(x, "km/s"))
    _close(TU.to_field_units(_t(x), "g/cm**3", "density").numpy(),
           JU.to_field_units(x, "g/cm**3", "density"))
    _close(TU.to_field_units(_t(x), "uG", "magnetic_field_strength").numpy(),
           JU.to_field_units(x, "uG", "magnetic_field_strength"))


@pytest.mark.parametrize("call,exc", [
    (lambda U: U.unit_factor("furlong"), KeyError),
    (lambda U: U.conversion_factor("gauss", "kpc/Myr"), ValueError),
    (lambda U: U.to_field_units(np.ones(2), "K", "temperature"), ValueError),
    (lambda U: U.to_field_units(np.ones(2), "kpc", "density"), ValueError),
])
def test_units_refuse_what_the_jax_package_refuses(call, exc):
    for U in (JU, TU):
        with pytest.raises(exc):
            call(U)


# ------------------------------------------------------------ interpolation
def test_loguniform_spline_and_shared_bracket_match_jax():
    x = np.geomspace(0.1, 1e4, 200)
    y = np.asarray(JP.snfw_mass_profile(1e15, 500.0)(jnp.asarray(x)))
    rng = np.random.RandomState(3)
    # queries off the knots (on a knot either neighbouring interval is a
    # valid choice, same value), some beyond both ends of the grid
    xq = np.concatenate([np.exp(rng.uniform(np.log(0.1), np.log(1e4), 500)),
                         [0.02, 0.0999, 1.0001e4, 3e4]])
    sp_j = JI.cubic_spline(jnp.asarray(x), jnp.asarray(y))
    sp_t = TI.cubic_spline(_t(x), _t(y))
    _close(TI.spline_eval_loguniform(sp_t, _t(xq)).numpy(),
           np.asarray(JI.spline_eval_loguniform(sp_j, jnp.asarray(xq))),
           rtol=1e-9)
    # on the knots: the values, not the intervals
    _close(TI.spline_eval_loguniform(sp_t, _t(x)).numpy(), y, rtol=1e-9)
    idx = TI.bracket_for_spline(_t(x), _t(xq))
    np.testing.assert_array_equal(
        idx.numpy(), np.asarray(JI.bracket_for_spline(jnp.asarray(x),
                                                      jnp.asarray(xq))))
    assert torch.equal(TI.spline_eval_at(sp_t, _t(xq), idx),
                       TI.spline_eval(sp_t, _t(xq)))
    _close(TI.spline_eval_at(sp_t, _t(xq), idx).numpy(),
           np.asarray(JI.spline_eval_at(sp_j, jnp.asarray(xq),
                                        jnp.asarray(idx.numpy()))),
           rtol=1e-9)
    assert TI.is_loguniform(_t(x)) and JI.is_loguniform(x)
    bent = x.copy()
    bent[50] *= 1.0001
    assert not TI.is_loguniform(_t(bent)) and not JI.is_loguniform(bent)


def test_interp_left_and_right_match_jax():
    x = np.array([1.0, 2.0, 4.0, 8.0])
    y = np.array([3.0, 5.0, 4.0, 9.0])
    xq = np.array([0.5, 1.0, 1.5, 3.0, 8.0, 9.0])
    for kw in ({}, {"left": -1.0}, {"right": 7.5}, {"left": 0.0,
                                                      "right": 1.0}):
        got = TI.interp(_t(xq), _t(x), _t(y), **kw).numpy()
        _close(got, np.interp(xq, x, y, **kw), rtol=1e-15)
        if len(kw) != 1:
            _close(got, np.asarray(JI.interp(
                jnp.asarray(xq), jnp.asarray(x), jnp.asarray(y), **kw)),
                rtol=1e-15)


@pytest.mark.parametrize("call", [
    lambda: TP.find_radius_mass(TP.snfw_mass_profile(1e15, 500.0), 500.0),
    lambda: TP.mass_within(TP.snfw_density_profile(1e15, 500.0), 1300.0),
    lambda: TP.rescale_profile_by_mass(
        TP.snfw_density_profile(1e15, 500.0), 9e13, 1300.0),
    lambda: TP.from_array_profile(R, R),
    lambda: TP.Profile.from_array(R, R),
    lambda: TP.snfw_density_profile(1e15, 500.0)(R),
    lambda: TP.cored_snfw_total_mass(1e15, 2000.0, 600.0, 80.0),
], ids=["find_radius_mass", "mass_within", "rescale_profile_by_mass",
        "from_array_profile", "Profile.from_array", "Profile.__call__",
        "cored_snfw_total_mass"])
def test_floats_and_arrays_go_to_the_card_unless_the_cpu_is_asked_for(
        call, monkeypatch):
    """Given no tensor to follow and no ``device="cpu"``, an entry point
    asks for the card and raises where there is none; it never falls back
    to the host silently."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


def test_solver_scalars_are_tensors_on_the_requested_device():
    Mt = TP.snfw_mass_profile(1e15, 500.0)
    r500, m500 = TP.find_radius_mass(Mt, 500.0, z=0.1, device="cpu")
    assert r500.shape == m500.shape == () and r500.device.type == "cpu"
    rj, mj = JP.find_radius_mass(JP.snfw_mass_profile(1e15, 500.0), 500.0,
                                 z=0.1)
    _close(float(r500), float(rj), rtol=1e-12)
    _close(float(m500), float(mj), rtol=1e-12)
    # a tensor parameter on another device than the radii is an error, a
    # 0-d one included: nothing is moved behind the caller's back
    prof = TP.from_array_profile(R, R, device="cpu")
    with pytest.raises((RuntimeError, NotImplementedError)):
        prof(_t(R).to("meta"))
    with pytest.raises(ValueError, match="lives on"):
        TP.from_array_profile(_t(R), _t(R).to("meta"))
