"""The class path's particle draws and the IC scene's gas mixing as
captured programs (``core/compiled.function``), on the CPU at a small size.

* The draw tables (``sampling._gas_tables_program``,
  ``_collisionless_tables_program``, the speed table with K1's plain
  version inside the latter) and the draws (``_draw_gas``,
  ``_draw_tracers``, ``_draw_collisionless``) against the JAX package's
  jitted draw functions on a 4096-point canonical model, ~1e4 particles,
  the port's draws fed the JAX draws' uniforms (its key splits repeated as
  in tests/test_torch_class_api.py): float64 rtol 1e-9; speeds, through
  the float32 tables, 1e-4 with at most 1e-4 of the particles beyond.
* The gas mixing (``particles._mix_gas`` behind combine and resample,
  ``_resample_one``) against the JAX package's on the scene files of
  tests/test_torch_ics.py, and on halos of two grid sizes: rtol 1e-10.
* The memo, read from the keys of the calls as in
  tests/test_torch_class_programs.py: a model of another ``M200`` and
  ``c`` on a grid of the same size replays every program; a new ``r_max``
  index, ``num``, ``sub_sample``, ``compute_potential``, Osipkov-Merritt
  or not, halo count or scalar set makes a new one.
* What the host decides without reading the device: the ``r_max`` index
  and the IC counts come from the models' host copies, and no program
  body reads a tensor's value on the host (``aten._local_scalar_dense``,
  the op behind ``float``/``int``/``bool``/``item``, and ``nonzero``).
* The uniforms a program draws, in the eager body's order, and held gas
  tables that a ``compute_potential`` draw leaves as they were.

Capture and replay need the card: ``chip_smoke.py`` phase 23 holds every
program against its eager body there.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import cluster_generator_tpu as jcg
import cluster_generator_tpu.particles as JP
import cluster_generator_tpu.sampling as JSamp
import cluster_generator_tpu.virial as JV
import cluster_generator_tpu_torch as tcg
import cluster_generator_tpu_torch.ics as TI
import cluster_generator_tpu_torch.particles as TP
import cluster_generator_tpu_torch.sampling as TSamp
import cluster_generator_tpu_torch.virial as TV
from cluster_generator_tpu_torch.convert import cluster_model_from_numpy
from cluster_generator_tpu_torch.core import compiled as C
from tests.test_torch_class_api import (_canonical, _collisionless_uniforms,
                                        _compare_particles, _gas_uniforms)
from tests.test_torch_class_programs import _fresh_memo  # noqa: F401
from tests.test_torch_class_programs import CALLS
from tests.test_torch_ics import (CENTERS, R_MAX, VELOCITIES,
                                  _assert_particles_match, _pair, _scenes,
                                  scene_files)  # noqa: F401

torch.set_num_threads(2)

POINTS = 4096
RMAX = 5000.0
NUM = 10_000
RTOL = 1e-9


def _close(got, want, rtol=RTOL, atol=0.0, msg=""):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


@pytest.fixture(scope="module")
def jm():
    """The canonical cluster on a 4096-point grid, both DFs, built by the
    JAX package."""
    import tests.test_torch_class_api as api

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(api, "N_POINTS", POINTS)
        m = _canonical(jcg)
    m.dm_virial, m.star_virial  # noqa: B018
    return m


def _port(jm):
    """A fresh port model of the JAX model's fields and DFs (no tables)."""
    return cluster_model_from_numpy(jm.fields, dm_df=jm.dm_virial.df,
                                    star_df=jm.star_virial.df, device="cpu")


def _names():
    """The programs the recorded calls would make, by name."""
    return {memo[0][0] for memo, _, _ in CALLS}


# ------------------------------------------------------- tables vs the JAX
def test_gas_tables_program_matches_jax(jm):
    """The gas tables: the quantile nodes (rtol 1e-12, as
    test_torch_class_api.py's truncated-CDF test), the mass inside r_max
    (exact), the splines at the JAX draw's radii (rtol 1e-9); one
    program."""
    cm = _port(jm)
    tables = TSamp._gas_tables(cm, RMAX)
    P, rr, mtot = JSamp._truncated_cdf(jm["radius"], jm["gas_mass"],
                                       r_max=RMAX)
    pairs = np.asarray(JSamp._radius_quantile_pairs(P, rr))
    _close(tables["r_q"][:-1], pairs[:, 0], rtol=1e-12)
    _close(tables["r_q"][-1], pairs[-1, 1], rtol=1e-12)
    assert tables["mtot"].ndim == 0 and float(tables["mtot"]) == mtot
    assert tables["loguniform"] is True
    r = np.geomspace(0.2, 4000.0, 257)
    from cluster_generator_tpu.core.interp import (cubic_spline,
                                                   spline_eval_loguniform)
    for name, grid in (("energy", 1.5 * jm["pressure"] / jm["density"]),
                       ("density", jm["density"]),
                       ("potential", jm["gravitational_potential"])):
        want = spline_eval_loguniform(cubic_spline(
            jnp.asarray(jm["radius"]), jnp.asarray(grid)), jnp.asarray(r))
        got = TSamp._spline_at(tables[name], True, torch.from_numpy(r))
        _close(got, want, msg=name)
    assert _names() == {"_gas_tables_program"}


@pytest.mark.parametrize("speed", ["built", "held"])
def test_collisionless_tables_program_matches_jax(jm, speed):
    """The DM tables: nodes, mass and psi at the nodes as for the gas; the
    joint speed table from the JAX package's inverse speed-CDF table
    (``held``: given to the virial object; rtol 1e-6 in float32), or from
    the table the program builds with K1's plain version (``built``:
    within 3e-4 of the JAX speed table's, at most 1% of entries beyond
    5e-6, tests/test_torch_model.py's bounds), then held by the virial
    object."""
    cm = _port(jm)
    v, jv = cm.dm_virial, jm.dm_virial
    row_ee, s_inv = (np.asarray(a) for a in jv._speed_table())
    if speed == "held":
        v._s_inv[256] = (torch.tensor(row_ee), torch.tensor(s_inv))
    tables = TSamp._collisionless_tables(v, RMAX)
    P, rr, mtot = JSamp._truncated_cdf(jm["radius"], jm["dark_matter_mass"],
                                       dens=jm["dark_matter_density"],
                                       r_max=RMAX)
    pairs = np.asarray(JSamp._radius_quantile_pairs(P, rr))
    r_nodes = np.concatenate([pairs[:, 0], pairs[-1:, 1]])
    _close(tables["r_q"], r_nodes, rtol=1e-12)
    assert float(tables["mtot"]) == mtot
    from cluster_generator_tpu.core.interp import cubic_spline, spline_eval
    psi_grid = jnp.asarray(jv.ee)[::-1]
    psi_q = spline_eval(cubic_spline(jnp.asarray(jm["radius"]), psi_grid),
                        jnp.asarray(r_nodes))
    _close(tables["psi_q"], psi_q)
    got_row, got_s = v._speed_table()
    _close(got_row, row_ee, rtol=0)
    diff = np.abs(got_s.numpy() - s_inv)
    if speed == "held":
        assert diff.max() == 0.0
    else:
        assert diff.max() < 3e-4 and (diff > 5e-6).mean() < 0.01
    joint = JV.build_joint_speed_pairs(
        jnp.asarray(jm["radius"]), psi_grid, jnp.asarray(row_ee),
        jnp.asarray(got_s.numpy()), jnp.asarray(r_nodes),
        dtype=jnp.float32, psi_q=psi_q)
    # the JAX package's row k (n_q - 1) + m is the pair ([k, m], [k, m + 1])
    n_q = s_inv.shape[1]
    want = np.asarray(joint).reshape(-1, n_q - 1, 2)
    got = tables["joint"].numpy()
    _close(got[:, :-1], want[..., 0], rtol=1e-6, atol=1e-6 * got.max())
    _close(got[:, 1:], want[..., 1], rtol=1e-6, atol=1e-6 * got.max())
    # the speed table runs inside the tables' program
    assert _names() == {"_collisionless_tables_program"}


# -------------------------------------------------------- draws vs the JAX
@pytest.mark.parametrize("species", ["gas", "tracer", "dm", "star", "om"])
def test_draw_programs_match_jax(jm, species):
    """Each species through its entry point, the JAX draw's uniforms fed
    to the draw program: the particles of the JAX package's draw (float64
    rtol 1e-9, speeds 1e-4 with at most 1e-4 beyond); the tables and the
    draw one program each."""
    cm = _port(jm)
    kw = dict(r_max=RMAX, compute_potential=species in ("gas", "dm"))
    if species == "tracer":
        kw = dict(r_max=RMAX, sub_sample=3)
    num = NUM + (1 if species == "tracer" else 0)
    if species in ("gas", "tracer"):
        fn = {"gas": "generate_gas_particles",
              "tracer": "generate_tracer_particles"}[species]
        want = getattr(jm, fn)(num, prng=41, **kw)
        got = getattr(cm, fn)(num, uniforms=_gas_uniforms(
            41, num, kw.get("sub_sample", 1)), **kw)
        speed, names = (), {"_gas_tables_program",
                            "_draw_tracers" if species == "tracer"
                            else "_draw_gas"}
    else:
        if species == "om":
            jv = JV.VirialEquilibrium(jm, "dark_matter", r_a=1500.0)
            tv = TV.VirialEquilibrium(cm, "dark_matter", r_a=1500.0,
                                      df=np.asarray(jv.df))
        else:
            jv = jm.dm_virial if species == "dm" else jm.star_virial
            tv = cm.dm_virial if species == "dm" else cm.star_virial
        want = jv.generate_particles(num, prng=42, **kw)
        got = tv.generate_particles(
            num, uniforms=_collisionless_uniforms(42, num), **kw)
        short = "star" if species == "star" else "dm"
        speed = {(short, "particle_velocity")}
        names = {"_collisionless_tables_program", "_draw_collisionless"}
        if species == "om":
            names.add("om_extended_df")
    _compare_particles(got, want, num, speed_keys=speed)
    assert _names() == names


# ------------------------------------------------------ gas mixing vs JAX
@pytest.mark.parametrize("case", ["combine-2", "combine-3", "resample-1",
                                  "resample-2", "resample-3",
                                  "heterogeneous"])
def test_gas_mixing_programs_match_jax(scene_files, jm, case):
    """Combine and resample against the JAX package (rtol 1e-10): one
    program, its new columns written into the scene's own tensors."""
    if case == "heterogeneous":
        # a 4096-point and a 1000-point halo (the scene file's)
        small = tcg.ClusterModel.from_h5_file(scene_files[0], device="cpu")
        j_small = jcg.ClusterModel.from_h5_file(scene_files[0])
        big = _port(jm)
        jp1, tp1 = _pair(big.generate_gas_particles(3000, r_max=2500.0,
                                                    prng=31))
        jp2, tp2 = _pair(small.generate_gas_particles(3000, r_max=2500.0,
                                                      prng=32))
        CALLS.clear()
        args = (CENTERS[0], CENTERS[1], VELOCITIES[0], VELOCITIES[1])
        want = JP.combine_two_clusters(jp1, jp2, jm, j_small, *args)
        got = TP.combine_two_clusters(tp1, tp2, big, small, *args)
        _assert_particles_match(got, want)
        assert _names() == {"sample_clusters"}
        return
    kind, n = case.split("-")
    n = int(n)
    J, T = _scenes(n, scene_files)
    if kind == "combine":
        want, got = J.setup_particle_ics(), T.setup_particle_ics()
        _assert_particles_match(got, want)
        assert _names() == ({"sample_clusters"} if n > 1 else set())
        return
    out, held = [], None
    for ics in (J, T):
        parts = ics.setup_particle_ics()
        for i in range(n):
            m = ics.load_model(i)
            m.set_field("metallicity", np.linspace(1.0, 0.1, m.num_elements))
        parts.set_field("gas", "metallicity",
                        np.zeros(parts.num_particles["gas"]),
                        passive_scalar=True)
        parts["gas", "particle_position"] = (
            parts["gas", "particle_position"] * 1.01)
        if ics is T:
            held = {k: parts[k] for k in parts.fields if k[0] == "gas"}
            CALLS.clear()
        out.append(ics.resample_particle_ics(
            parts, passive_scalars=["metallicity"]))
    _assert_particles_match(out[1], out[0])
    if n == 1:
        assert _names() == {"resample_one_cluster"}
    else:
        assert _names() == {"sample_clusters"}
        # written in place, into the tensors the scene held
        assert all(out[1][k] is t for k, t in held.items())


# --------------------------------------------------------------- the memo
def _small_model(m200=1.5e15, conc=4.0, points=256):
    """A port model of its own parameters on a ``points`` grid."""
    r200 = tcg.find_overdensity_radius(m200, 200.0, z=0.1)
    a = r200 / conc
    M = tcg.snfw_total_mass(m200, r200, a)
    rhot, Mt = tcg.snfw_density_profile(M, a), tcg.snfw_mass_profile(M, a)
    r500, M500 = tcg.find_radius_mass(Mt, z=0.1, delta=500.0, device="cpu")
    rhog = tcg.rescale_profile_by_mass(
        tcg.vikhlinin_density_profile(1.0, 100.0, r200, 1.0, 0.67, 3),
        tcg.f_gas(M500) * M500, r500)
    m = tcg.ClusterModel.from_dens_and_tden(
        0.1, 1e4, rhog, rhot, stellar_density=0.02 * rhot, num_points=points,
        device="cpu")
    m.set_field("metallicity", torch.linspace(1.0, 0.1, points,
                                              dtype=torch.float64))
    return m


def _draw_all(m, r_max=3000.0, num=500, sub_sample=1,
              compute_potential=False, om=False):
    """Gas, tracers and DM (or OM DM) of ``m`` at these settings."""
    kw = dict(r_max=r_max, sub_sample=sub_sample, prng=3)
    m.generate_gas_particles(num, compute_potential=compute_potential, **kw)
    m.generate_tracer_particles(num, **kw)
    v = TV.VirialEquilibrium(m, r_a=1500.0) if om else m.dm_virial
    v.generate_particles(num, compute_potential=compute_potential, **kw)


def _n_keys(name):
    return len({memo for memo, _, _ in CALLS if memo[0][0] == name})


def _mix(models, resample=False, scalars=None, n=400):
    """Each model's gas about its center, combined; with ``resample`` the
    scene resampled within R_MAX (``scalars`` mixed too)."""
    parts = [m.generate_gas_particles(n, r_max=2000.0, prng=5 + i)
             for i, m in enumerate(models)]
    h = len(models)
    scene = (TP.combine_two_clusters if h == 2 else TP.combine_three_clusters)(
        *parts, *models, *CENTERS[:h], *VELOCITIES[:h])
    if resample:
        for name in scalars or ():
            scene.set_field("gas", name, torch.zeros(n * h),
                            passive_scalar=True)
        (TP.resample_two_clusters if h == 2 else TP.resample_three_clusters)(
            scene, *models, *CENTERS[:h], *VELOCITIES[:h], R_MAX[:h],
            passive_scalars=scalars)
    return scene


@pytest.fixture(scope="module")
def small_models():
    return [_small_model(m, c) for m, c in ((1.5e15, 4.0), (8e14, 5.5),
                                           (2.2e15, 3.2))]


DRAW_PROGRAMS = ("_gas_tables_program", "_draw_gas", "_draw_tracers",
                 "_collisionless_tables_program", "_draw_collisionless")


def test_new_mass_and_concentration_replay_every_program(small_models):
    """Models of other masses and concentrations on grids of one size:
    their tables and draws (stars beside DM: the stars' tables are the DM
    tables' program), combine, resample and the one-halo resample are one
    program per function and setting."""
    for m in small_models:
        m._draw_tables = m.dm_virial._draw_tables = None
        m.star_virial._draw_tables = None
    CALLS.clear()
    for m in small_models:
        _draw_all(m)
        m.generate_star_particles(500, r_max=3000.0, prng=4)
    for name in DRAW_PROGRAMS:
        # the DM and star draws differ by their species, a static
        assert _n_keys(name) == (2 if name == "_draw_collisionless" else 1), \
            name
    for pair in (small_models[:2], small_models[1:]):
        _mix(pair, resample=True)
        p = pair[0].generate_gas_particles(400, r_max=2000.0, prng=9)
        TP.resample_one_cluster(p, pair[1], CENTERS[0], VELOCITIES[0])
    assert _n_keys("sample_clusters") == 2   # combine, resample
    assert _n_keys("resample_one_cluster") == 1


@pytest.mark.parametrize("vary", ["r_max_index", "num", "sub_sample",
                                  "compute_potential", "om", "halo_count",
                                  "scalars"])
def test_statics_make_new_programs(small_models, vary):
    """Each static of the draws and of the mixing makes a program of its
    own; an ``r_max`` in the same grid interval does not."""
    m = small_models[0]
    m._draw_tables = m.dm_virial._draw_tables = None
    if vary in ("halo_count", "scalars"):
        _mix(small_models[:2], resample=vary == "scalars")
        if vary == "halo_count":
            _mix(small_models)
            assert _n_keys("sample_clusters") == 2
        else:
            # combine, resample, resample with the scalar
            _mix(small_models[:2], resample=True, scalars=["metallicity"])
            assert _n_keys("sample_clusters") == 3
        return
    _draw_all(m)
    if vary == "r_max_index":
        rr = m._host_field("radius")
        same = 3000.0 * (1.0 + 1e-9)
        assert np.searchsorted(rr, same) == np.searchsorted(rr, 3000.0)
        _draw_all(m, r_max=same)
        assert _n_keys("_gas_tables_program") == 1
        _draw_all(m, r_max=1500.0)
        names = ("_gas_tables_program", "_collisionless_tables_program")
    elif vary == "num":
        _draw_all(m, num=600)
        names = ("_draw_gas", "_draw_tracers", "_draw_collisionless")
    elif vary == "sub_sample":
        _draw_all(m, sub_sample=2)
        names = ("_draw_gas", "_draw_tracers", "_draw_collisionless")
    elif vary == "compute_potential":
        _draw_all(m, compute_potential=True)
        names = ("_draw_gas", "_draw_collisionless")
        assert _n_keys("_gas_tables_program") == 1
    else:
        # OM: an input grid of its own (the extended f(E) grid) and r_a
        _draw_all(m, om=True)
        names = ("_collisionless_tables_program", "_draw_collisionless")
    for name in names:
        assert _n_keys(name) == 2, name
    # r_a is an input: another radius replays the OM draw
    if vary == "om":
        TV.VirialEquilibrium(m, r_a=900.0).generate_particles(
            500, r_max=3000.0, prng=3)
        assert _n_keys("_draw_collisionless") == 2


# ------------------------------------------ what the host does not read
_READS = (torch.ops.aten._local_scalar_dense.default,
          torch.ops.aten.is_nonzero.default, torch.ops.aten.nonzero.default)


class _NoHostReads(TorchDispatchMode):
    """Raises on an op that brings a tensor's value to the host: on a card
    a sync, which a capture refuses."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in _READS:
            raise AssertionError(f"a program body read a value: {func}")
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def _guarded_bodies():
    """Every decorated call's body runs under :class:`_NoHostReads` (the
    uniforms are drawn outside it, as before a replay); yields the names
    called."""
    real = C._Function._call
    called = []

    def call(self, args, kwargs):
        key, inputs, body, draw = real(self, args, kwargs)
        called.append(self.name)

        def guarded(*a):
            with _NoHostReads():
                return body(*a)
        return key, inputs, guarded, draw

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(C._Function, "_call", call)
        yield called


def test_no_program_body_reads_a_value_on_the_host():
    """The tables, the draws of every species (OM too), combine, resample
    with a scalar and the one-halo resample, each body under a guard that
    fails on a read of a tensor's value; the counts of the IC scene too."""
    models = [_small_model(1.2e15, 4.5), _small_model(9e14, 5.0)]
    with _guarded_bodies() as called:
        _draw_all(models[0], compute_potential=True)
        _draw_all(models[0], sub_sample=2, om=True)
        models[0].generate_star_particles(300, r_max=3000.0, prng=2)
        _mix(models, resample=True, scalars=["metallicity"])
        p = models[1].generate_gas_particles(300, r_max=2000.0, prng=9)
        TP.resample_one_cluster(p, models[1], CENTERS[0], VELOCITIES[0])
    assert set(DRAW_PROGRAMS) | {"sample_clusters",
                                 "resample_one_cluster"} <= set(called)


def test_index_and_counts_come_from_the_host_copies(scene_files):
    """The ``r_max`` index of a draw and the IC scene's counts are read
    from the models' host copies: a model read from a file starts with the
    arrays it read (no copy from its device), a built model copies each
    field once; a host grid that says otherwise moves the index, host
    masses that say otherwise move the counts."""
    m, other = (tcg.ClusterModel.from_h5_file(scene_files[0], device="cpu")
                for _ in range(2))
    held = dict(m._host_fields)
    assert set(held) == set(m.fields)
    assert all(held[k][0] is m[k] for k in m.fields)
    rr = m._host_field("radius")
    assert rr is held["radius"][2]
    np.testing.assert_array_equal(rr, m["radius"].numpy())

    def ridx():
        m._draw_tables = None
        CALLS.clear()
        m.generate_gas_particles(100, r_max=3000.0, prng=1)
        (key,) = [k for k, _, _ in CALLS if k[0][0] == "_gas_tables_program"]
        return dict(key[0][1])["ridx"]

    assert ridx() == int(np.searchsorted(rr, 3000.0))
    # a host grid of half the radii puts r_max further out
    m._host_fields["radius"] = (m["radius"], m["radius"]._version, rr / 2)
    assert ridx() == int(np.searchsorted(rr / 2, 3000.0)) > int(
        np.searchsorted(rr, 3000.0))
    m._host_fields["radius"] = held["radius"]
    # host masses three times the device's give this halo more particles
    r_max, want = [3000.0, 3000.0], {"dm": 1000, "gas": 800}
    counts = TI.halo_particle_counts([m, other], r_max, want)
    assert counts["dm"] == [500, 500] and counts["gas"] == [400, 400]
    t = m["dark_matter_mass"]
    m._host_fields["dark_matter_mass"] = (t, t._version,
                                          held["dark_matter_mass"][2] * 3)
    moved = TI.halo_particle_counts([m, other], r_max, want)
    assert moved["dm"] == [750, 250] and moved["gas"] == counts["gas"]
    # a field written in place is copied again
    m["radius"].mul_(1.0)
    assert m._host_field("radius") is not rr


# ------------------------------------------------- uniforms, held tables
def test_programs_draw_their_uniforms_in_the_eager_order(small_models):
    """A draw from a generator equals the draw given the uniforms that the
    generator yields in the documented order (radius, directions, speeds
    in the table's dtype, velocity directions), bit for bit."""
    m = small_models[1]
    n, sub = 700, 2

    def seq(seed, *sites):
        g = torch.Generator().manual_seed(seed)
        out = []
        for size, dtype, lo in sites:
            u = torch.rand(size, generator=g, dtype=dtype)
            out.append(u * 2.0 - 1.0 if lo else u)
        return out

    f64, f32 = torch.float64, torch.float32
    u = seq(7, (n // sub, f64, 0), (n, f64, 1), (n, f64, 0))
    for fn in (m.generate_gas_particles, m.generate_tracer_particles):
        a = fn(n, r_max=3000.0, sub_sample=sub, prng=7)
        b = fn(n, r_max=3000.0, sub_sample=sub, uniforms=(u[0], tuple(u[1:])))
        assert all(torch.equal(a[k], b[k]) for k in a.keys())
    u = seq(8, (n // sub, f64, 0), (n, f64, 1), (n, f64, 0),
            (n // sub, f32, 0), (n // sub, f32, 0), (n, f64, 1), (n, f64, 0))
    a = m.generate_dm_particles(n, r_max=3000.0, sub_sample=sub, prng=8)
    b = m.generate_dm_particles(n, r_max=3000.0, sub_sample=sub, uniforms=(
        u[0], (u[1], u[2]), (u[3], u[4]), (u[5], u[6])))
    assert all(torch.equal(a[k], b[k]) for k in a.keys())


def test_a_potential_draw_leaves_the_held_gas_tables_as_they_were():
    """The gas tables hold the potential's spline from the start: a draw
    with ``compute_potential`` after one without adds nothing to the held
    tables (a program's outputs are never changed after it ran)."""
    m = _small_model(1.1e15, 4.2)
    m.generate_gas_particles(300, r_max=3000.0, prng=1)
    held = m._draw_tables[3]
    objs = dict(held)

    def tensors(v):
        return list(v) if isinstance(v, tuple) else [v]

    snap = {k: [t.clone() for t in tensors(v)] for k, v in held.items()
            if k != "loguniform"}
    p = m.generate_gas_particles(300, r_max=3000.0, compute_potential=True,
                                 prng=1)
    assert m._draw_tables[3] is held and held == objs
    for k, copies in snap.items():
        assert all(torch.equal(a, b) for a, b in zip(tensors(held[k]),
                                                      copies)), k
    assert "potential" in held
    assert bool(torch.isfinite(p["gas", "particle_potential"]).all())
