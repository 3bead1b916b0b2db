"""The class path and the staged merger path as captured programs
(``core/compiled.function``), on the CPU at a small size.

* Each captured function (the bisection of ``find_radius_mass``, the three
  builders, the DFs, the virial check, the speed table, the four merger
  stages) runs as a memoized program and equals the JAX package's jitted
  function on the same seeded numpy inputs, at the tolerances of
  tests/test_torch_model.py, test_torch_anisotropy.py, test_torch_gravity.py
  and test_torch_pipeline.py: float64 fields rtol 1e-9 (with the laws' floor
  of 1e-12 of the largest value), r_delta 1e-12, DFs 1e-6 (the extension
  below the grid and the reconstruction 1e-6), speed tables < 3e-4 with at
  most 1% of entries beyond 5e-6, draws as in test_torch_pipeline.py.  The
  JAX speed table runs its plain inversion (``use_pallas=False``), which
  the JAX tests hold against the interpreted Pallas kernel.
* The class path as a whole (profiles -> ``from_dens_and_tden`` ->
  ``VirialEquilibrium`` -> a DM draw with the JAX draw's uniforms, whose
  tables program builds the speed table) against the JAX package's.
* The memo: a new ``M200``, rescale factor or freshly composed profile of
  the same structure replays the program; a new structure, ``order``,
  ``gravity``, table knob or ``a0`` makes a new one; a class-path run
  leaves ``merger_ic_fused`` memoized; an input that requires grad runs the
  eager body and is counted.  On the CPU a decorated call runs its eager
  body and makes no program, so these tests read the memo keys of the
  calls (recorded by the ``_fresh_memo`` fixture): each distinct key is a
  program the card would capture.

Capture and replay need the card: ``chip_smoke.py`` phase 22 holds every
program against its eager body there.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cluster_generator_tpu as jcg
import cluster_generator_tpu.model.builders as JB
import cluster_generator_tpu.pipeline as JP
import cluster_generator_tpu.profiles as JPr
import cluster_generator_tpu.virial as JV
import cluster_generator_tpu_torch as tcg
import cluster_generator_tpu_torch.model.builders as TB
import cluster_generator_tpu_torch.pipeline as TP
import cluster_generator_tpu_torch.profiles as TPr
import cluster_generator_tpu_torch.virial as TV
from cluster_generator_tpu.core.config import cgparams as jcgparams
from cluster_generator_tpu.core.grid import numpy_log_radius_grid
from cluster_generator_tpu.parallel.ensemble import (
    build_one_cluster as j_build_one,
)
from cluster_generator_tpu_torch.core import compiled as C
from cluster_generator_tpu_torch.core.config import cgparams
from cluster_generator_tpu_torch.parallel.ensemble import build_one_cluster
from tests.test_torch_pipeline import _check_draws, _jax_uniforms

torch.set_num_threads(1)

CPU = {"device": "cpu"}
POINTS = 256
RR = numpy_log_radius_grid(0.1, 1e4, POINTS)
Z = 0.1
RNG = np.random.default_rng(20)
# seeded halo parameters: M200 in [5e14, 2e15], c in [3, 7]
M200S = 10.0 ** RNG.uniform(14.7, 15.3, 3)
CONCS = RNG.uniform(3.0, 7.0, 3)
NG, ND, NS = (300, 200), (240, 160), (60, 40)
CENTERS = [[-1500.0, 0.0, 0.0], [1500.0, 0.0, 0.0]]
VELS = [[0.3, 0.0, 0.0], [-0.45, 0.0, 0.0]]
A0 = 1.2e-10


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _close(got, want, rtol=1e-9, floor=0.0, msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=floor * np.abs(want).max(), err_msg=msg)


def _fields(got, want, floor=1e-12):
    assert set(got) == set(want)
    for k, w in want.items():
        _close(got[k].numpy(), w, floor=floor, msg=k)


# (memo key, key, inputs) of each decorated call that would run as a
# program on the card (see ``_fresh_memo``)
CALLS = []


def _n_programs(name):
    """The programs of ``name`` the recorded calls would make."""
    return len({memo for memo, _, _ in CALLS if memo[0][0] == name})


def _profiles(pk, m200, conc, **dev):
    """The canonical cluster's profiles through package ``pk``'s calls,
    with Python floats where a user passes them."""
    r200 = float(pk.find_overdensity_radius(m200, 200.0, z=Z))
    a = r200 / conc
    M = float(pk.snfw_total_mass(m200, r200, a))
    rhot, Mt = pk.snfw_density_profile(M, a), pk.snfw_mass_profile(M, a)
    r500, M500 = pk.find_radius_mass(Mt, z=Z, delta=500.0, **dev)
    rhog = pk.rescale_profile_by_mass(
        pk.vikhlinin_density_profile(1.0, 100.0, r200, 1.0, 0.67, 3),
        float(pk.f_gas(float(M500))) * float(M500), float(r500), **dev)
    return rhog, rhot


def _model(pk, m200=M200S[0], conc=CONCS[0], **kw):
    rhog, rhot = _profiles(pk, m200, conc,
                           **{k: v for k, v in kw.items() if k == "device"})
    return pk.ClusterModel.from_dens_and_tden(
        0.1, 1e4, rhog, rhot, stellar_density=0.02 * rhot,
        num_points=POINTS, **kw)


@contextlib.contextmanager
def _recording():
    """Every decorated call that would run as a program on the card (not
    one that requires grad, not one under ``compiled.eager()``) recorded
    in ``CALLS``, which starts empty."""
    real = C._Function._call

    def recorded(self, args, kwargs):
        key, inputs, body, draw = real(self, args, kwargs)
        if not (C._EAGER or (torch.is_grad_enabled()
                             and any(t.requires_grad for t in inputs))):
            CALLS.append((C._memo_key(key, inputs), key, inputs))
        return key, inputs, body, draw

    CALLS.clear()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(C._Function, "_call", recorded)
        yield
    CALLS.clear()


@pytest.fixture(autouse=True)
def _fresh_memo():
    """An empty memo, and the calls recorded (:func:`_recording`)."""
    C.clear()
    with _recording():
        yield
    C.clear()


@pytest.fixture
def a0():
    """Set the MOND a0 in both packages; restored after."""
    old = cgparams["gravity"]["mond"]["a0_m_s2"]
    jold = jcgparams["gravity"]["mond"]["a0_m_s2"]

    def set_(value):
        cgparams["gravity"]["mond"]["a0_m_s2"] = value
        jcgparams["gravity"]["mond"]["a0_m_s2"] = value

    yield set_
    cgparams["gravity"]["mond"]["a0_m_s2"] = old
    jcgparams["gravity"]["mond"]["a0_m_s2"] = jold
    jax.clear_caches()


@pytest.fixture(scope="module")
def grids():
    """Potential grids and densities of the three seeded halos (the JAX
    package's builds, so both packages invert the same numbers)."""
    out = {"ee": [], "dm": [], "star": []}
    for m, c in zip(M200S, CONCS):
        f = {k: np.asarray(v) for k, v in j_build_one(
            m, c, num_points=POINTS, with_df=False).items()}
        out["ee"].append(-f["gravitational_potential"][::-1])
        out["dm"].append(f["dark_matter_density"][::-1])
        out["star"].append(f["stellar_density"][::-1])
    return {k: np.stack(v) for k, v in out.items()}


# ------------------------------------------------------ each program vs JAX
def test_bisection_is_one_program_and_matches_jax():
    """r500 of each seeded halo: one program for all three (their
    parameters are inputs), rtol 1e-12 against the JAX package's."""
    for m, c in zip(M200S, CONCS):
        r200 = float(TPr.find_overdensity_radius(m, 200.0, z=Z))
        M = float(TPr.snfw_total_mass(m, r200, r200 / c))
        r_t, m_t = TPr.find_radius_mass(TPr.snfw_mass_profile(M, r200 / c),
                                        500.0, z=Z, **CPU)
        r_j, m_j = JPr.find_radius_mass(JPr.snfw_mass_profile(M, r200 / c),
                                        500.0, z=Z)
        _close(float(r_t), float(r_j), rtol=1e-12)
        _close(float(m_t), float(m_j), rtol=1e-12)
    assert _n_programs("_bisect") == 1


@pytest.mark.parametrize("builder", ["tden", "temp", "no_gas"])
@pytest.mark.parametrize("law", ["newtonian", "qumond", "emond"])
def test_builders_match_jax(builder, law):
    """The three builders of the seeded halos, each law: one program per
    builder and law, fields rtol 1e-9 (floor 1e-12 of the largest)."""
    temp_args = (6.0, 0.1, 2.0, 1.2, 900.0, 0.4, 60.0, 1.9)
    for m, c in zip(M200S, CONCS):
        per = {}
        for pk in (jcg, tcg):
            rhog, rhot = _profiles(pk, m, c,
                                   **({"device": "cpu"} if pk is tcg else {}))
            per[pk] = (rhog, rhot, pk.vikhlinin_temperature_profile(
                *temp_args), 0.02 * rhot)
        args = {"tden": lambda p: (p[0], p[1], p[3]),
                "temp": lambda p: (p[0], p[2], p[3]),
                "no_gas": lambda p: (p[1], p[3])}[builder]
        name = {"tden": "build_from_dens_and_tden",
                "temp": "build_from_dens_and_temp",
                "no_gas": "build_no_gas"}[builder]
        want = getattr(JB, name)(jnp.asarray(RR), *args(per[jcg]),
                                 gravity=law)
        got = getattr(TB, name)(_t(RR), *args(per[tcg]), gravity=law)
        _fields(got, {k: np.asarray(v) for k, v in want.items()})
    assert _n_programs(name) == 1


def test_dfs_and_virial_check_match_jax(grids):
    """``compute_df``, ``om_extended_df`` (``factor`` lifted),
    ``compute_df_truncated`` and ``check_virial_density`` of the batch of
    three halos, each one program, against the JAX functions halo by
    halo."""
    ee, pden = torch.from_numpy(grids["ee"]), torch.from_numpy(grids["dm"])
    f = TV.compute_df(ee, pden)
    ee_ext, f_ext = TV.om_extended_df(ee, pden, n_ext=64, factor=128.0)
    f_tr = TV.compute_df_truncated(ee, pden)
    rho = TV.check_virial_density(ee_ext, f_ext)
    for i in range(3):
        e_j, p_j = jnp.asarray(grids["ee"][i]), jnp.asarray(grids["dm"][i])
        _close(f[i].numpy(), JV.compute_df(e_j, p_j), rtol=1e-6)
        je, jf = JV.om_extended_df(e_j, p_j, n_ext=64, factor=128.0)
        _close(ee_ext[i].numpy(), je, rtol=1e-13)
        _close(f_ext[i].numpy(), jf, rtol=1e-6)
        _close(f_tr[i].numpy(), JV.compute_df_truncated(e_j, p_j), rtol=1e-8)
        _close(rho[i].numpy(), JV.check_virial_density(
            jnp.asarray(ee_ext[i].numpy()), jnp.asarray(f_ext[i].numpy())),
            rtol=1e-6)
    for name in ("compute_df", "om_extended_df", "compute_df_truncated",
                 "check_virial_density"):
        assert _n_programs(name) == 1, name


@pytest.mark.parametrize("table_dtype", [torch.float32, None])
def test_speed_table_matches_jax(grids, table_dtype):
    """The float32 inverse speed-CDF table (K1's plain version here) with
    its knobs static, the row energies the caller's input: within 3e-4 of
    the JAX package's, at most 1% of entries beyond 5e-6
    (tests/test_torch_model.py::test_speed_table_canonical_model); with
    the float64 CDF option, the bounds of
    tests/test_torch_class_api.py::test_float64_cdf_option_still_gives_a_float32_table
    (median under 5e-6, under 2% of entries above 5e-5: the ramps
    differ)."""
    ee, pden = grids["ee"][0], grids["dm"][0]
    f = np.asarray(JV.compute_df(jnp.asarray(ee), jnp.asarray(pden)))
    row_ee = ee[::4].copy()
    kw = dict(n_s=256, n_q=128, nf1=512, nf2=512)
    want = np.asarray(JV.speed_inverse_cdf_table(
        jnp.asarray(ee), jnp.asarray(f), row_ee=jnp.asarray(row_ee),
        table_dtype=None if table_dtype is None else jnp.float32, **kw))
    got = TV.speed_inverse_cdf_table(_t(ee), _t(f), row_ee=_t(row_ee),
                                     table_dtype=table_dtype, **kw)
    assert got.dtype == torch.float32 and got.shape == want.shape
    diff = np.abs(got.numpy() - want)
    assert diff.max() < 3e-4
    if table_dtype is None:
        assert np.median(diff) < 5e-6 and (diff > 5e-5).mean() < 0.02
    else:
        assert (diff > 5e-6).mean() < 0.01
    assert _n_programs("speed_inverse_cdf_table") == 1


@pytest.fixture(scope="module")
def staged():
    """The four merger stages of both packages at 128 points, the port's
    draws given the JAX draws' uniforms."""
    key = jax.random.key(3)
    M, c, r_max = M200S[:2], CONCS[:2], [5000.0, 4500.0]
    j_fields = JP.build_merger_models(jnp.asarray(M), jnp.asarray(c), z=Z,
                                      num_points=128)
    j_tables = JP.build_speed_tables(j_fields)
    j_tables["radius"] = JP.build_radius_tables(j_fields, jnp.asarray(r_max))
    j_parts = JP.sample_merger_ic(j_fields, j_tables, jnp.asarray(CENTERS),
                                  jnp.asarray(VELS), jnp.asarray(r_max), key,
                                  NG, ND, NS)
    with _recording():
        t_fields = TP.build_merger_models(M, c, z=Z, num_points=128, **CPU)
        t_tables = TP.build_speed_tables(t_fields)
        t_tables["radius"] = TP.build_radius_tables(t_fields, r_max)
        t_parts = TP.sample_merger_ic(t_fields, t_tables, CENTERS, VELS,
                                      r_max, NG, ND, NS,
                                      uniforms=_jax_uniforms(key, NG, ND, NS))
        names = {memo[0][0] for memo, _, _ in CALLS}
    tree = jax.tree_util.tree_map
    return {"j": tree(np.asarray, (j_fields, j_tables, j_parts)),
            "t": (t_fields, t_tables, t_parts), "names": names}


def test_merger_stages_are_programs(staged):
    """Each stage called on its own is one program; what a stage calls
    (the bisection, the builder, the DFs) runs inside it."""
    assert staged["names"] == {"build_merger_models", "build_speed_tables",
                               "build_radius_tables", "sample_merger_ic"}


def test_merger_models_match_jax(staged):
    (j_fields, _, _), (t_fields, _, _) = staged["j"], staged["t"]
    assert set(t_fields) == set(j_fields)
    for k, w in j_fields.items():
        _close(t_fields[k].numpy(), w, rtol=1e-6 if k.endswith("_df")
               else 1e-9, msg=k)


def test_merger_tables_match_jax(staged):
    (_, j_tab, _), (_, t_tab, _) = staged["j"], staged["t"]
    for k in ("gas", "dm", "star"):
        _close(t_tab["radius"][k].numpy(), j_tab["radius"][k], rtol=5e-6)
        _close(t_tab["radius"][k + "_mtot"].numpy(),
               j_tab["radius"][k + "_mtot"])
    for k in ("dm", "star"):
        diff = np.abs(t_tab[k].numpy() - j_tab[k])
        assert diff.max() < 3e-4 and (diff > 5e-6).mean() < 0.01, k


def test_merger_draws_match_jax(staged):
    _check_draws({k: v.numpy() for k, v in staged["t"][2].items()},
                 staged["j"][2], nd=ND, ns=NS)


def test_staged_draw_equals_the_fused_program():
    """``sample_merger_ic``'s program draws its uniforms before it runs,
    in the body's order: with one generator seed the staged stages equal
    ``merger_ic_fused`` bit for bit, and a partly given ``uniforms``
    takes the rest from the generator as the eager body does."""
    kw = dict(num_points=128, **CPU)
    parts, fields = TP.merger_ic_fused(
        list(M200S[:2]), list(CONCS[:2]), CENTERS, VELS, 5000.0, NG, ND, NS,
        generator=torch.Generator().manual_seed(4), **kw)
    f = TP.build_merger_models(list(M200S[:2]), list(CONCS[:2]), **kw)
    tables = TP.build_speed_tables(f)
    tables["radius"] = TP.build_radius_tables(f, 5000.0)
    staged = TP.sample_merger_ic(
        f, tables, CENTERS, VELS, 5000.0, NG, ND, NS,
        generator=torch.Generator().manual_seed(4))
    assert all(torch.equal(fields[k], f[k]) for k in f)
    assert all(torch.equal(parts[k], staged[k]) for k in parts)
    u = TP.merger_uniforms(torch.Generator().manual_seed(9), (), NG, ND, NS,
                           **CPU)
    part = {s: u[s] for s in list(u)[:3]}
    with C.inline():
        want = TP.sample_merger_ic(f, tables, CENTERS, VELS, 5000.0, NG, ND,
                                   NS, uniforms=part,
                                   generator=torch.Generator().manual_seed(2))
    got = TP.sample_merger_ic(f, tables, CENTERS, VELS, 5000.0, NG, ND, NS,
                              uniforms=part,
                              generator=torch.Generator().manual_seed(2))
    assert all(torch.equal(got[k], want[k]) for k in want)


# ----------------------------------------------------- the class path whole
def test_class_path_matches_jax():
    """Profiles -> ``from_dens_and_tden`` -> the DM ``VirialEquilibrium``
    -> a DM draw with the JAX draw's uniforms, both packages end to end:
    fields rtol 1e-9, the DF 1e-6, positions and masses rtol 1e-9; speeds
    through each package's own float32 table, within 3e-4 of the local
    escape speed (the tables' bound)."""
    from tests.test_torch_class_api import _collisionless_uniforms

    jm, tm = _model(jcg), _model(tcg, **CPU)
    _fields(tm.fields, {k: np.asarray(v) for k, v in jm.fields.items()})
    _close(tm.dm_virial.df.numpy(), jm.dm_virial.df, rtol=1e-6)
    n = 4000
    want = jm.dm_virial.generate_particles(n, r_max=4000.0, prng=21)
    got = tm.dm_virial.generate_particles(
        n, r_max=4000.0, uniforms=_collisionless_uniforms(21, n))
    pos_w = np.asarray(want["dm", "particle_position"])
    _close(got["dm", "particle_position"].numpy(), pos_w, floor=1e-12)
    _close(got["dm", "particle_mass"].numpy(),
           np.asarray(want["dm", "particle_mass"]))
    r = np.linalg.norm(pos_w, axis=1)
    phi = np.asarray(jm["gravitational_potential"])
    v_esc = np.sqrt(2.0 * np.interp(r, np.asarray(jm["radius"]), -phi))
    dv = np.abs(np.linalg.norm(got["dm", "particle_velocity"].numpy(), axis=1)
                - np.linalg.norm(np.asarray(want["dm", "particle_velocity"]),
                                 axis=1))
    assert (dv / v_esc).max() < 3e-4
    # the speed table (K1) runs inside the draw-table program
    for name in ("_bisect", "build_from_dens_and_tden", "compute_df",
                 "_collisionless_tables_program", "_draw_collisionless"):
        assert _n_programs(name) == 1, name
    assert _n_programs("speed_inverse_cdf_table") == 0


# --------------------------------------------------------------- the memo
def test_new_mass_rescale_and_composition_replay_one_program():
    """Three halos of other masses and concentrations (new r500, rescale
    factor and profile parameters) and a freshly composed stellar profile
    each time: one program per function."""
    for m, c in zip(M200S, CONCS):
        _model(tcg, m, c, **CPU).dm_virial._speed_table()
    for name in ("_bisect", "build_from_dens_and_tden", "compute_df",
                 "speed_inverse_cdf_table"):
        assert _n_programs(name) == 1, name
    a, b = 0.02 * TPr.snfw_density_profile(1.0, 2.0), 0.03 * \
        TPr.snfw_density_profile(3.0, 4.0)
    assert a.eval_fn is not b.eval_fn
    assert C.signature(a.eval_fn) == C.signature(b.eval_fn)
    assert C.signature((a + b).eval_fn) != C.signature((a * b).eval_fn)


@pytest.mark.parametrize("vary", ["structure", "order", "gravity", "knob",
                                  "a0"])
def test_statics_structure_and_config_make_new_programs(vary, a0):
    """A new profile structure, ``order``, ``gravity``, table knob or MOND
    ``a0`` is a new program; the ``a0`` case equals the JAX builder given
    that ``a0`` (``gravity_params``, which it traces)."""
    rhog, rhot = _profiles(tcg, M200S[0], CONCS[0], **CPU)
    rr = _t(RR)
    gravity = "qumond" if vary == "a0" else "newtonian"
    TB.build_from_dens_and_tden(rr, rhog, rhot, gravity=gravity)
    name = "build_from_dens_and_tden"
    if vary == "structure":
        TB.build_from_dens_and_tden(rr, rhog.cutoff(3000.0), rhot)
    elif vary == "order":
        TB.build_from_dens_and_tden(rr, rhog, rhot, order=24)
    elif vary == "gravity":
        TB.build_from_dens_and_tden(rr, rhog, rhot, gravity="aqual")
    elif vary == "knob":
        ee = torch.linspace(0.1, 2.0, 64, dtype=torch.float64)
        f = torch.exp(ee)
        TV.speed_inverse_cdf_table(ee, f, n_s=64, n_q=32)
        TV.speed_inverse_cdf_table(ee, f, n_s=128, n_q=32)
        name = "speed_inverse_cdf_table"
    else:
        a0(2.0 * A0)
        got = TB.build_from_dens_and_tden(rr, rhog, rhot, gravity="qumond")
        j_rhog, j_rhot = _profiles(jcg, M200S[0], CONCS[0])
        want = JB.build_from_dens_and_tden(
            jnp.asarray(RR), j_rhog, j_rhot, gravity="qumond",
            gravity_params={"a0_m_s2": 2.0 * A0})
        _fields(got, {k: np.asarray(v) for k, v in want.items()})
    assert _n_programs(name) == 2


def test_class_path_keeps_the_merger_program():
    """Each function has a memo of its own: the programs of a class-path
    run (as many as one memo holds), memoized under their keys, leave
    ``merger_ic_fused``'s program memoized."""
    TP.merger_ic_fused(list(M200S[:2]), list(CONCS[:2]), CENTERS, VELS,
                       5000.0, NG, ND, NS, num_points=128, **CPU)
    (merger,) = C.programs()
    for m, c in zip(M200S, CONCS):
        for law in ("newtonian", "aqual", "qumond"):
            mod = _model(tcg, m, c, gravity=law, **CPU)
            mod.check_dm_virial()
            TV.VirialEquilibrium(mod, r_a=1000.0 + m / 1e12)._speed_table()
    assert len({memo for memo, _, _ in CALLS}) >= C.MAX_PROGRAMS
    for _, key, inputs in CALLS:
        C.program(key, None, inputs)
    assert len(C.programs()) > C.MAX_PROGRAMS
    assert any(p is merger for p in C.programs())


def test_an_input_that_requires_grad_runs_eagerly():
    """A tensor that requires grad, with grad on, runs the eager body
    (counted, no program); without grad the same call is a program."""
    before = C.eager_calls
    m200 = torch.tensor([1.5e15], dtype=torch.float64, requires_grad=True)
    f = build_one_cluster(m200, _t([4.0]), num_points=64, with_df=True)
    f["pressure"][..., 0].sum().backward()
    assert bool(torch.isfinite(m200.grad).all())
    # the builder and the DF (the bisection runs in the root's forward,
    # where grad is off)
    assert C.eager_calls - before == 2
    assert _n_programs("build_from_dens_and_tden") == 0
    with torch.no_grad():
        build_one_cluster(m200, _t([4.0]), num_points=64, with_df=True)
    assert C.eager_calls - before == 2
    assert _n_programs("build_from_dens_and_tden") == 1


def test_z_sweep_replays_one_stage_program():
    for z in (0.0, 0.1, 0.3, 0.5):
        TP.build_merger_models(list(M200S[:2]), list(CONCS[:2]), z=z,
                               num_points=64, with_star_df=False, **CPU)
    assert _n_programs("build_merger_models") == 1


# -------------------------------------------------------------- mechanics
def test_decorator_lifts_floats_and_keys_the_rest():
    """Floats (an argument, a dict value, a profile parameter) arrive as
    0-d float64 tensors and replay the program; ints, strings and ``None``
    stay in the key as they are."""
    seen = []

    @C.function(static=("mode",))
    def probe(x, scale, params, prof, power, mode, extra=None):
        (k,) = params.values()
        seen.append((type(scale), type(k), type(prof.params[0]),
                     type(power), extra))
        return {"y": x * scale * k * prof(x) ** power}

    x = torch.ones(3, dtype=torch.float64)
    for s in (2.0, 3.0):
        out = probe(x, s, {"k": 0.5}, TPr.power_law_profile(s, 1.0, 2.0), 3,
                    "a")
    assert torch.equal(out["y"], x * 3.0 * 0.5 * 3.0 ** 3)
    assert seen[-1] == (torch.Tensor, torch.Tensor, torch.Tensor, int, None)
    assert _n_programs("probe") == 1
    probe(x, 2.0, {"k": 0.5}, TPr.power_law_profile(2.0, 1.0, 2.0), 2, "a")
    probe(x, 2.0, {"k": 0.5}, TPr.power_law_profile(2.0, 1.0, 2.0), 3, "b")
    probe(x, 2.0, {"j": 0.5}, TPr.power_law_profile(2.0, 1.0, 2.0), 3, "a")
    probe(x[:2], 2.0, {"k": 0.5}, TPr.power_law_profile(2.0, 1.0, 2.0), 3,
          "a")
    assert _n_programs("probe") == 5
    with C.inline():   # inside a program: the plain body, nothing lifted
        probe(x, 2.0, {"k": 0.5}, TPr.power_law_profile(2.0, 1.0, 2.0), 3,
              "a")
    assert seen[-1][:3] == (float, float, float)
    assert _n_programs("probe") == 5
    with pytest.raises(ValueError, match="no tensor and no device"):
        probe(2.0, 2.0, {}, None, 1, "a")
