"""The port's single-cluster class API (``ClusterModel`` ->
``VirialEquilibrium`` -> the particle generators, ``ClusterParticles``)
against the JAX package's, on the CPU at a small size.

The canonical cluster is built by both packages from the same parameters
(fields rtol 1e-9, DFs 1e-6).  For the draws the JAX model's numpy fields
and DFs are carried into the port (``cluster_model_from_numpy``), and the
port's generators are fed the uniforms that ``jax.random`` returns at each
random site of the JAX generator (its key splits repeated here), so that
particles are compared one by one: float64 outputs rtol 1e-9; speeds, which
pass through the float32 tables, 1e-4 with at most 1e-4 of the particles
beyond.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cluster_generator_tpu as jcg
import cluster_generator_tpu.sampling as JSamp
import cluster_generator_tpu.virial as JV
import cluster_generator_tpu_torch as tcg
import cluster_generator_tpu_torch.sampling as TSamp
import cluster_generator_tpu_torch.virial as TV
from cluster_generator_tpu_torch.convert import cluster_model_from_numpy
from cluster_generator_tpu_torch.core.constants import G

torch.set_num_threads(2)

N_POINTS = 200
R_MAX = 5000.0
RTOL = 1e-9
DF_RTOL = 1e-6
f64 = jnp.float64


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _close(got, want, rtol=RTOL, atol=0.0, msg=""):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


def _canonical(cg, **kw):
    """The canonical cluster through the public calls of package ``cg``."""
    z, M200, conc = 0.1, 1.5e15, 4.0
    r200 = float(cg.find_overdensity_radius(M200, 200.0, z=z))
    a = r200 / conc
    M = float(cg.snfw_total_mass(M200, r200, a))
    rhot, Mt = cg.snfw_density_profile(M, a), cg.snfw_mass_profile(M, a)
    # the port's solvers take the device the model takes
    dev = {k: kw[k] for k in ("device",) if k in kw}
    r500, M500 = cg.find_radius_mass(Mt, z=z, delta=500.0, **dev)
    f_g = float(cg.f_gas(float(M500)))
    rhog = cg.rescale_profile_by_mass(
        cg.vikhlinin_density_profile(1.0, 100.0, r200, 1.0, 0.67, 3),
        f_g * float(M500), float(r500), **dev)
    return cg.ClusterModel.from_dens_and_tden(
        0.1, 1e4, rhog, rhot, stellar_density=0.02 * rhot,
        num_points=N_POINTS, **kw)


@pytest.fixture(scope="module")
def jm():
    m = _canonical(jcg)
    m.dm_virial, m.star_virial  # noqa: B018  (build both DFs once)
    return m


@pytest.fixture(scope="module")
def tm():
    return _canonical(tcg, device="cpu")


@pytest.fixture(scope="module")
def cm(jm):
    """The JAX model's state carried into the port."""
    return cluster_model_from_numpy(jm.fields, dm_df=jm.dm_virial.df,
                                    star_df=jm.star_virial.df, device="cpu")


# ------------------------------------------------------------------- model
def test_canonical_model_fields_match_jax(jm, tm):
    # (a jitted function returns its dict sorted by name; the port keeps
    # the order of construction)
    assert sorted(tm.keys()) == sorted(jm.keys())
    assert tm.num_elements == jm.num_elements and tm.gravity == "newtonian"
    for k in jm.keys():
        assert tm[k].dtype == torch.float64 and tm[k].device.type == "cpu"
        _close(tm[k], jm[k], atol=1e-12 * np.abs(jm[k]).max(), msg=k)
    assert "200 pts" in repr(tm) and "cpu" in repr(tm)


def test_checks_match_jax(jm, tm):
    _close(tm.check_hse(), jm.check_hse(), rtol=1e-6, atol=1e-10)
    for ours, theirs in ((tm.check_dm_virial(), jm.check_dm_virial()),
                         (tm.check_star_virial(), jm.check_star_virial())):
        _close(ours[0], theirs[0], rtol=DF_RTOL)
        _close(ours[1], theirs[1], rtol=1e-5, atol=2 * DF_RTOL)
    # 200 points only: 1e-2 at the outermost point, 1e-4 inside
    assert float(tm.check_hse().abs().max()) < 2e-2
    assert float(tm.check_hse()[:-4].abs().max()) < 5e-4
    with pytest.raises(RuntimeError, match="no gas"):
        tcg.ClusterModel.no_gas(0.1, 1e4, tcg.snfw_density_profile(
            1e15, 500.0), num_points=64, device="cpu").check_hse()


@pytest.mark.parametrize("r_a", [None, 1500.0])
def test_velocity_dispersion_matches_jax(jm, tm, r_a):
    want = np.array(jm.compute_velocity_dispersion("dark_matter", r_a=r_a))
    got = tm.compute_velocity_dispersion("dark_matter", r_a=r_a)
    _close(got, want, rtol=1e-8)
    assert "velocity_dispersion" in tm
    with pytest.raises(ValueError, match="positive"):
        tm.compute_velocity_dispersion(r_a=0.0)


def test_magnetic_fields_match_jax(jm, tm):
    for gaussian in (True, False):
        jm.set_magnetic_field_from_beta(100.0, gaussian=gaussian)
        tm.set_magnetic_field_from_beta(100.0, gaussian=gaussian)
        _close(tm["magnetic_field_strength"], jm["magnetic_field_strength"])
        assert tm.magnetic_gaussian is gaussian
        jm.set_magnetic_field_from_density(5e-6, gaussian=gaussian)
        tm.set_magnetic_field_from_density(5e-6, gaussian=gaussian)
        _close(tm["magnetic_field_strength"], jm["magnetic_field_strength"])


def test_lookups_match_jax(jm, tm):
    for field in ("temperature", "total_mass"):
        _close(tm.find_field_at_radius(field, 431.0),
               jm.find_field_at_radius(field, 431.0))
    want = jm.mass_in_radius(1000.0)
    got = tm.mass_in_radius(1000.0)
    assert set(got) == set(want) == {"total", "gas", "dark_matter",
                                     "stellar"}
    for k in want:
        _close(got[k], want[k])
    assert all(float(v) == 0.0 for v in tm.mass_in_radius(0.01).values())
    _close(tm.find_radius_for_density(2e4), jm.find_radius_for_density(2e4))
    cut_t, cut_j = tm.set_rmax(2000.0), jm.set_rmax(2000.0)
    assert cut_t.num_elements == cut_j.num_elements
    assert float(cut_t["radius"][-1]) <= 2000.0
    bumpy = tcg.ClusterModel.from_arrays(
        {"radius": np.array([1.0, 2.0, 3.0]),
         "density": np.array([3.0, 1.0, 2.0])}, device="cpu")
    with pytest.raises(ValueError, match="monotonically"):
        bumpy.find_radius_for_density(1.5)


@pytest.mark.parametrize("ctor", ["temp", "entr", "no_gas"])
@pytest.mark.parametrize("law", ["newtonian", "qumond"])
def test_other_constructors_match_jax(ctor, law):
    def build(cg, **kw):
        rhog = cg.vikhlinin_density_profile(2.2e5, 100.0, 2000.0, 1.0, 0.67,
                                            3.0)
        star = cg.hernquist_density_profile(2e12, 30.0)
        common = dict(stellar_density=star, num_points=128, gravity=law, **kw)
        if ctor == "temp":
            temp = cg.vikhlinin_temperature_profile(6.0, 0.1, 2.0, 1.2, 900.0,
                                                    0.4, 60.0, 1.9)
            return cg.ClusterModel.from_dens_and_temp(0.5, 8e3, rhog, temp,
                                                      **common)
        if ctor == "entr":
            entr = cg.baseline_entropy_profile(10.0, 1500.0, 2000.0, 1.1)
            return cg.ClusterModel.from_dens_and_entr(0.5, 8e3, rhog, entr,
                                                      **common)
        return cg.ClusterModel.no_gas(0.5, 8e3, cg.snfw_density_profile(
            1.9e15, 520.0), **common)

    want, got = build(jcg), build(tcg, device="cpu")
    assert got.gravity == law and sorted(got.keys()) == sorted(want.keys())
    for k in want.keys():
        _close(got[k], want[k], atol=1e-12 * np.abs(want[k]).max(), msg=k)


def test_public_names_of_the_slice_exist_with_the_same_signatures():
    """Every name the JAX package exports from the modules of this slice
    exists in the port; the class constructors and generators keep their
    parameters and add only ``device`` or ``uniforms``."""
    import inspect

    import cluster_generator_tpu.profiles as JP

    names = set(JP.__all__) | {
        "Cosmology", "G", "cgparams", "default_cosmology", "kboltz",
        "log_radius_grid", "mp", "mu", "mue", "mylog", "relations",
        "convert_ne_to_density", "f_gas", "m_bcg", "m_sat", "r_bcg",
        "ClusterModel", "HydrostaticEquilibrium", "VirialEquilibrium",
        "ClusterParticles"}
    assert names <= set(tcg.__all__)
    assert all(hasattr(tcg, n) and hasattr(jcg, n) for n in names)
    assert issubclass(tcg.HydrostaticEquilibrium, tcg.ClusterModel)
    for cls in ("ClusterModel", "VirialEquilibrium", "ClusterParticles"):
        for name, member in inspect.getmembers(getattr(jcg, cls),
                                               callable):
            if name.startswith("_") or not hasattr(getattr(tcg, cls), name):
                continue
            want = list(inspect.signature(member).parameters)
            got = list(inspect.signature(getattr(getattr(tcg, cls),
                                                 name)).parameters)
            extra = [p for p in got if p not in want]
            assert [p for p in got if p in want] == want, (cls, name)
            assert set(extra) <= {"device", "uniforms"}, (cls, name, extra)
    # what the port has not got yet is what the roadmap lists
    missing = {n for n in dir(jcg.ClusterModel)
               if not n.startswith("_") and not hasattr(tcg.ClusterModel, n)}
    assert missing == set(), missing


def test_entry_points_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    rhot = tcg.snfw_density_profile(1e15, 500.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcg.ClusterModel.no_gas(0.1, 1e4, rhot, num_points=32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcg.ClusterModel.from_arrays({"radius": np.ones(3)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcg.ClusterParticles("dm", {("dm", "particle_mass"): np.ones(3)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cluster_model_from_numpy({"radius": np.ones(3)})


def test_plot_and_create_dataset_name_their_slice(tm, tmp_path):
    with pytest.raises(NotImplementedError, match="Slice E"):
        tm.plot("density")
    with pytest.raises(NotImplementedError, match="Slice E"):
        tm.create_dataset(str(tmp_path / "grid.h5"))


# ---------------------------------------------------------------- the probes
def test_set_field_probes(tm):
    m = tm.set_rmax(1e5)  # a copy
    n = m.num_elements
    with pytest.raises(ValueError, match=f"{n} elements"):
        m.set_field("metallicity", np.ones(n + 1))
    with pytest.raises(ValueError, match="temperature"):
        m.set_field("temperature", np.ones(n), unit="K")
    with pytest.raises(ValueError, match="density"):
        m.set_field("density", np.ones(n), unit="kpc")
    m.set_field("radius", np.linspace(1e-3, 1.0, n), unit="Mpc")
    _close(m["radius"], np.linspace(1.0, 1e3, n), rtol=1e-14)
    m.set_field("metallicity", torch.full((n,), 0.3))
    assert m["metallicity"].dtype == torch.float64


# ---------------------------------------------------------------- the DFs
@pytest.mark.parametrize("ptype", ["dark_matter", "stellar"])
@pytest.mark.parametrize("r_a", [None, 1500.0])
def test_virial_df_and_check_match_jax(jm, tm, ptype, r_a):
    want = JV.VirialEquilibrium(jm, ptype, r_a=r_a)
    got = TV.VirialEquilibrium(tm, ptype, r_a=r_a)
    assert got.df.dtype == torch.float64 and got.df.shape == (N_POINTS,)
    scale = np.abs(want.df).max()
    _close(got.df, want.df, rtol=DF_RTOL, atol=1e-12 * scale)
    _close(got.ee, want.ee)
    _close(got.ff, want.ff, rtol=DF_RTOL, atol=1e-12 * scale)
    rho_t, chk_t = got.check_virial()
    rho_j, chk_j = want.check_virial()
    _close(rho_t, rho_j, rtol=DF_RTOL)
    # the residual is a difference of densities that agree to DF_RTOL
    _close(chk_t, chk_j, rtol=1e-5, atol=2 * DF_RTOL)
    if r_a is not None:
        ee_t, f_t = got._df_grid
        ee_j, f_j = want._df_grid
        assert ee_t.shape == (192 + N_POINTS,)
        _close(ee_t, ee_j)
        _close(f_t, f_j, rtol=DF_RTOL, atol=1e-12 * scale)


def test_virial_rejects_non_positive_r_a_and_resumes_a_df(tm):
    with pytest.raises(ValueError, match="positive"):
        TV.VirialEquilibrium(tm, r_a=-1.0)
    df = tm.dm_virial.df
    again = TV.VirialEquilibrium(tm, "dark_matter", df=df.numpy())
    assert torch.equal(again.df, df)
    assert TV.VirialEquilibrium(tm, "stellar", df=df).df is not None


@pytest.mark.parametrize("r_a", [None, 1500.0])
def test_speed_table_matches_jax(jm, cm, r_a):
    """``_speed_table`` on the same fields and DF: row energies equal, the
    table inside the bounds of ``test_torch_model``'s table test (flat CDF
    rows stretch a CDF difference of 1e-5 to ~1e-4 in s)."""
    want_v = JV.VirialEquilibrium(jm, "dark_matter", r_a=r_a)
    got_v = TV.VirialEquilibrium(cm, "dark_matter", r_a=r_a,
                                 df=np.asarray(want_v.df))
    row_j, s_j = want_v._speed_table()
    row_t, s_t = got_v._speed_table()
    assert s_t.dtype == torch.float32 and s_t.shape == (N_POINTS, 512)
    _close(row_t, row_j, rtol=1e-14)
    diff = np.abs(s_t.numpy() - np.asarray(s_j))
    assert diff.max() < 3e-4
    assert (diff > 5e-6).mean() < 0.01
    # cached by n_rows: the second call returns the same tensors
    assert got_v._speed_table()[1] is s_t
    row64, s64 = got_v._speed_table(n_rows=64)
    assert s64.shape == (64, 512) and got_v._speed_table()[1] is s_t
    _close(row64, want_v._speed_table(n_rows=64)[0], rtol=1e-14)


def test_float64_cdf_option_still_gives_a_float32_table(jm, cm):
    """``velocity_table_float32: false``: the port builds the CDF in
    float64 from the spline at every query, rounds it to float32 and
    gives it the float32 path's ramp (1e-7 per bin) and inverts it
    through K1's formula, so the table is float32.  The JAX package's
    float64 table carries a ramp of 1e-12 per bin instead; the two agree
    to the ramp's shift of the quantiles: median under 5e-6, 3e-4 in the
    flattest rows, under 2% of entries above 5e-5."""
    v = jm.dm_virial
    ee, ff = np.asarray(v.ee), np.asarray(v.ff)
    rows = ee[::8].copy()
    want = np.asarray(JV.speed_inverse_cdf_table(
        jnp.asarray(ee), jnp.asarray(ff), n_s=256, n_q=128, table_dtype=None,
        row_ee=jnp.asarray(rows)))
    assert want.dtype == np.float64
    cdf = TV.speed_cdf_rows(_t(ee), _t(ff), n_s=256, table_dtype=None,
                            row_ee=_t(rows))
    got = TV.speed_inverse_cdf_table(_t(ee), _t(ff), n_s=256, n_q=128,
                                     table_dtype=None, row_ee=_t(rows))
    assert cdf.dtype == torch.float64 and got.dtype == torch.float32
    diff = np.abs(got.numpy() - want)
    assert diff.max() < 3e-4 and np.median(diff) < 5e-6
    assert (diff > 5e-5).mean() < 0.02


def test_hernquist_df_matches_the_analytic_form():
    """Eddington inversion against Hernquist (1990) eq. 17, as
    ``tests/test_hernquist_df.py`` holds the JAX package to it."""
    M, a = 1.0e15, 600.0
    m = tcg.ClusterModel.no_gas(0.5, 2.0e4, tcg.hernquist_density_profile(
        M, a), num_points=1000, device="cpu")
    v = m.dm_virial
    ee, ff = v.ee.numpy(), v.ff.numpy()
    v_g = np.sqrt(G * M / a)
    q = np.sqrt(ee * a / (G * M))
    pref = M / (8.0 * np.sqrt(2.0) * np.pi**3 * a**3 * v_g**3)
    term = (3.0 * np.arcsin(q) + q * np.sqrt(1.0 - q * q) * (1.0 - 2.0 * q * q)
            * (8.0 * q**4 - 8.0 * q * q - 3.0))
    f_ref = pref * term / (1.0 - q * q) ** 2.5
    sl = (q > 0.3) & (q < 0.85)
    rel = np.abs(ff[sl] - f_ref[sl]) / f_ref[sl]
    assert np.median(rel) < 2e-2 and rel.max() < 1.5e-1
    assert (ff > 0).all() and (np.diff(ff) > 0).mean() > 0.99
    rr = m["radius"].numpy()
    phi = m["gravitational_potential"].numpy()
    inner = slice(0, 750)
    assert (np.abs(phi[inner] + G * M / (rr[inner] + a))
            / (G * M / (rr[inner] + a))).max() < 5e-3


# ------------------------------------------------------------- the draws
def _iso_uniforms(key, n):
    k1, k2 = jax.random.split(key)
    return (_t(jax.random.uniform(k1, (n,), minval=-1.0, maxval=1.0,
                                  dtype=f64)),
            _t(jax.random.uniform(k2, (n,), dtype=f64)))


def _gas_uniforms(seed, num, sub_sample=1):
    """The uniforms of ``generate_gas_particles`` / ``_tracer_particles``
    for ``prng=seed``: ``split(key) -> (k_r, k_ang)``."""
    k_r, k_ang = jax.random.split(JSamp.parse_prng(seed))
    u_r = jax.random.uniform(k_r, (num // sub_sample,), dtype=f64)
    return _t(u_r), _iso_uniforms(k_ang, num)


def _collisionless_uniforms(seed, num, sub_sample=1):
    """The uniforms of ``generate_collisionless_particles``:
    ``split(key, 4) -> (k_r, k_ang, k_v, k_vang)``, and the inner split of
    ``sample_speeds_joint`` (float32 draws)."""
    k_r, k_ang, k_v, k_vang = jax.random.split(JSamp.parse_prng(seed), 4)
    n_sub = num // sub_sample
    kv, kb = jax.random.split(k_v)
    f32 = jnp.float32
    speed = tuple(torch.tensor(np.asarray(jax.random.uniform(k, (n_sub,),
                                                             dtype=f32)))
                  for k in (kv, kb))
    return (_t(jax.random.uniform(k_r, (n_sub,), dtype=f64)),
            _iso_uniforms(k_ang, num), speed, _iso_uniforms(k_vang, num))


def _compare_particles(got, want, n, speed_keys=()):
    assert set(got.keys()) == set(want.keys())
    for key in want.keys():
        w = np.asarray(want[key])
        g = got[key]
        assert g.dtype == torch.float64 and g.shape == w.shape, key
        assert g.shape[0] == n
        if key in speed_keys:
            sg, sw = np.linalg.norm(g.numpy(), axis=1), np.linalg.norm(w,
                                                                       axis=1)
            rel = np.abs(sg - sw) / np.maximum(sw, 1e-30)
            assert (rel > 1e-4).mean() <= 1e-4, (key, rel.max())
            # directions are float64 draws
            _close(g.numpy() / sg[:, None], w / sw[:, None], rtol=1e-7,
                   atol=1e-9)
        else:
            _close(g, w, atol=1e-12 * np.abs(w).max(), msg=str(key))


@pytest.mark.parametrize("sub_sample,num", [(1, 20_000), (3, 10_001)])
def test_gas_particles_match_jax(jm, cm, sub_sample, num):
    want = jm.generate_gas_particles(num, r_max=R_MAX, sub_sample=sub_sample,
                                     compute_potential=True, prng=11)
    got = cm.generate_gas_particles(
        num, r_max=R_MAX, sub_sample=sub_sample, compute_potential=True,
        uniforms=_gas_uniforms(11, num, sub_sample))
    _compare_particles(got, want, num)
    assert not bool(got["gas", "particle_velocity"].any())
    assert float(got["gas", "particle_position"].norm(dim=1).max()) <= R_MAX


def test_tracer_particles_match_jax(jm, cm):
    want = jm.generate_tracer_particles(6000, r_max=R_MAX, prng=12)
    got = cm.generate_tracer_particles(6000, r_max=R_MAX,
                                       uniforms=_gas_uniforms(12, 6000))
    _compare_particles(got, want, 6000)
    assert not bool(got["tracer", "particle_mass"].any())


@pytest.mark.parametrize("ptype,short", [("dark_matter", "dm"),
                                         ("stellar", "star")])
@pytest.mark.parametrize("sub_sample,num", [(1, 20_000), (3, 10_001)])
def test_collisionless_particles_match_jax(jm, cm, ptype, short, sub_sample,
                                           num):
    jv = jm.dm_virial if ptype == "dark_matter" else jm.star_virial
    tv = cm.dm_virial if ptype == "dark_matter" else cm.star_virial
    want = jv.generate_particles(num, r_max=R_MAX, sub_sample=sub_sample,
                                 compute_potential=True, prng=21)
    got = tv.generate_particles(
        num, r_max=R_MAX, sub_sample=sub_sample, compute_potential=True,
        uniforms=_collisionless_uniforms(21, num, sub_sample))
    _compare_particles(got, want, num,
                       speed_keys={(short, "particle_velocity")})
    m_in = float(np.interp(R_MAX, jm["radius"], jm[f"{ptype}_mass"]))
    total = float(got[short, "particle_mass"].sum())
    assert abs(total - m_in) / m_in < 2e-2  # the grid point below r_max


def test_osipkov_merritt_particles_match_jax(jm, cm):
    want_v = JV.VirialEquilibrium(jm, "dark_matter", r_a=1500.0)
    got_v = TV.VirialEquilibrium(cm, "dark_matter", r_a=1500.0,
                                 df=np.asarray(want_v.df))
    num = 20_000
    want = want_v.generate_particles(num, r_max=R_MAX, prng=31)
    got = got_v.generate_particles(num, r_max=R_MAX,
                                   uniforms=_collisionless_uniforms(31, num))
    _compare_particles(got, want, num,
                       speed_keys={("dm", "particle_velocity")})


def test_model_generators_route_to_the_virial_objects(cm):
    a = cm.generate_dm_particles(500, r_max=R_MAX, prng=5)
    b = cm.dm_virial.generate_particles(500, r_max=R_MAX, prng=5)
    assert torch.equal(a["dm", "particle_velocity"],
                       b["dm", "particle_velocity"])
    s = cm.generate_star_particles(500, r_max=R_MAX, prng=5)
    assert s.particle_types == ["star"]
    # one seed, one stream: another seed gives other particles
    c = cm.generate_dm_particles(500, r_max=R_MAX, prng=6)
    assert not torch.equal(a["dm", "particle_position"],
                           c["dm", "particle_position"])


def test_generate_particle_radii_and_sample_speeds_match_jax(jm, cm,
                                                             monkeypatch):
    key = JSamp.parse_prng(41)
    want, mtot_j = JSamp.generate_particle_radii(
        jm["radius"], jm["dark_matter_mass"], 5000, r_max=R_MAX, prng=key,
        dens=jm["dark_matter_density"])
    u = _t(jax.random.uniform(key, (5000,), dtype=f64))
    got, mtot_t = TSamp.generate_particle_radii(
        cm["radius"], cm["dark_matter_mass"], 5000, r_max=R_MAX,
        dens=cm["dark_matter_density"], uniforms=u)
    _close(got, want)
    _close(mtot_t, mtot_j, rtol=1e-14)
    # model arrays, as the JAX function takes them, go to ``device``
    host = cm.to_numpy()
    got_np, _ = TSamp.generate_particle_radii(
        host["radius"], host["dark_matter_mass"], 5000, r_max=R_MAX,
        dens=host["dark_matter_density"], uniforms=u, device="cpu")
    assert torch.equal(got_np, got)
    with monkeypatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TSamp.generate_particle_radii(host["radius"], host["gas_mass"],
                                          10, prng=1)
    # the bilinear draw straight from the table, on the JAX table
    v = jm.dm_virial
    row_ee, s_inv = v._speed_table()
    psi_p = np.interp(np.asarray(want), jm["radius"],
                      -jm["gravitational_potential"])
    k = jax.random.key(42)
    want_s = JV.sample_speeds(want, jnp.asarray(psi_p), row_ee, s_inv, k)
    uq = torch.tensor(np.asarray(jax.random.uniform(k, (5000,),
                                                    dtype=jnp.float32)))
    got_s = TV.sample_speeds(got, _t(psi_p), _t(row_ee),
                             torch.tensor(np.asarray(s_inv)), uniforms=uq)
    _close(got_s, want_s, rtol=2e-5)
    own = TV.sample_speeds(got, _t(psi_p), _t(row_ee),
                           torch.tensor(np.asarray(s_inv)),
                           generator=torch.Generator().manual_seed(1))
    assert (own.numpy() <= np.sqrt(2 * psi_p) * (1 + 1e-6)).all()


def test_truncated_cdf_matches_jax(jm, cm):
    for dens_key, r_max in ((None, None), ("dark_matter_density", R_MAX),
                            ("dark_matter_density", None), (None, 37.0)):
        dj = None if dens_key is None else jm[dens_key]
        dt = None if dens_key is None else cm[dens_key]
        Pj, rj, mj = JSamp._truncated_cdf(jm["radius"],
                                          jm["dark_matter_mass"], dj, r_max)
        Pt, rt, mt = TSamp._truncated_cdf(cm["radius"],
                                          cm["dark_matter_mass"], dt, r_max)
        _close(Pt, Pj, rtol=1e-15)
        _close(rt, rj, rtol=0)
        assert mt == mj
        nodes = TSamp._radius_quantile_nodes(Pt, rt)
        pairs = np.asarray(JSamp._radius_quantile_pairs(Pj, rj))
        _close(nodes[:-1], pairs[:, 0], rtol=1e-12)
        _close(nodes[-1], pairs[-1, 1], rtol=1e-12)
        if r_max is not None:  # the cap at the first P >= 1
            assert float(nodes.max()) <= r_max
    # zero-density points carry no probability: forward fill of the mass
    r = _t([1.0, 2.0, 3.0, 4.0])
    P, _, mtot = TSamp._truncated_cdf(r, _t([1.0, 2.0, 3.0, 9.0]),
                                      dens=_t([1.0, 1.0, 0.0, 0.0]))
    _close(P, [0.0, 0.5, 1.0, 1.0, 1.0])
    assert mtot == 2.0
    P, _, _ = TSamp._truncated_cdf(r, _t([1.0, 2.0, 3.0, 9.0]),
                                   dens=_t([0.0, 1.0, 1.0, 1.0]))
    _close(P, [0.0, 0.0, 2 / 9, 3 / 9, 1.0])


def test_r_max_below_the_grid_raises(cm):
    for call in (lambda: cm.generate_gas_particles(100, r_max=0.01),
                 lambda: cm.generate_dm_particles(100, r_max=0.05),
                 lambda: cm.generate_tracer_particles(100, r_max=0.0),
                 lambda: TSamp.generate_particle_radii(
                     cm["radius"], cm["gas_mass"], 10, r_max=0.01)):
        with pytest.raises(ValueError, match="below the first grid point"):
            call()


def test_parse_prng_forms(monkeypatch):
    def parse(prng):
        return TSamp.parse_prng(prng, device="cpu")

    g = parse(7)
    assert isinstance(g, torch.Generator) and g.initial_seed() == 7
    assert parse(np.int64(7)).initial_seed() == 7
    assert parse(g) is g
    a = parse(np.random.RandomState(3)).initial_seed()
    assert a == parse(np.random.RandomState(3)).initial_seed()
    assert parse(None).initial_seed() != parse(None).initial_seed()
    with pytest.raises(TypeError):
        parse("seed")
    with pytest.raises(ValueError, match="lives on"):
        TSamp.parse_prng(g, device="meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TSamp.parse_prng(7)  # the card is the default


def _ks(r, rr, cdf):
    r = np.sort(r)
    c = np.interp(r, rr, cdf)
    i = np.arange(1, r.size + 1)
    return max((i / r.size - c).max(), (c - (i - 1) / r.size).max())


@pytest.mark.parametrize("species", ["gas", "dm", "star", "tracer"])
def test_own_draws_follow_the_mass_cdf(cm, species):
    """The port's own generator (no JAX uniforms): KS distance of the
    radii from the model's truncated mass CDF under the 1e-4 critical
    value, radii inside r_max, speeds under the local escape speed."""
    n = 20_000
    gen = {"gas": cm.generate_gas_particles, "dm": cm.generate_dm_particles,
           "star": cm.generate_star_particles,
           "tracer": cm.generate_tracer_particles}[species]
    p = gen(n, r_max=R_MAX, prng=123)
    mkey = {"gas": "gas_mass", "dm": "dark_matter_mass",
            "star": "stellar_mass", "tracer": "gas_mass"}[species]
    dkey = {"dm": "dark_matter_density", "star": "stellar_density"}.get(
        species)
    P, rr, _ = TSamp._truncated_cdf(cm["radius"], cm[mkey],
                                    None if dkey is None else cm[dkey], R_MAX)
    r = p[species, "particle_position"].norm(dim=1).numpy()
    assert r.max() <= R_MAX
    assert _ks(r, rr.numpy(), P.numpy()) < 2.23 / np.sqrt(n) + 1.0 / 4095
    if species in ("dm", "star"):
        v = p[species, "particle_velocity"].norm(dim=1).numpy()
        psi = np.interp(r, cm["radius"].numpy(),
                        -cm["gravitational_potential"].numpy())
        assert (v <= np.sqrt(2.0 * psi) * (1.0 + 1e-3)).all()


@pytest.mark.parametrize("species", ["gas", "dm", "tracer"])
def test_draw_tables_are_kept_until_their_inputs_change(tm, species):
    """A second draw at the same ``r_max`` reuses the first one's tables
    and gives the same particles for the same seed; another ``r_max``, a
    field that was replaced and a field written in place each rebuild
    them."""
    m = tm.set_rmax(2e4)  # a model of this test's own
    gen = {"gas": m.generate_gas_particles, "dm": m.generate_dm_particles,
           "tracer": m.generate_tracer_particles}[species]
    owner = (lambda: m.dm_virial) if species == "dm" else (lambda: m)
    mkey = "dark_matter_mass" if species == "dm" else "gas_mass"
    pos = (species, "particle_position")

    first = gen(3000, r_max=R_MAX, prng=5)
    held = owner()._draw_tables
    again = gen(3000, r_max=R_MAX, prng=5)
    assert owner()._draw_tables is held
    assert torch.equal(first[pos], again[pos])

    gen(3000, r_max=0.5 * R_MAX, prng=5)
    assert owner()._draw_tables[0] == 0.5 * R_MAX
    back = gen(3000, r_max=R_MAX, prng=5)
    assert torch.equal(first[pos], back[pos])

    # a replaced field: the mass grows by half outside 300 kpc, so the
    # draws move outwards
    held = owner()._draw_tables
    grown = m[mkey] * torch.where(m["radius"] > 300.0, 1.5, 1.0)
    m.set_field(mkey, grown)
    moved = gen(3000, r_max=R_MAX, prng=5)
    assert owner()._draw_tables is not held
    assert float(moved[pos].norm(dim=1).mean()) \
        > float(first[pos].norm(dim=1).mean())
    # the same written in place
    held = owner()._draw_tables
    m[mkey].mul_(torch.where(m["radius"] > 300.0, 1.5, 1.0))
    gen(3000, r_max=R_MAX, prng=5)
    assert owner()._draw_tables is not held


# -------------------------------------------------------------- container
@pytest.fixture()
def parts(cm):
    return (cm.generate_gas_particles(400, r_max=R_MAX, prng=1)
            + cm.generate_dm_particles(500, r_max=R_MAX, prng=2,
                                       compute_potential=True)
            + cm.generate_star_particles(100, r_max=R_MAX, prng=3))


def test_particles_add_concatenates_and_drops_one_sided_fields(cm, parts):
    assert parts.num_particles == {"gas": 400, "dm": 500, "star": 100}
    assert sorted(parts.particle_types) == ["dm", "gas", "star"]
    more = cm.generate_dm_particles(50, r_max=R_MAX, prng=4)
    both = parts + more
    assert both.num_particles["dm"] == 550
    assert ("dm", "particle_potential") not in both.fields  # one-sided
    assert torch.equal(both["dm", "particle_mass"][:500],
                       parts["dm", "particle_mass"])
    assert all(v.dtype == torch.float64 for v in both.fields.values())
    assert "dm: 550" in repr(both)


def test_particles_offsets_cut_and_set_field(parts):
    before = parts["dm", "particle_position"].clone()
    parts.add_offsets([100.0, -50.0, 0.0], [0.1, 0.0, -0.2])
    _close(parts["dm", "particle_position"] - before,
           np.broadcast_to([100.0, -50.0, 0.0], (500, 3)), rtol=1e-12,
           atol=1e-9)
    _close(parts["gas", "particle_velocity"],
           np.broadcast_to([0.1, 0.0, -0.2], (400, 3)), rtol=1e-15)
    parts.make_radial_cut(800.0, center=[100.0, -50.0, 0.0])
    for sp in ("gas", "dm", "star"):
        r = (parts[sp, "particle_position"]
             - _t([100.0, -50.0, 0.0])).norm(dim=1)
        assert float(r.max()) <= 800.0
        n = parts.num_particles[sp]
        assert 0 < n == parts[sp, "particle_mass"].shape[0]
    n = parts.num_particles["gas"]
    parts.set_field("gas", "metallicity", np.full(n, 0.3),
                    passive_scalar=True)
    parts.set_field("gas", "metallicity", torch.full((n,), 0.2), add=True)
    # (the float32 0.2 is widened, not re-rounded)
    _close(parts["gas", "metallicity"], np.full(n, 0.5), rtol=1e-7)
    assert parts.passive_scalars == ["metallicity"]
    parts.set_field("gas", "particle_velocity", np.ones((n, 3)),
                    units="km/s")
    from cluster_generator_tpu_torch.core.constants import km_s

    _close(parts["gas", "particle_velocity"][0, 0], km_s, rtol=1e-12)
    with pytest.raises(ValueError, match=f"{n} particles"):
        parts.set_field("gas", "metallicity", np.ones(n + 1))
    with pytest.raises(RuntimeError, match="add=True"):
        parts.set_field("gas", "no_such_field", np.ones(n), add=True)


def test_particles_black_hole_drop_and_index_dtype(parts):
    parts.add_black_hole(1e9, use_pot_min=True)
    i = int(torch.argmin(parts["dm", "particle_potential"]))
    assert torch.equal(parts["black_hole", "particle_position"][0],
                       parts["dm", "particle_position"][i])
    parts.add_black_hole(2e9, pos=[1.0, 2.0, 3.0])
    assert parts.num_particles["black_hole"] == 2
    parts["dm", "particle_index"] = np.arange(500, dtype=np.int64)
    assert parts["dm", "particle_index"].dtype == torch.int64
    host = parts.to_numpy()
    assert host["dm", "particle_index"].dtype == np.int64
    assert host["gas", "density"].dtype == np.float64
    parts.drop_ptypes(["star", "black_hole"])
    assert sorted(parts.particle_types) == ["dm", "gas"]
    assert not any(k[0] == "star" for k in parts.keys())
    inside = parts._clip_to_box("dm", 4000.0)
    assert inside.dtype == torch.bool and 0 < int(inside.sum()) < 500
    again = tcg.ClusterParticles.from_fields(parts.fields)
    assert again.particle_types == ["gas", "dm"]


# --------------------------------------------------- files cross both ways
def test_model_h5_crosses_both_ways(jm, tm, tmp_path):
    ours, theirs = str(tmp_path / "torch.h5"), str(tmp_path / "jax.h5")
    tm.dm_virial, tm.star_virial  # noqa: B018
    tm.write_model_to_h5(ours)
    jm.write_model_to_h5(theirs)
    with pytest.raises(IOError, match="overwrite=False"):
        tm.write_model_to_h5(ours)
    back = jcg.ClusterModel.from_h5_file(ours)
    for k in tm.keys():
        np.testing.assert_array_equal(back[k], tm[k].numpy())
    assert back._dm_virial is not None and back._star_virial is not None
    np.testing.assert_array_equal(back.dm_virial.df, tm.dm_virial.df.numpy())
    got = tcg.ClusterModel.from_h5_file(theirs, device="cpu")
    for k in jm.keys():
        np.testing.assert_array_equal(got[k].numpy(), jm[k])
    # the DF is resumed, not recomputed
    assert got._dm_virial is not None and got._star_virial is not None
    np.testing.assert_array_equal(got.dm_virial.df.numpy(), jm.dm_virial.df)
    # cgs and masks round-trip through the port's own reader
    cgs = str(tmp_path / "cgs.h5")
    tm.write_model_to_h5(cgs, in_cgs=True, r_min=1.0, r_max=3000.0)
    sub = tcg.ClusterModel.from_h5_file(cgs, device="cpu")
    mask = (tm["radius"] >= 1.0) & (tm["radius"] <= 3000.0)
    assert sub.num_elements == int(mask.sum())
    _close(sub["density"], tm["density"][mask].numpy(), rtol=1e-13)
    assert sub.dm_virial.df.shape[0] == sub.num_elements
    jsub = jcg.ClusterModel.from_h5_file(cgs)
    _close(jsub["temperature"], tm["temperature"][mask].numpy(), rtol=1e-13)


def test_ascii_and_binary_files_are_byte_identical(jm, cm, tmp_path):
    """The same fields through both writers give the same bytes."""
    for in_cgs in (False, True):
        a, b = tmp_path / f"t{in_cgs}.ecsv", tmp_path / f"j{in_cgs}.ecsv"
        cm.write_model_to_ascii(str(a), in_cgs=in_cgs)
        jm.write_model_to_ascii(str(b), in_cgs=in_cgs)
        assert a.read_bytes() == b.read_bytes()
        a, b = tmp_path / f"t{in_cgs}.dat", tmp_path / f"j{in_cgs}.dat"
        kw = dict(in_cgs=in_cgs, r_max=4000.0,
                  fields_to_write=["radius", "density", "pressure"])
        cm.write_model_to_binary(str(a), **kw)
        jm.write_model_to_binary(str(b), **kw)
        assert a.read_bytes() == b.read_bytes()
    with pytest.raises(IOError, match="overwrite=False"):
        cm.write_model_to_ascii(str(tmp_path / "tFalse.ecsv"))
    with pytest.raises(IOError, match="overwrite=False"):
        cm.write_model_to_binary(str(tmp_path / "tFalse.dat"))
    cm.write_model_to_ascii(str(tmp_path / "tFalse.ecsv"), overwrite=True)


def test_particle_files_cross_both_ways(jm, parts, tmp_path):
    ours, theirs = str(tmp_path / "torch.h5"), str(tmp_path / "jax.h5")
    parts["dm", "particle_index"] = np.arange(500, dtype=np.int64)
    parts.write_particles(ours)
    with pytest.raises(IOError, match="overwrite=False"):
        parts.write_particles(ours)
    back = jcg.ClusterParticles.from_file(ours)
    assert sorted(back.particle_types) == sorted(parts.particle_types)
    for k, v in parts.fields.items():
        np.testing.assert_array_equal(back[k], v.numpy())
    assert back["dm", "particle_index"].dtype == np.int64
    jp = jm.generate_dm_particles(300, r_max=R_MAX, prng=8)
    jp.write_particles(theirs)
    got = tcg.ClusterParticles.from_file(theirs, device="cpu")
    for k, v in jp.fields.items():
        np.testing.assert_array_equal(got[k].numpy(), v)
    only = tcg.ClusterParticles.from_h5_file(ours, ptypes="gas",
                                             device="cpu")
    assert only.particle_types == ["gas"]
