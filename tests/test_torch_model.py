"""The port's profiles, solvers, gravity, builders, ensemble build and
virial modules against the JAX package's.

Inputs are the same numbers (made with numpy) in both packages; the port
builds every halo of a batch in one call and its rows are compared with
the JAX functions halo by halo.  Tolerances:

* float64 fields: rtol 1e-9 (observed ~1e-14: the same formulas, another
  summation order and other libm calls);
* DFs: rtol 1e-6 — f(E) is the derivative of a spline of an Abel
  integral, which turns the fields' 1e-15 roundoff into ~1e-8;
* inverse speed-CDF tables: see :func:`test_speed_table_canonical_model`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cluster_generator_tpu.ops.pallas_kernels as JK
import cluster_generator_tpu.profiles.library as JL
import cluster_generator_tpu.profiles.relations as JR
import cluster_generator_tpu.profiles.solvers as JS
import cluster_generator_tpu.virial as JV
import cluster_generator_tpu_torch.profiles.library as TL
import cluster_generator_tpu_torch.profiles.relations as TR
import cluster_generator_tpu_torch.profiles.solvers as TS
import cluster_generator_tpu_torch.virial as TV
from cluster_generator_tpu.core.grid import numpy_log_radius_grid
from cluster_generator_tpu.model.builders import (
    build_from_dens_and_tden as j_build,
)
from cluster_generator_tpu.parallel.ensemble import (
    build_one_cluster as j_build_one,
)
from cluster_generator_tpu_torch.model.builders import (
    build_from_dens_and_tden as t_build,
)
from cluster_generator_tpu_torch.model.gravity import field_for_law
from cluster_generator_tpu_torch.ops.cdf_inverse import invert_cdf_rows_plain
from cluster_generator_tpu_torch.parallel.ensemble import (
    build_one_cluster as t_build_one,
)

torch.set_num_threads(1)

RTOL = 1e-9
DF_RTOL = 1e-6
M200 = np.array([1.5e15, 1.0e15])
CONC = np.array([4.0, 5.0])


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _close(got, want, rtol=RTOL, atol=0.0, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


# ------------------------------------------------------------ configuration
def test_same_table_knobs_and_override_file(tmp_path):
    """Both packages read the same numerical defaults and the same
    override file, so they build tables of the same size."""
    from cluster_generator_tpu.core.config import load_config as j_load
    from cluster_generator_tpu_torch.core.config import load_config as t_load

    j_kw, t_kw = JV.speed_table_defaults(), TV.speed_table_defaults()
    assert t_kw["table_dtype"] == torch.float32
    assert j_kw["table_dtype"] == jnp.float32
    for k in ("n_s", "n_q", "nf1", "nf2"):
        assert t_kw[k] == j_kw[k]
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("numerical:\n  velocity_table_speeds: 128\n"
                   "  df_node_grid_top: 64\n")
    j_num, t_num = j_load(str(cfg))["numerical"], t_load(str(cfg))["numerical"]
    for k, v in t_num.items():
        assert j_num[k] == v, k
    assert t_num["velocity_table_speeds"] == 128


# --------------------------------------------------------- profiles, solvers
def test_profiles_and_relations():
    r = np.geomspace(0.1, 1e4, 300)
    M, a = np.array([1.2e15, 7.0e14]), np.array([450.0, 280.0])
    rr = np.stack([r, r])
    for t_fn, j_fn in [(TL.snfw_density_profile, JL.snfw_density_profile),
                       (TL.snfw_mass_profile, JL.snfw_mass_profile)]:
        got = t_fn(_t(M), _t(a))(_t(rr)).numpy()
        for i in range(2):
            _close(got[i], np.asarray(j_fn(M[i], a[i])(jnp.asarray(r))))
    _close(TL.snfw_total_mass(_t(M), _t([2000.0, 1800.0]), _t(a)).numpy(),
           [float(JL.snfw_total_mass(M[i], [2000.0, 1800.0][i], a[i]))
            for i in range(2)])
    vik_t = 3.0 * TL.vikhlinin_density_profile(1.0, 100.0, 2000.0, 1.0,
                                               0.67, 3)
    vik_j = 3.0 * JL.vikhlinin_density_profile(1.0, 100.0, 2000.0, 1.0,
                                               0.67, 3)
    _close(vik_t(_t(r)).numpy(), np.asarray(vik_j(jnp.asarray(r))))
    _close(TR.f_gas(_t([4e14, 9e14])).numpy(),
           np.asarray(JR.f_gas(jnp.asarray([4e14, 9e14]))))


def test_solvers_batched_bisection():
    """mass_within, the overdensity radius and the 100-step bisection of
    find_radius_mass, every halo in one call; NaN where the bracket does
    not straddle a root, as in the JAX package."""
    r200_t = TS.find_overdensity_radius(_t(M200), 200.0, z=0.1)
    r200_j = [float(JS.find_overdensity_radius(m, 200.0, z=0.1))
              for m in M200]
    _close(r200_t.numpy(), r200_j, rtol=1e-14)
    a = r200_t / _t(CONC)
    M = TL.snfw_total_mass(_t(M200), r200_t, a)
    r500_t, m500_t = TS.find_radius_mass(TL.snfw_mass_profile(M, a), z=0.1,
                                         delta=500.0, like=M)
    for i in range(2):
        Mt_j = JL.snfw_mass_profile(float(M[i]), float(a[i]))
        r500_j, m500_j = JS.find_radius_mass(Mt_j, z=0.1, delta=500.0)
        _close(float(r500_t[i]), float(r500_j), rtol=1e-12)
        _close(float(m500_t[i]), float(m500_j), rtol=1e-12)
        prof_j = JL.snfw_density_profile(float(M[i]), float(a[i]))
        _close(float(TS.mass_within(TL.snfw_density_profile(M, a),
                                    r500_t)[i]),
               float(JS.mass_within(prof_j, float(r500_t[i]))))
    # a profile whose r_500 lies beyond the bracket in one halo only
    tiny = TL.snfw_mass_profile(_t([1e15, 1e30]), _t([300.0, 300.0]))
    r_t, _ = TS.find_radius_mass(tiny, z=0.1, delta=500.0,
                                 like=_t([0.0, 0.0]))
    r_j, _ = JS.find_radius_mass(JL.snfw_mass_profile(1e30, 300.0), z=0.1,
                                 delta=500.0)
    assert np.isfinite(float(r_t[0])) and np.isnan(float(r_t[1]))
    assert np.isnan(float(r_j))


# ------------------------------------------------------- gravity, builders
def test_newtonian_field_and_unported_laws():
    rr = _t(np.geomspace(0.1, 1e4, 50))
    m = _t(np.geomspace(1e8, 1e15, 50))
    from cluster_generator_tpu.model.gravity import newtonian_field

    _close(field_for_law(rr, m).numpy(),
           np.asarray(newtonian_field(jnp.asarray(rr.numpy()),
                                      jnp.asarray(m.numpy()))))
    with pytest.raises(KeyError, match="Unknown gravity law"):
        field_for_law(rr, m, "no_such_law")


def test_build_from_dens_and_tden_batched():
    """Two halos' HSE fields in one call, each equal to the JAX build."""
    rr = numpy_log_radius_grid(0.1, 1e4, 400)
    M, a = np.array([1.3e15, 8.0e14]), np.array([500.0, 350.0])
    rc = np.array([100.0, 80.0])
    rhot_t = TL.snfw_density_profile(_t(M), _t(a))
    rhog_t = _t([2.0e6, 1.5e6]) * TL.vikhlinin_density_profile(
        1.0, _t(rc), 2000.0, 1.0, 0.67, 3)
    got = t_build(_t(np.stack([rr, rr])), rhog_t, rhot_t,
                  stellar_density=0.02 * rhot_t)
    for i in range(2):
        rhot_j = JL.snfw_density_profile(M[i], a[i])
        rhog_j = [2.0e6, 1.5e6][i] * JL.vikhlinin_density_profile(
            1.0, rc[i], 2000.0, 1.0, 0.67, 3)
        want = j_build(jnp.asarray(rr), rhog_j, rhot_j,
                       stellar_density=0.02 * rhot_j)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == torch.float64
            _close(got[k][i].numpy(), np.asarray(want[k]), msg=k)


@pytest.fixture(scope="module")
def clusters():
    """The canonical merger clusters (bench.py's M200 and c) on a
    300-point grid: the port's batch and the JAX package's per halo."""
    t = t_build_one(_t(M200), _t(CONC), num_points=300)
    j_fn = jax.jit(j_build_one, static_argnames=("num_points",))
    j = [jax.tree_util.tree_map(np.asarray,
                                j_fn(M200[i], CONC[i], num_points=300))
         for i in range(2)]
    return t, j


def test_build_one_cluster_batched(clusters):
    t, j = clusters
    for i in range(2):
        assert set(t) == set(j[i])
        for k in j[i]:
            tol = DF_RTOL if k.endswith("_df") else RTOL
            _close(t[k][i].numpy(), j[i][k], rtol=tol, msg=k)


# ------------------------------------------------------------------ virial
def test_compute_df_batched(clusters):
    t, j = clusters
    ee = -torch.flip(t["gravitational_potential"], (-1,))
    sden = torch.flip(t["stellar_density"], (-1,))
    got = torch.flip(TV.compute_df(ee, sden), (-1,)).numpy()
    for i in range(2):
        ee_j = -j[i]["gravitational_potential"][::-1]
        want = np.asarray(JV.compute_df(jnp.asarray(ee_j), jnp.asarray(
            j[i]["stellar_density"][::-1])))[::-1]
        _close(got[i], want, rtol=DF_RTOL)
        g_t = TV._abel_g_exact(TV.cubic_spline(ee[i], sden[i]), ee[i])
        sp_j = JV.cubic_spline(jnp.asarray(ee_j), jnp.asarray(
            j[i]["stellar_density"][::-1]))
        _close(g_t.numpy(), np.asarray(JV._abel_g_exact(sp_j,
                                                        jnp.asarray(ee_j))),
               rtol=1e-8)


def test_speed_table_canonical_model(canonical_model, monkeypatch):
    """The float32 inverse speed-CDF table of the canonical model.

    * The CDF rows agree to 1e-5.  Both build them in float32 from the
      same float64 node table, but the JAX package sums the trapezoid
      increments as a float32 triangular matmul (a TPU workaround,
      core/scan_ops.py) where the port sums in float64 and rounds once,
      and XLA fuses the float32 node-table lerp: the JAX package's own
      eager and jitted runs of this function differ by 6.8e-6.
    * Inverting the JAX package's own CDF rows, the port agrees with the
      JAX inversions to < 5e-6.
    * End to end the tables agree to < 5e-6 except where a row's CDF is
      nearly flat: there a CDF difference dc moves s by dc / (n_s pdf),
      up to ~1e-4 (bounded here at 3e-4, and at most 1% of entries above
      5e-6).
    """
    v = canonical_model.dm_virial
    ee, ff = np.asarray(v.ee), np.asarray(v.ff)
    row_ee = ee[::4].copy()  # every 4th grid energy: 250 rows
    n_s, n_q = 512, 512
    kw = dict(n_s=n_s, table_dtype=jnp.float32, row_ee=jnp.asarray(row_ee))
    want = np.asarray(JV.speed_inverse_cdf_table(jnp.asarray(ee),
                                                 jnp.asarray(ff), n_q=n_q,
                                                 **kw))
    # the JAX package's CDF rows: its own function, traced afresh with the
    # inversion replaced by the identity
    monkeypatch.setattr(JK, "invert_cdf_rows", lambda cdf, n_q: cdf)
    cdf_fn = jax.jit(lambda e, f: JV.speed_inverse_cdf_table.__wrapped__(
        e, f, n_q=n_q, use_pallas=True, **kw))
    cdf_j = np.array(cdf_fn(jnp.asarray(ee), jnp.asarray(ff)))
    monkeypatch.undo()

    kw_t = dict(n_s=n_s, table_dtype=torch.float32, row_ee=_t(row_ee))
    cdf_t = TV.speed_cdf_rows(_t(ee), _t(ff), **kw_t)
    got = TV.speed_inverse_cdf_table(_t(ee), _t(ff), n_q=n_q,
                                     **kw_t).numpy()
    assert cdf_t.dtype == torch.float32 and got.dtype == np.float32
    assert np.abs(cdf_t.numpy() - cdf_j).max() < 1e-5

    inv_t = invert_cdf_rows_plain(torch.from_numpy(cdf_j), n_q).numpy()
    inv_ref = np.asarray(JK.invert_cdf_rows_reference(jnp.asarray(cdf_j),
                                                      n_q=n_q))
    assert np.abs(inv_t - inv_ref).max() < 5e-6
    rows = slice(0, None, 9)  # the interpreted Pallas kernel on 28 rows
    inv_pallas = np.asarray(JK.invert_cdf_rows(jnp.asarray(cdf_j[rows]),
                                               n_q=n_q, interpret=True))
    assert np.abs(inv_t[rows] - inv_pallas).max() < 5e-6

    diff = np.abs(got - want)
    assert diff.max() < 3e-4
    assert (diff > 5e-6).mean() < 0.01
