"""The port's fused binary-merger IC against the JAX package's, as a whole.

Two halos with bench.py's M200, c, centers, velocities and r_max, on the
1000-point grid, with a few thousand particles per species, through both
packages' ``merger_ic_fused``.  The port gets the exact uniforms that
``jax.random.uniform`` returns at each of the JAX function's random sites
(its key splits repeated here), so the draws can be compared one by one.
Tolerances:

* float64 fields rtol 1e-9, DFs rtol 1e-6 (spline-derivative roundoff);
* radius tables rtol 5e-6; speed tables as in
  tests/test_torch_model.py::test_speed_table_canonical_model;
* positions (per particle, relative to its size), masses, gas density and
  thermal energy rtol 2e-5: float32 draws through other sin/cos/log;
* speeds rtol 1e-4, except that at most 1e-4 of particles may differ by
  more: the row pick ``u < w`` of the joint speed table flips where u and
  w tie in float32;
* gas velocities to 2e-5 of the largest bulk speed (the mixed velocity
  cancels near the midplane, so a relative bound means nothing there).

The port's own ``torch.Generator`` draws then pass the distribution checks
of tests/test_pipeline.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import kstest

from cluster_generator_tpu import pipeline as JP
from cluster_generator_tpu_torch import pipeline as TP
from cluster_generator_tpu_torch.convert import (
    fields_from_numpy,
    tables_from_numpy,
    to_numpy,
)

torch.set_num_threads(1)

M200 = [1.5e15, 1.0e15]
CONC = [4.0, 5.0]
CENTERS = [[-1500.0, 0.0, 0.0], [1500.0, 0.0, 0.0]]
VELS = [[0.3, 0.0, 0.0], [-0.45, 0.0, 0.0]]
R_MAX = [5000.0, 5000.0]
NG, ND, NS = (3000, 2000), (2400, 1600), (600, 400)


def _jax_uniforms(key, ng, nd, ns):
    """The uniforms of JP.sample_merger_ic at every random site, keyed as
    the port's ``uniforms`` argument: the key splits into 4H keys
    (pipeline.py:397), each collisionless key into 5 (:279), each gas key
    into 2 (:319), each direction key into 2 (_isotropic, :220)."""
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

    keys = jax.random.split(key, 4 * len(ng))
    out = {}
    for i in range(len(ng)):
        kr, ka = jax.random.split(keys[4 * i])
        out["gas", i] = t((jax.random.uniform(kr, (ng[i],), dtype=f32),
                           iso(ka, ng[i])))
        for kind, n, off in (("dm", nd, 1), ("star", ns, 2)):
            kr, kv, kb, ka, kva = jax.random.split(keys[4 * i + off], 5)
            out[kind, i] = t(tuple(jax.random.uniform(k, (n[i],), dtype=f32)
                                   for k in (kr, kv, kb))
                             + (iso(ka, n[i]), iso(kva, n[i])))
    return out


@pytest.fixture(scope="module")
def runs():
    key = jax.random.key(7)
    j_parts, j_fields = JP.merger_ic_fused(
        jnp.asarray(M200), jnp.asarray(CONC), jnp.asarray(CENTERS),
        jnp.asarray(VELS), jnp.asarray(R_MAX), key, NG, ND, NS)
    j_tables = JP.build_speed_tables(j_fields)
    j_tables["radius"] = JP.build_radius_tables(j_fields,
                                                jnp.asarray(R_MAX))
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa
    unif = _jax_uniforms(key, NG, ND, NS)

    t_fields = TP.build_merger_models(M200, CONC, device="cpu")
    t_tables = TP.build_speed_tables(t_fields)
    t_tables["radius"] = TP.build_radius_tables(t_fields, R_MAX)
    t_parts = TP.sample_merger_ic(t_fields, t_tables, CENTERS, VELS, R_MAX,
                                  NG, ND, NS, uniforms=unif)
    return {"j_parts": to_np(j_parts), "j_fields": to_np(j_fields),
            "j_tables": to_np(j_tables), "unif": unif,
            "t_fields": t_fields, "t_tables": t_tables,
            "t_parts": to_numpy(t_parts)}


def _bulk(n):
    return np.concatenate([np.repeat(np.asarray(VELS[i])[None], n[i], 0)
                           for i in range(2)])


def _check_draws(got, want, nd=ND, ns=NS):
    assert set(got) == set(want)
    vmax = max(abs(v[0]) for v in VELS)
    for (sp, name), a in want.items():
        b = got[sp, name]
        assert b.shape == a.shape and b.dtype == np.float32, (sp, name)
        a, b = a.astype(np.float64), b.astype(np.float64)
        if name == "particle_velocity" and sp == "gas":
            assert np.abs(a - b).max() < 2e-5 * vmax, sp
        elif name == "particle_velocity":
            bulk = _bulk(nd if sp == "dm" else ns)
            sa = np.linalg.norm(a - bulk, axis=1)
            sb = np.linalg.norm(b - bulk, axis=1)
            rel = np.abs(sa - sb) / sa
            assert (rel > 1e-4).mean() <= 1e-4, (sp, rel.max())
        elif a.ndim == 2:
            rel = np.linalg.norm(a - b, axis=1) / np.linalg.norm(a, axis=1)
            assert rel.max() < 2e-5, (sp, name, rel.max())
        else:
            np.testing.assert_allclose(b, a, rtol=2e-5, err_msg=f"{sp} {name}")


def test_fused_shapes_and_dtypes(runs):
    """Both packages' merger_ic_fused: the same outputs, shapes and
    dtypes; the port's fused call equals its staged calls exactly."""
    unif = runs["unif"]
    t_parts, t_fields = TP.merger_ic_fused(M200, CONC, CENTERS, VELS, R_MAX,
                                           NG, ND, NS, uniforms=unif,
                                           device="cpu")
    t_parts, t_fields = to_numpy(t_parts), to_numpy(t_fields)
    assert set(t_parts) == set(runs["j_parts"])
    for k, a in runs["j_parts"].items():
        assert t_parts[k].shape == a.shape and t_parts[k].dtype == a.dtype
        np.testing.assert_array_equal(t_parts[k], runs["t_parts"][k])
    assert set(t_fields) == set(runs["j_fields"])
    for k, a in runs["j_fields"].items():
        assert t_fields[k].shape == a.shape and t_fields[k].dtype == a.dtype


def test_fields_match(runs):
    for k, want in runs["j_fields"].items():
        tol = 1e-6 if k.endswith("_df") else 1e-9
        np.testing.assert_allclose(runs["t_fields"][k].numpy(), want,
                                   rtol=tol, err_msg=k)


def test_tables_match(runs):
    t_tab, j_tab = to_numpy(runs["t_tables"]), runs["j_tables"]
    for k in ("gas", "dm", "star"):
        np.testing.assert_allclose(t_tab["radius"][k], j_tab["radius"][k],
                                   rtol=5e-6, err_msg=k)
        np.testing.assert_allclose(t_tab["radius"][k + "_mtot"],
                                   j_tab["radius"][k + "_mtot"], rtol=1e-9)
    for k in ("dm", "star"):
        assert t_tab[k].shape == j_tab[k].shape and t_tab[k].dtype == np.float32
        diff = np.abs(t_tab[k] - j_tab[k])
        assert diff.max() < 3e-4 and (diff > 5e-6).mean() < 0.01, k


def test_draws_match_with_jax_uniforms(runs):
    _check_draws(runs["t_parts"], runs["j_parts"])


def test_draw_stage_from_jax_state(runs):
    """The JAX package's fields and tables carried across (convert.py)
    into the port's draw stage give the JAX draws."""
    fields = fields_from_numpy(runs["j_fields"], device="cpu")
    tables = tables_from_numpy(runs["j_tables"], device="cpu")
    parts = TP.sample_merger_ic(fields, tables, CENTERS, VELS, R_MAX, NG, ND,
                                NS, uniforms=runs["unif"])
    _check_draws(to_numpy(parts), runs["j_parts"])


# ------------------------------------------- the port's own generator draws
N_TOT = {"gas": 100_000, "dm": 80_000, "star": 20_000}


@pytest.fixture(scope="module")
def merger():
    gen = torch.Generator().manual_seed(3)
    parts, fields, tables = TP.binary_merger_ic(
        M200, CONC, CENTERS, VELS, N_TOT, generator=gen, device="cpu")
    return to_numpy(parts), to_numpy(fields), to_numpy(tables)


def _dm_split(fields):
    m_at = [np.interp(5000.0, fields["radius"][i],
                      fields["dark_matter_mass"][i]) for i in range(2)]
    return int(round(N_TOT["dm"] * m_at[0] / sum(m_at)))


def test_counts_dtypes_and_finite(merger):
    parts, _, _ = merger
    for sp, n in N_TOT.items():
        assert parts[sp, "particle_position"].shape == (n, 3)
        assert parts[sp, "particle_velocity"].dtype == np.float32
    for v in parts.values():
        assert np.isfinite(v).all()


def test_bulk_velocities(merger):
    parts, fields, _ = merger
    n1 = _dm_split(fields)
    vx = parts["dm", "particle_velocity"][:, 0]
    assert abs(vx[:n1].mean() - 0.3) < 0.02
    assert abs(vx[n1:].mean() + 0.45) < 0.02
    gvx = parts["gas", "particle_velocity"][:, 0]
    assert gvx.min() >= -0.45 - 1e-5 and gvx.max() <= 0.3 + 1e-5


def test_speeds_below_escape(merger):
    parts, fields, _ = merger
    psi_max = float(np.max(-fields["gravitational_potential"]))
    for sp in ("dm", "star"):
        vel = parts[sp, "particle_velocity"].astype(np.float64)
        speed = np.linalg.norm(vel - np.array([[0.3, 0, 0]]), axis=1)
        assert (speed < np.sqrt(2 * psi_max) + 0.45 + 1e-3).all()


def test_radius_distribution_and_r_max(merger):
    """KS: halo-1 DM radii against the model's mass profile; no species
    reaches past r_max."""
    parts, fields, tables = merger
    rr, mm = fields["radius"][0], fields["dark_matter_mass"][0]
    n1 = _dm_split(fields)
    r = np.linalg.norm(parts["dm", "particle_position"][:n1].astype(
        np.float64) - CENTERS[0], axis=1)
    m_rmax = np.interp(5000.0, rr, mm)

    def cdf(x):
        return np.interp(x, np.insert(rr, 0, 0),
                         np.insert(np.clip(mm / m_rmax, 0, 1), 0, 0))

    _, pval = kstest(r, cdf)
    assert pval > 1e-4
    for sp in ("gas", "dm", "star"):
        assert tables["radius"][sp].max() <= 5000.0
        pos = parts[sp, "particle_position"].astype(np.float64)
        r0 = np.linalg.norm(pos - CENTERS[0], axis=1)
        r1 = np.linalg.norm(pos - CENTERS[1], axis=1)
        assert (np.minimum(r0, r1) <= 5000.0 + 1e-3).all()


def test_gas_mixing_matches_two_halo_sums(merger):
    parts, fields, _ = merger
    pos = parts["gas", "particle_position"][:500].astype(np.float64)
    d_sum = np.zeros(500)
    e_sum = np.zeros(500)
    for i in range(2):
        rr, dd = fields["radius"][i], fields["density"][i]
        r = np.linalg.norm(pos - CENTERS[i], axis=1)
        di = np.interp(r, rr, dd)
        d_sum += di
        e_sum += np.interp(r, rr, 1.5 * fields["pressure"][i] / dd) * di
    # log-grid lerp vs np.interp's linear-in-r lerp: O(dr^2) ~ 1e-4 apart
    np.testing.assert_allclose(parts["gas", "density"][:500], d_sum,
                               rtol=5e-4)
    np.testing.assert_allclose(parts["gas", "thermal_energy"][:500],
                               e_sum / d_sum, rtol=5e-4)


def test_entry_points_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TP.merger_ic_fused(M200, CONC, CENTERS, VELS, R_MAX, NG, ND, NS)
