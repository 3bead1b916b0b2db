"""The ensemble datagen batch program of the PyTorch port against the JAX
package's, on the CPU, at a small size (3 clusters, a 128-point grid, a few
thousand particles).

* ``loguniform_lerp`` and ``build_joint_speed_pairs`` get the same
  numpy-seeded inputs as their JAX twins: rtol 1e-6 in float32.
* The whole core runs against ``_datagen_full_batch_fn`` with the uniforms
  ``jax.random`` gives at each of the JAX program's random sites (its key
  folds and splits repeated here), isotropic and Osipkov-Merritt.
  Positions, velocities and energies agree to 1e-4 relative, with < 1% of
  entries above 1e-5; particle masses to 1e-6.  The speed tables behind the
  velocities are only that close: the JAX package sums its CDF as a float32
  matmul and fuses its float32 node lerp, and a nearly flat CDF row
  stretches one float32 ulp to ~1e-5 in s (tests/test_torch_model.py has
  the table parity itself).  A particle whose Bernoulli row pick ``u < w``
  ties in float32 lands in the neighbouring table row; such flips count
  among the < 1%.
* The port's own ``torch.Generator`` draws pass the distribution checks:
  KS of radii against the model's mass CDF, speeds under the local escape
  speed, the OM anisotropy profile, batch reproducibility.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import kstest

from cluster_generator_tpu.core.interp import (
    loguniform_lerp as j_loguniform_lerp,
)
from cluster_generator_tpu import virial as JV
from cluster_generator_tpu.parallel import ensemble as JE
from cluster_generator_tpu_torch import virial as TV
from cluster_generator_tpu_torch.convert import (
    datagen_batch_from_numpy,
    to_numpy,
)
from cluster_generator_tpu_torch.core import interp as TI
from cluster_generator_tpu_torch.parallel import ensemble as TE
from cluster_generator_tpu_torch.parallel.qa import QA_TOLERANCES

torch.set_num_threads(1)

NUM_POINTS = 128
COUNTS = {"dm": 2000, "gas": 1500, "star": 500}
R_A = 1000.0


def _params(n=3, seed=2):
    rng = np.random.RandomState(seed)
    M200 = 10.0 ** rng.uniform(14.0, 15.3, n)
    conc = np.clip(5.0 * (M200 / 1e15) ** -0.1
                   * np.exp(0.3 * rng.randn(n)), 3.0, 8.0)
    return M200, conc


# ------------------------------------------------------ deterministic parts
def test_loguniform_lerp_matches_jax():
    rng = np.random.RandomState(0)
    x = np.geomspace(0.1, 1.0e4, 200)
    y = np.exp(rng.randn(2, 200).cumsum(axis=1) * 0.1).astype(np.float32)
    xq = np.exp(rng.uniform(np.log(0.05), np.log(2.0e4), (2, 5000))
                ).astype(np.float32)
    got = TI.loguniform_lerp(torch.from_numpy(xq),
                             torch.from_numpy(np.stack([x, x])),
                             torch.from_numpy(y)).numpy()
    assert got.dtype == np.float32
    for i in range(2):
        want = j_loguniform_lerp(jnp.asarray(xq[i]), jnp.asarray(x),
                                  jnp.asarray(y[i]))
        np.testing.assert_allclose(got[i], np.asarray(want), rtol=1e-6)
    # np.interp semantics with clamped ends
    ref = np.interp(xq[0].astype(np.float64), x, y[0].astype(np.float64))
    np.testing.assert_allclose(got[0], ref, rtol=5e-5)


def test_build_joint_speed_pairs_matches_jax():
    rng = np.random.RandomState(1)
    n_rows, n_q, rq = 32, 64, 256
    rr = np.geomspace(0.1, 1.0e4, NUM_POINTS)
    psi = np.stack([3.0 / (1.0 + rr / 300.0), 5.0 / (1.0 + rr / 150.0)])
    idx = np.unique(np.round(np.linspace(0, NUM_POINTS - 1,
                                         n_rows)).astype(int))
    row_ee = psi[:, ::-1][:, idx]
    s_inv = np.sort(rng.rand(2, n_rows, n_q), axis=-1).astype(np.float32)
    r_q = np.sort(np.exp(rng.uniform(np.log(0.2), np.log(9000.0),
                                     (2, rq))), axis=-1)
    got = TV.build_joint_speed_pairs(
        torch.from_numpy(np.stack([rr, rr])), torch.from_numpy(psi),
        torch.from_numpy(row_ee.copy()), torch.from_numpy(s_inv),
        torch.from_numpy(r_q)).numpy()
    assert got.shape == (2, rq, n_q) and got.dtype == np.float32
    for i in range(2):
        pairs = np.asarray(JV.build_joint_speed_pairs(
            jnp.asarray(rr), jnp.asarray(psi[i]), jnp.asarray(row_ee[i]),
            jnp.asarray(s_inv[i]), jnp.asarray(r_q[i])))
        pairs = pairs.reshape(rq, n_q - 1, 2)
        np.testing.assert_allclose(got[i, :, :-1], pairs[..., 0], rtol=1e-6)
        np.testing.assert_allclose(got[i, :, 1:], pairs[..., 1], rtol=1e-6)


def test_sample_ensemble_params_and_prorate():
    gen = torch.Generator().manual_seed(4)
    M200, conc = TE.sample_ensemble_params(gen, 500, device="cpu")
    assert M200.dtype == conc.dtype == torch.float64
    assert float(M200.min()) >= 1e14 and float(M200.max()) <= 10 ** 15.3
    assert float(conc.min()) >= 3.0 and float(conc.max()) <= 8.0
    # conc falls with mass
    lo, hi = M200 < 3e14, M200 > 1e15
    assert float(conc[lo].mean()) > float(conc[hi].mean())
    again, _ = TE.sample_ensemble_params(torch.Generator().manual_seed(4),
                                         500, device="cpu")
    assert torch.equal(M200, again)

    got = TE.prorate_species_counts(100_000, num_points=NUM_POINTS,
                                    device="cpu")
    want = JE.prorate_species_counts(100_000, num_points=NUM_POINTS)
    assert sum(got.values()) == 100_000
    assert all(abs(got[k] - want[k]) <= 1 for k in want)


def test_build_ensemble_matches_jax():
    M200, conc = _params()
    got = TE.build_ensemble(M200, conc, num_points=NUM_POINTS, device="cpu")
    want = JE.build_ensemble(jnp.asarray(M200), jnp.asarray(conc),
                             num_points=NUM_POINTS)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w),
                                   rtol=1e-6 if k == "dm_df" else 1e-9,
                                   err_msg=k)


# ------------------------------------------------- the core, same uniforms
def _jax_uniforms(key, batch, counts):
    """The uniforms of the JAX batch program at every random site, stacked
    over the batch: the key folds on the cluster index (ensemble.py:367)
    and splits into dm, gas, star (:350); a collisionless key into 4
    (:279), its speed key into 2 (virial.py:483), a gas key into 2
    (:313), a direction key into 2 (:240)."""
    f32 = jnp.float32

    def iso(k, n):
        k1, k2 = jax.random.split(k)
        return (jax.random.uniform(k1, (n,), f32, -1.0, 1.0),
                jax.random.uniform(k2, (n,), f32))

    def coll(k, n):
        k_r, k_v, k_u, k_w = jax.random.split(k, 4)
        kv, kb = jax.random.split(k_v)
        return (jax.random.uniform(k_r, (n,), f32),
                jax.random.uniform(kv, (n,), f32),
                jax.random.uniform(kb, (n,), f32), iso(k_u, n), iso(k_w, n))

    def gas(k, n):
        k_r, k_u = jax.random.split(k)
        return (jax.random.uniform(k_r, (n,), f32), iso(k_u, n))

    per_cluster = []
    for i in range(batch):
        k_dm, k_gas, k_star = jax.random.split(jax.random.fold_in(key, i), 3)
        per_cluster.append({"dm": coll(k_dm, counts["dm"]),
                            "star": coll(k_star, counts["star"]),
                            "gas": gas(k_gas, counts["gas"])})

    def stack(trees):
        if isinstance(trees[0], tuple):
            return tuple(stack([t[j] for t in trees])
                         for j in range(len(trees[0])))
        return torch.tensor(np.stack([np.asarray(t) for t in trees]))

    return {sp: stack([c[sp] for c in per_cluster])
            for sp in ("dm", "star", "gas")}


@pytest.fixture(scope="module", params=[None, R_A], ids=["isotropic", "om"])
def both(request):
    r_a = request.param
    M200, conc = _params()
    key = jax.random.key(21)
    j_fn = JE._datagen_full_batch_fn(NUM_POINTS, COUNTS["dm"], COUNTS["gas"],
                                     COUNTS["star"], r_a=r_a)
    j_out = jax.tree_util.tree_map(
        np.asarray, j_fn(jnp.asarray(M200), jnp.asarray(conc), key))
    t_fn = TE._datagen_full_batch_fn(NUM_POINTS, COUNTS["dm"], COUNTS["gas"],
                                     COUNTS["star"], r_a=r_a)
    t_out = t_fn(torch.from_numpy(M200), torch.from_numpy(conc),
                 uniforms=_jax_uniforms(key, len(M200), COUNTS))
    return j_out, t_out


def test_core_matches_jax_with_jax_uniforms(both):
    j_out, t_out = both
    assert TE.nonfinite_counts(t_out) == {
        f"{sp}/{name}": 0 for sp, names in
        (("dm", ("pos", "vel", "pmass")), ("star", ("pos", "vel", "pmass")),
         ("gas", ("pos", "energy", "pmass"))) for name in names}
    t_out = to_numpy(t_out)
    assert set(t_out) == set(j_out) == {"dm", "star", "gas"}
    for sp in ("dm", "star", "gas"):
        for a, b in zip(j_out[sp], t_out[sp]):
            assert b.shape == a.shape and b.dtype == np.float32, sp
        np.testing.assert_allclose(t_out[sp][2], j_out[sp][2], rtol=1e-6)
        for which in (0, 1):
            a = j_out[sp][which].astype(np.float64)
            b = t_out[sp][which].astype(np.float64)
            if a.ndim == 3:  # a vector per particle, relative to its size
                rel = (np.linalg.norm(a - b, axis=-1)
                       / np.linalg.norm(a, axis=-1))
            else:
                rel = np.abs(a - b) / np.abs(a)
            assert (rel > 1e-5).mean() < 0.01, (sp, which, rel.max())
            assert (rel > 1e-4).mean() < 1e-3, (sp, which, rel.max())


def test_jax_batch_output_carries_across(both):
    """convert.py: the JAX batch output as the port's tensors, layout kept."""
    j_out, t_out = both
    carried = datagen_batch_from_numpy(j_out, device="cpu")
    assert set(carried) == set(t_out)
    for sp in carried:
        assert isinstance(carried[sp], tuple) and len(carried[sp]) == 3
        for a, b in zip(carried[sp], t_out[sp]):
            assert a.shape == b.shape and a.dtype == b.dtype
    assert sum(TE.nonfinite_counts(carried).values()) == 0


# ------------------------------------------------ the port's own generator
N_OWN = {"dm": 40_000, "gas": 20_000, "star": 10_000}


@pytest.fixture(scope="module")
def own():
    M200, conc = _params(n=2, seed=8)
    (b0, out), = TE.datagen_batches(M200, conc, N_OWN, batch_size=2,
                                    num_points=NUM_POINTS, seed=5,
                                    device="cpu")
    assert b0 == 0
    fields = TE.build_ensemble(M200, conc, num_points=NUM_POINTS,
                               with_df=False, device="cpu")
    return to_numpy(out), to_numpy(fields)


def test_own_draws_follow_the_mass_profile(own):
    out, f = own
    tol = QA_TOLERANCES["cluster"]
    for sp, key in (("dm", "dark_matter_mass"), ("star", "stellar_mass"),
                    ("gas", "gas_mass")):
        for i in range(2):
            rr, mm = f["radius"][i], f[key][i]
            r = np.linalg.norm(out[sp][0][i].astype(np.float64), axis=1)
            assert r.max() <= rr[-1] * (1.0 + tol["radius_tol"])
            _, pval = kstest(r, lambda x: np.interp(x, rr, mm / mm[-1]))
            assert pval > 1e-4, (sp, i, pval)
            n = out[sp][0].shape[1]
            assert abs(n * float(out[sp][2][i]) / mm[-1] - 1.0) \
                <= tol["mass_rtol"]


def test_own_speeds_stay_under_the_local_escape_speed(own):
    out, f = own
    for sp in ("dm", "star"):
        for i in range(2):
            r = np.linalg.norm(out[sp][0][i].astype(np.float64), axis=1)
            v = np.linalg.norm(out[sp][1][i].astype(np.float64), axis=1)
            psi = np.interp(r, f["radius"][i],
                            -f["gravitational_potential"][i])
            assert (v <= np.sqrt(2.0 * psi)
                    * (1.0 + QA_TOLERANCES["speed_tol"])).all()
            assert v.min() >= 0.0 and np.median(v) > 0.0


def test_own_gas_energy_is_evaluated_at_the_drawn_radius(own):
    out, f = own
    for i in range(2):
        r = np.linalg.norm(out["gas"][0][i].astype(np.float64), axis=1)
        e_ref = np.interp(r, f["radius"][i],
                          1.5 * f["pressure"][i] / f["density"][i])
        rel = np.abs(out["gas"][1][i] - e_ref) / e_ref
        assert rel.max() <= QA_TOLERANCES["cluster"]["energy_rtol"]


def test_om_beta_profile_of_own_draws():
    """beta(r) = 1 - <v_t^2> / (2 <v_r^2>) of the drawn DM tracks
    r^2 / (r^2 + r_a^2), at the JAX test's tolerance
    (tests/test_anisotropy.py)."""
    (_, (pos, vel, _)), = TE.datagen_batches(
        [1.5e15], [4.0], 120_000, batch_size=1, num_points=NUM_POINTS,
        seed=9, anisotropy_radius=R_A, device="cpu")
    pos = pos[0].numpy().astype(np.float64)
    vel = vel[0].numpy().astype(np.float64)
    r = np.linalg.norm(pos, axis=1)
    v_r = (vel * pos).sum(axis=1) / r
    v_t2 = (vel ** 2).sum(axis=1) - v_r ** 2
    edges = np.geomspace(100.0, 6000.0, 7)
    for lo, hi in zip(edges[:-1], edges[1:]):
        m = (r >= lo) & (r < hi)
        assert m.sum() > 2000, (lo, hi)
        beta_hat = 1.0 - v_t2[m].mean() / (2.0 * (v_r[m] ** 2).mean())
        rmid = np.sqrt(lo * hi)
        beta_om = rmid ** 2 / (rmid ** 2 + R_A ** 2)
        assert abs(beta_hat - beta_om) < 0.05 + 0.1 * beta_om, \
            (lo, hi, beta_hat, beta_om)


def test_batches_are_reproducible_and_independent():
    """Batch b0 draws the same particles whether or not batch 0 ran first,
    and the int count gives the bare DM tuple."""
    M200, conc = _params(n=4, seed=3)
    kw = dict(batch_size=2, num_points=NUM_POINTS, seed=13, device="cpu")
    batches = list(TE.datagen_batches(M200, conc, 1500, **kw))
    assert [b0 for b0, _ in batches] == [0, 2]
    assert isinstance(batches[1][1], tuple)
    # the second batch alone: its clusters, its own generator
    _, _, fn = TE._resolve_batch_fn(1500, NUM_POINTS)
    alone = fn(torch.from_numpy(M200[2:]), torch.from_numpy(conc[2:]),
               TE._batch_generator(13, 2, torch.device("cpu")))
    for a, b in zip(batches[1][1], alone):
        assert torch.equal(a, b)
    again = list(TE.datagen_batches(M200, conc, 1500, **kw))
    assert torch.equal(again[0][1][1], batches[0][1][1])
    # another seed, other draws; batch 0 and batch 2 differ
    other = next(TE.datagen_batches(M200, conc, 1500,
                                    **dict(kw, seed=14)))
    assert not torch.equal(other[1][0], batches[0][1][0])


@pytest.mark.parametrize("r_a", [0.0, -300.0])
def test_resolve_rejects_non_positive_r_a(r_a):
    with pytest.raises(ValueError, match="positive"):
        TE._resolve_batch_fn({"dm": 100}, NUM_POINTS, r_a=r_a)


def test_resolve_rejects_unknown_species_and_laws():
    with pytest.raises(ValueError, match="unknown species"):
        TE._resolve_batch_fn({"dm": 100, "stars": 10}, NUM_POINTS)
    with pytest.raises(KeyError, match="Unknown gravity law"):
        TE._resolve_batch_fn(100, NUM_POINTS, gravity="no_such_law")
    full, counts, _ = TE._resolve_batch_fn({"dm": 100, "gas": 5}, NUM_POINTS)
    assert full and counts == {"dm": 100, "gas": 5, "star": 0}


def test_datagen_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(TE.datagen_batches([1e15], [4.0], 100))
