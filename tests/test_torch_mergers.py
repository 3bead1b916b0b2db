"""The port's merger-scene batch program against the JAX package's, on the
CPU.

* the scene samplers given the JAX package's own uniforms and normals:
  equal up to the roundoff of ``10**`` and ``exp`` (rtol 1e-14);
* the geometry and count helpers: equal, with the same errors;
* a batch of two small scenes: equal bit for bit to the port's
  ``merger_ic_fused`` of each scene given the same uniforms, and equal to
  the JAX batch program (``vmap`` over ``fold_in(key, i)`` keys) given the
  uniforms rebuilt from those keys, at the float32 tolerances of
  tests/test_torch_pipeline.py (speeds 1e-4);
* the QA helper passes a clean batch and catches a planted bad row.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cluster_generator_tpu.parallel import mergers as JM
from cluster_generator_tpu_torch import pipeline as TP
from cluster_generator_tpu_torch.parallel import mergers as TM
from tests.test_torch_pipeline import _jax_uniforms

torch.set_num_threads(1)

CPU = dict(device="cpu")
NG, ND, NS = (1200, 800), (1000, 1000), (300, 200)
POINTS = 256
R_MAX = [5000.0, 5000.0]


def _jax_draws(key, n, n_uniform, n_normal_cols, normal_at):
    """The JAX sampler's [0, 1) uniforms and normals, key by key."""
    ks = jax.random.split(key, n_uniform + 1)
    u = [np.asarray(jax.random.uniform(k, (n,), jnp.float64))
         for i, k in enumerate(ks) if i != normal_at]
    z = np.asarray(jax.random.normal(ks[normal_at], (n, n_normal_cols),
                                     jnp.float64))
    return u, z


def test_binary_scene_sampler_matches_jax():
    key = jax.random.key(5)
    want = JM.sample_merger_scene_params(key, 40)
    u, z = _jax_draws(key, 40, 5, 2, normal_at=2)
    got = TM.sample_merger_scene_params(None, 40, uniforms=u, normals=z,
                                        **CPU)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float64 and got[k].shape == v.shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=1e-14,
                                   err_msg=k)
    own = TM.sample_merger_scene_params(torch.Generator().manual_seed(1), 400,
                                        **CPU)
    assert (own["b"] <= own["d"] * 0.5).all()
    assert (own["M200"][:, 1] <= own["M200"][:, 0]).all()
    assert ((own["conc"] >= 3.0) & (own["conc"] <= 8.0)).all()


def test_triple_scene_sampler_matches_jax():
    key = jax.random.key(6)
    want = JM.sample_triple_scene_params(key, 30)
    u, z = _jax_draws(key, 30, 9, 3, normal_at=3)
    got = TM.sample_triple_scene_params(None, 30, uniforms=u, normals=z,
                                        **CPU)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=1e-14,
                                   atol=1e-12, err_msg=k)
    own = TM.sample_triple_scene_params(torch.Generator().manual_seed(2), 50,
                                        **CPU)
    # the scene is in its zero-momentum frame
    mom = (own["M200"][..., None] * own["velocities"]).sum(dim=1)
    assert float(mom.abs().max()) < 1e-9 * float(
        (own["M200"][..., None] * own["velocities"].abs()).sum(dim=1).max())


def test_geometry_helpers_match_jax():
    rng = np.random.RandomState(3)
    M = 10 ** rng.uniform(14, 15, (7, 3))
    d, v = rng.uniform(2000, 4000, 7), rng.uniform(0.5, 1.5, 7)
    b = d * rng.uniform(0, 0.5, 7)
    for a, e in zip(TM.binary_scene_geometry(torch.tensor(M[:, :2]), d, b, v,
                                             center=(1.0, 2.0, 3.0)),
                    JM.binary_scene_geometry(M[:, :2], d, b, v,
                                             center=(1.0, 2.0, 3.0))):
        np.testing.assert_array_equal(a, np.asarray(e))
    args = (M, d, b, v, d * 1.2, b, v * 0.5)
    for a, e in zip(TM.triple_scene_geometry(*args),
                    JM.triple_scene_geometry(*args)):
        np.testing.assert_array_equal(a, np.asarray(e))
    for mod in (TM, JM):
        with pytest.raises(ValueError, match="exceeds separation d"):
            mod.binary_scene_geometry(M[:, :2], d, d * 1.01, v)
        with pytest.raises(ValueError, match="b3 exceeds"):
            mod.triple_scene_geometry(M, d, b, v, d, d * 1.01, v)


def test_count_helpers_match_jax():
    M = np.array([[1e15, 2e14], [8e14, 4e14], [1.2e15, 1.2e15]])
    np.testing.assert_array_equal(TM.halo_mass_weights(torch.tensor(M)),
                                  JM.halo_mass_weights(M))
    w = JM.halo_mass_weights(M)
    for total in (0, 1, 7, 100_001):
        assert TM._split_by_weights(total, w) == JM._split_by_weights(total, w)
    for counts, weights in (({"gas": 10, "dm": (3, 4)}, None),
                            ({"dm": 1001, "star": 9}, w[:2]),
                            ({"gas": 5}, None)):
        assert (TM._normalize_counts(counts, 2, weights)
                == JM._normalize_counts(counts, 2, weights))
    for counts, msg in (({"dark": 5}, "unknown species"),
                        ({"dm": (1, 2, 3)}, "3 entries for 2 halos"),
                        ({"dm": 0}, "all species counts are zero")):
        for mod in (TM, JM):
            with pytest.raises(ValueError, match=msg):
                mod._normalize_counts(counts, 2)
    for ns in ((3, 0, 5), (0, 0), (4,)):
        assert TM._segment_offsets(ns) == JM._segment_offsets(ns)
    assert TM._MERGER_DRAWS_VERSION == JM._MERGER_DRAWS_VERSION == 2


def _stack(trees):
    if isinstance(trees[0], tuple):
        return tuple(_stack([t[i] for t in trees]) for i in range(len(trees[0])))
    return torch.stack(trees)


@pytest.fixture(scope="module")
def scenes():
    key = jax.random.key(9)
    p = JM.sample_merger_scene_params(jax.random.key(4), 2)
    ctr, vel = JM.binary_scene_geometry(p["M200"], p["d"], p["b"],
                                        p["v_rel"])
    M, c = np.asarray(p["M200"]), np.asarray(p["conc"])
    j_out = JM._merger_batch_fn(POINTS, NG, ND, NS)(
        jnp.asarray(M), jnp.asarray(c), jnp.asarray(ctr), jnp.asarray(vel),
        jnp.asarray(R_MAX), key)
    per_scene = [_jax_uniforms(jax.random.fold_in(key, i), NG, ND, NS)
                 for i in range(2)]
    unif = {k: _stack([u[k] for u in per_scene]) for k in per_scene[0]}
    t_out = TM._merger_batch_fn(POINTS, NG, ND, NS, **CPU)(
        M, c, ctr, vel, R_MAX, uniforms=unif)
    return {"M": M, "c": c, "ctr": ctr, "vel": vel, "per_scene": per_scene,
            "j_out": {k: np.asarray(v) for k, v in j_out.items()},
            "t_out": t_out}


def test_batch_equals_each_scene_of_merger_ic_fused(scenes):
    t_out = scenes["t_out"]
    for b in range(2):
        parts, _ = TP.merger_ic_fused(
            scenes["M"][b], scenes["c"][b], scenes["ctr"][b],
            scenes["vel"][b], R_MAX, NG, ND, NS, num_points=POINTS,
            uniforms=scenes["per_scene"][b], **CPU)
        for sp in ("gas", "dm", "star"):
            for name in ("position", "velocity"):
                assert torch.equal(t_out[f"{sp}_{name}"][b],
                                   parts[sp, f"particle_{name}"]), (sp, name)
            pm = parts[sp, "particle_mass"]
            off = (0, {"gas": NG, "dm": ND, "star": NS}[sp][0])
            assert torch.equal(t_out[f"mass_{sp}"][b], pm[list(off)])
        assert torch.equal(t_out["gas_thermal_energy"][b],
                           parts["gas", "thermal_energy"])
        assert torch.equal(t_out["gas_density"][b], parts["gas", "density"])


def test_batch_matches_jax(scenes):
    j_out, t_out = scenes["j_out"], scenes["t_out"]
    assert set(t_out) == set(j_out)
    vmax = np.abs(scenes["vel"]).max()
    for k, want in j_out.items():
        got = t_out[k].numpy()
        assert got.shape == want.shape and got.dtype == want.dtype, k
        a, b = want.astype(np.float64), got.astype(np.float64)
        if k == "gas_velocity":
            assert np.abs(a - b).max() < 2e-5 * vmax
        elif k.endswith("_velocity"):
            n = ND if k.startswith("dm") else NS
            bulk = np.concatenate([np.repeat(scenes["vel"][:, i, None, :],
                                             n[i], axis=1) for i in range(2)],
                                  axis=1)
            sa = np.linalg.norm(a - bulk, axis=-1)
            sb = np.linalg.norm(b - bulk, axis=-1)
            assert (np.abs(sa - sb) / sa > 1e-4).mean() <= 1e-3, k
        elif a.ndim == 3:
            rel = np.linalg.norm(a - b, axis=-1) / np.linalg.norm(a, axis=-1)
            assert rel.max() < 2e-5, k
        else:
            np.testing.assert_allclose(b, a, rtol=2e-5, err_msg=k)


def test_scene_qa_passes_and_catches_a_bad_row(scenes):
    counts = {"gas": NG, "dm": ND, "star": NS}
    args = (scenes["M"], scenes["c"], scenes["ctr"], scenes["vel"], R_MAX,
            counts)
    rep = TM.verify_scene_batch(scenes["t_out"], *args, num_points=POINTS)
    assert not rep["violations"] and not any(rep["nonfinite"].values())
    assert rep["max_speed_frac"] <= 1.005 and rep["max_momentum_sigmas"] < 5
    bad = {k: v.clone() for k, v in scenes["t_out"].items()}
    bad["dm_position"][1, 5] = torch.tensor([9000.0, 0.0, 0.0])
    bad["gas_thermal_energy"][0, 7] *= 1.5
    bad["star_velocity"][0, 3] = float("nan")
    rep = TM.verify_scene_batch(bad, *args, num_points=POINTS, strict=False)
    text = "\n".join(rep["violations"])
    assert "dm halo 0: radius" in text
    assert "mixed thermal energy" in text
    assert rep["nonfinite"]["star_velocity"] == 3
    with pytest.raises(ValueError, match="failed physics QA"):
        TM.verify_scene_batch(bad, *args, num_points=POINTS)


def test_scene_stream_batches_and_validation():
    p = TM.sample_merger_scene_params(torch.Generator().manual_seed(0), 3,
                                      **CPU)
    counts = {"dm": 400, "gas": 300, "star": 100}
    outs = list(TM.merger_scene_batches(p, counts, batch_size=2,
                                        num_points=128, seed=4, **CPU))
    assert [b0 for b0, _ in outs] == [0, 2]
    assert outs[0][1]["dm_position"].shape == (2, 400, 3)
    assert outs[1][1]["gas_density"].shape == (1, 300)
    again = list(TM.merger_scene_batches(p, counts, batch_size=2,
                                         num_points=128, seed=4, **CPU))
    assert torch.equal(outs[1][1]["dm_velocity"], again[1][1]["dm_velocity"])
    with pytest.raises(ValueError, match="must be positive"):
        TM._merger_batch_fn(128, (1, 1), (1, 1), (1, 1), r_a=0.0, **CPU)
    with pytest.raises(ValueError, match="binary-only"):
        next(TM.merger_scene_batches(
            {"M200": np.ones((2, 3)) * 1e15, "conc": np.ones((2, 3)) * 4},
            counts, **CPU))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            next(TM.merger_scene_batches(p, counts))
