"""The merger-scene catalogs of the PyTorch port against the JAX package's,
on the CPU at a small size (a 128-point grid, tens to thousands of
particles per scene).

* A port catalog holds what ``merger_scene_batches`` yields for the same
  (seed, batch_size), bit for bit; resume (with the parameter sha), shards,
  input checks, halo segments, the QA gate and ``scene_to_particles`` keep
  the semantics of tests/test_mergers.py, case for case.
* Files cross both ways: each package's ``read_merger_catalog`` and
  ``verify_merger_catalog`` (also through ``verify_catalog``) read the
  other's catalog; zeroed extents fail both verifiers; a resume across the
  packages is refused on the draws' version.
"""

import os

import h5py
import jax
import numpy as np
import pytest
import torch

from cluster_generator_tpu.parallel import ensemble as JE
from cluster_generator_tpu.parallel import mergers as JM
from cluster_generator_tpu_torch.parallel import ensemble as TE
from cluster_generator_tpu_torch.parallel import mergers as TM

torch.set_num_threads(1)

COUNTS = {"gas": 48, "dm": 64, "star": 16}
KW = dict(counts=COUNTS, batch_size=2, num_points=128, r_max=3000.0,
          seed=5, prorate=False, device="cpu")
QA_COUNTS = {"gas": 1200, "dm": 1600, "star": 300}


def _params(n, seed):
    """Binary scene parameters as float64 numpy, from a numpy seed."""
    rng = np.random.RandomState(seed)
    M1 = 10.0 ** rng.uniform(14.2, 15.3, n)
    M200 = np.stack([M1, rng.uniform(0.2, 1.0, n) * M1], axis=1)
    conc = np.clip(5.0 * (M200 / 1e15) ** -0.1
                   * np.exp(0.3 * rng.randn(n, 2)), 3.0, 8.0)
    d = rng.uniform(2000.0, 4000.0, n)
    return {"M200": M200, "conc": conc, "d": d,
            "b": d * rng.uniform(0.0, 0.5, n),
            "v_rel": rng.uniform(0.5, 1.5, n)}


def _copy(src, dst):
    with open(src, "rb") as a, open(dst, "wb") as b:
        b.write(a.read())
    return str(dst)


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for i in want:
        assert set(got[i]) == set(want[i]), i
        for k in want[i]:
            np.testing.assert_array_equal(got[i][k], want[i][k],
                                          err_msg=f"scene {i} {k}")


@pytest.fixture(scope="module")
def port_catalog(tmp_path_factory):
    fn = str(tmp_path_factory.mktemp("port_mergers") / "mergers.h5")
    TM.merger_datagen(_params(4, 0), fn, **KW)
    return fn


@pytest.fixture(scope="module")
def qa_catalogs(tmp_path_factory):
    """Larger scenes for the QA gates, one catalog from each package (the
    JAX package compiles its scene program once)."""
    d = tmp_path_factory.mktemp("qa_mergers")
    p = _params(3, 5)
    out = {"port": str(d / "port.h5"), "jax": str(d / "jax.h5")}
    TM.merger_datagen(p, out["port"], QA_COUNTS, batch_size=2,
                      num_points=128, seed=4, device="cpu")
    JM.merger_datagen(p, out["jax"], QA_COUNTS, batch_size=2, num_points=128,
                      key=jax.random.key(4))
    return out


def test_merger_datagen_end_to_end(port_catalog):
    """Every scene carries the multi-species product with per-halo segments,
    physical gas, bounded geometry; fields= subsets; overwrite refused."""
    p = _params(4, 0)
    with h5py.File(port_catalog, "r") as f:
        assert bool(f.attrs["complete"])
        assert f.attrs["product"] == "merger_scenes"
        assert int(f.attrs["n_clusters"]) == 4 and int(f.attrs["n_halos"]) == 2
        assert f.attrs["draws_version"] == 2002
        np.testing.assert_array_equal(f.attrs["n_gas_per_halo"], [24, 24])
        np.testing.assert_array_equal(f.attrs["n_dm_per_halo"], [32, 32])
        np.testing.assert_array_equal(f.attrs["n_star_per_halo"], [8, 8])
    scenes = dict(TM.read_merger_catalog(port_catalog))
    assert sorted(scenes) == list(range(4))
    ctr_all, vel_all = TM.binary_scene_geometry(p["M200"], p["d"], p["b"],
                                                p["v_rel"])
    for i, sc in scenes.items():
        assert sc["gas_position"].shape == sc["gas_velocity"].shape == (48, 3)
        assert sc["gas_thermal_energy"].shape == sc["gas_density"].shape == (
            48,)
        assert sc["dm_position"].shape == (64, 3)
        assert sc["star_velocity"].shape == (16, 3)
        np.testing.assert_array_equal(sc["M200"], p["M200"][i])
        np.testing.assert_array_equal(sc["center"], ctr_all[i])
        np.testing.assert_array_equal(sc["bulk_velocity"], vel_all[i])
        assert np.all(sc["gas_thermal_energy"] > 0)
        assert np.all(sc["gas_density"] > 0)
        for sp in ("gas", "dm", "star"):
            pm = sc[f"particle_mass_{sp}"]
            assert pm.shape == (2,) and pm.dtype == np.float32
            assert np.all(pm > 0)
        pos = sc["dm_position"]
        for h, seg in ((0, slice(0, 32)), (1, slice(32, 64))):
            r = np.linalg.norm(pos[seg] - sc["center"][h], axis=1)
            assert np.all(r <= 3000.0 * (1 + 1e-5))
            com = pos[seg].mean(axis=0)
            assert (np.linalg.norm(com - sc["center"][h])
                    < np.linalg.norm(com - sc["center"][1 - h]))
        vmean = sc["dm_velocity"][:32].mean(axis=0)
        assert abs(vmean[0] - sc["bulk_velocity"][0, 0]) < 0.5
    (_, sub), = TM.read_merger_catalog(port_catalog, indices=[2],
                                       fields=["dm_position"])
    assert "dm_position" in sub and "gas_position" not in sub
    assert "M200" in sub
    with pytest.raises(KeyError, match="nope"):
        next(TM.read_merger_catalog(port_catalog, indices=[0],
                                    fields=["nope"]))
    with pytest.raises(IOError, match="resume=True"):
        TM.merger_datagen(p, port_catalog, **KW)


def test_catalog_holds_what_merger_scene_batches_yields(port_catalog):
    scenes = dict(TM.read_merger_catalog(port_catalog))
    kw = {k: v for k, v in KW.items() if k != "counts"}
    seen = 0
    for b0, out in TM.merger_scene_batches(_params(4, 0), COUNTS, **kw):
        for j in range(out["dm_position"].shape[0]):
            sc = scenes[b0 + j]
            for name, t in out.items():
                key = ("particle_" + name if name.startswith("mass_")
                       else name)
                np.testing.assert_array_equal(sc[key], t[j].numpy(),
                                              err_msg=f"{b0 + j} {name}")
            seen += 1
    assert seen == 4


def test_merger_datagen_resume_is_bit_identical(tmp_path, port_catalog):
    """The shared loop's resume for the merger product, plus its guard: a
    different scene ensemble (params_sha) refuses to splice."""
    p = _params(4, 0)
    ref = dict(TM.read_merger_catalog(port_catalog))
    cut = _copy(port_catalog, tmp_path / "cut.h5")
    with h5py.File(cut, "a") as f:
        del f.attrs["complete"]
        del f["scene_000003"]
        del f["scene_000002"]["dm_velocity"]  # a partly written batch
        f.attrs["_batches_done"] = np.asarray([0], np.int64)
    TM.merger_datagen(p, cut, resume=True, **KW)
    _assert_same(dict(TM.read_merger_catalog(cut)), ref)
    TM.merger_datagen(p, cut, resume=True, **KW)  # complete: no-op
    with h5py.File(cut, "a") as f:
        del f.attrs["complete"]
    with pytest.raises(ValueError, match="params_sha"):
        TM.merger_datagen(_params(4, 1), cut, resume=True, **KW)
    with pytest.raises(ValueError, match="mutually"):
        TM.merger_datagen(p, cut, resume=True, overwrite=True, **KW)


def test_merger_multihost_shards_reassemble(tmp_path, port_catalog):
    p = _params(4, 0)
    shards = [TM.merger_datagen_multihost(p, str(tmp_path / "sh.h5"), rank=r,
                                          nproc=2, **KW) for r in range(2)]
    assert shards[0].endswith("sh.0of2.h5")
    _assert_same(dict(TM.read_merger_catalog(shards)),
                 dict(TM.read_merger_catalog(port_catalog)))
    with pytest.raises(ValueError, match="rank"):
        TM.merger_datagen_multihost(p, str(tmp_path / "x.h5"), rank=2,
                                    nproc=2, **KW)


def test_merger_datagen_input_validation(tmp_path):
    p = _params(3, 0)
    fn = str(tmp_path / "v.h5")
    kw = dict(device="cpu")
    with pytest.raises(ValueError, match="unknown species"):
        TM.merger_datagen(p, fn, counts={"darkmatter": 10}, **kw)
    with pytest.raises(ValueError, match="has 3 entries for 2 halos"):
        TM.merger_datagen(p, fn, counts={"dm": (10, 10, 10)}, **kw)
    with pytest.raises(ValueError, match="all species counts are zero"):
        TM.merger_datagen(p, fn, counts={"dm": 0}, **kw)
    with pytest.raises(ValueError, match="n_scenes, n_halos"):
        TM.merger_datagen(dict(p, M200=p["M200"][:, 0]), fn, COUNTS, **kw)
    three = {"M200": np.full((2, 3), 1e14), "conc": np.full((2, 3), 5.0),
             "d": np.full(2, 3000.0), "b": np.zeros(2), "v_rel": np.ones(2)}
    with pytest.raises(ValueError, match="binary-only"):
        TM.merger_datagen(three, fn, COUNTS, **kw)
    with pytest.raises(ValueError, match="anisotropy_radius"):
        TM.merger_datagen(p, fn, COUNTS, anisotropy_radius=0.0, **kw)
    assert not os.path.exists(fn)


def test_merger_uneven_and_zero_count_halos(tmp_path):
    """Odd totals put the remainder on the first halos; a zero-count
    species-halo contributes nothing and its mass attr is 0."""
    fn = str(tmp_path / "odd.h5")
    TM.merger_datagen(_params(2, 7), fn, counts={"dm": 31, "gas": (20, 0)},
                      batch_size=2, num_points=128, seed=1, prorate=False,
                      device="cpu")
    with h5py.File(fn, "r") as f:
        np.testing.assert_array_equal(f.attrs["n_dm_per_halo"], [16, 15])
        np.testing.assert_array_equal(f.attrs["n_gas_per_halo"], [20, 0])
        np.testing.assert_array_equal(f.attrs["n_star_per_halo"], [0, 0])
    (_, sc), = TM.read_merger_catalog(fn, indices=[1])
    assert sc["dm_position"].shape == (31, 3)
    assert sc["gas_position"].shape == (20, 3)
    assert "star_position" not in sc
    assert sc["particle_mass_gas"][0] > 0 and sc["particle_mass_gas"][1] == 0


def test_verify_merger_catalog(tmp_path, qa_catalogs, port_catalog):
    """Clean catalogs pass, through verify_catalog's dispatch too;
    corrupted energies, an unbound particle and zero-filled velocities fire
    named violations; a cluster catalog is not a merger catalog."""
    fn = _copy(qa_catalogs["port"], tmp_path / "qa.h5")
    report = TM.verify_merger_catalog(fn, device="cpu", batch_size=2)
    assert report["violations"] == []
    assert report["n_scenes_checked"] == 3
    assert report["max_speed_frac"] <= 1.0 + 5e-3
    assert report["max_energy_rel_err"] <= 1e-3
    assert report["max_mass_rel_err"] <= 1e-4
    assert TE.verify_catalog(fn, device="cpu")["n_scenes_checked"] == 3
    with h5py.File(fn, "a") as f:
        d = f["scene_000001/gas_thermal_energy"]
        d[...] = np.asarray(d[()]) * 2.0
    bad = TM.verify_merger_catalog(fn, strict=False, device="cpu")
    assert any("mixed thermal energy" in v for v in bad["violations"])
    with h5py.File(fn, "a") as f:
        d = f["scene_000002/dm_velocity"]
        v = np.asarray(d[()])
        v[0] = [50.0, 0.0, 0.0]
        d[...] = v
    bad = TM.verify_merger_catalog(fn, indices=[2], strict=False,
                                   device="cpu")
    assert any("peculiar speed" in v for v in bad["violations"])
    with h5py.File(fn, "a") as f:
        f["scene_000000/star_velocity"][...] = 0.0
    bad = TM.verify_merger_catalog(fn, indices=[0], strict=False,
                                   device="cpu")
    assert any("all-zero stored velocities" in v for v in bad["violations"])
    with pytest.raises(ValueError, match="physics QA"):
        TM.verify_merger_catalog(fn, device="cpu")
    cl = str(tmp_path / "plain.h5")
    TE.ensemble_datagen([1e15, 5e14], [5.0, 6.0], cl, 200, batch_size=2,
                        num_points=128, device="cpu")
    with pytest.raises(ValueError, match="not a merger-scene"):
        TM.verify_merger_catalog(cl, device="cpu")


def test_scene_to_particles_bridge(tmp_path, port_catalog):
    """Per-halo masses expanded over the segments, the mixed gas fields
    kept; catalog_to_particles dispatches; the result exports to Gadget."""
    parts = TM.scene_to_particles(port_catalog, 1, device="cpu")
    assert parts.num_particles == {"gas": 48, "dm": 64, "star": 16}
    (_, sc), = TM.read_merger_catalog(port_catalog, indices=[1])
    pm = parts["dm", "particle_mass"].numpy()
    np.testing.assert_allclose(pm[:32], sc["particle_mass_dm"][0])
    np.testing.assert_allclose(pm[32:], sc["particle_mass_dm"][1])
    assert float(parts["gas", "thermal_energy"].min()) > 0
    assert ("gas", "density") in parts.fields
    assert float(parts["gas", "particle_velocity"].abs().max()) > 0
    again = TE.catalog_to_particles(port_catalog, 1, device="cpu")
    np.testing.assert_array_equal(again["dm", "particle_position"].numpy(),
                                  parts["dm", "particle_position"].numpy())
    box = 20000.0
    parts.add_offsets([box / 2.0] * 3, [0.0] * 3)
    gf = str(tmp_path / "scene_gadget.h5")
    parts.write_to_gadget_file(gf, box)
    back = type(parts).from_gadget_file(gf, device="cpu")
    assert back.num_particles["gas"] == 48


def test_halo_mass_weights_and_proration(tmp_path):
    """Int counts split by the ensemble-mean mass fraction."""
    p = dict(_params(2, 9), M200=np.stack([np.full(2, 2.0e15),
                                           np.full(2, 5.0e14)], axis=1))
    fn = str(tmp_path / "prorated.h5")
    TM.merger_datagen(p, fn, counts={"dm": 1000, "gas": 500}, batch_size=2,
                      num_points=128, seed=2, device="cpu")
    with h5py.File(fn, "r") as f:
        np.testing.assert_array_equal(f.attrs["n_dm_per_halo"], [800, 200])
        np.testing.assert_array_equal(f.attrs["n_gas_per_halo"], [400, 100])
    (_, sc), = TM.read_merger_catalog(fn, indices=[0])
    pm = sc["particle_mass_dm"]
    assert 0.5 < pm[1] / pm[0] < 2.0


def test_triple_scene_datagen_passes_both_gates(tmp_path):
    """H = 3 with explicit centres: the gas mix sums over three halos; both
    packages' verifiers pass the port's catalog."""
    p = TM.sample_triple_scene_params(None, 2, device="cpu")
    fn = str(tmp_path / "triple.h5")
    TM.merger_datagen(p, fn, counts={"dm": 3000, "gas": 2400, "star": 600},
                      batch_size=2, num_points=128, seed=3, device="cpu")
    with h5py.File(fn, "r") as f:
        assert int(f.attrs["n_halos"]) == 3
    rep = TM.verify_merger_catalog(fn, device="cpu")
    assert rep["violations"] == [] and rep["n_scenes_checked"] == 2
    assert JM.verify_merger_catalog(fn)["violations"] == []


def test_merger_om_anisotropy(tmp_path):
    """r_a recorded; the beta shell check passes on OM draws and fires on
    isotropic draws relabelled as OM."""
    r_a = 500.0
    p = _params(2, 13)
    kw = dict(counts={"dm": 40_000}, batch_size=2, num_points=128,
              r_max=3000.0, seed=6, prorate=False, device="cpu")
    fn = str(tmp_path / "om.h5")
    TM.merger_datagen(p, fn, anisotropy_radius=r_a, **kw)
    with h5py.File(fn, "r") as f:
        assert float(f.attrs["r_a"]) == r_a
        assert f.attrs["draws_version"] == 2002
    assert TM.verify_merger_catalog(fn, device="cpu")["violations"] == []
    iso = str(tmp_path / "iso.h5")
    TM.merger_datagen(p, iso, **kw)
    with h5py.File(iso, "a") as f:
        f.attrs["r_a"] = r_a
    bad = TM.verify_merger_catalog(iso, strict=False, device="cpu")
    assert any("anisotropy beta" in v for v in bad["violations"])


# ---------------------------------------------- files across the packages
def test_jax_package_reads_and_verifies_a_port_catalog(qa_catalogs):
    fn = qa_catalogs["port"]
    _assert_same(dict(JM.read_merger_catalog(fn)),
                 dict(TM.read_merger_catalog(fn)))
    want = JM.verify_merger_catalog(fn, strict=True)
    assert want["violations"] == [] and want["n_scenes_checked"] == 3
    assert JE.verify_catalog(fn, strict=True)["n_scenes_checked"] == 3
    got = TM.verify_merger_catalog(fn, device="cpu")
    for k in ("n_particles_checked", "max_radius_frac", "max_speed_frac"):
        assert got[k] == pytest.approx(want[k], rel=1e-9), k
    for k in ("max_energy_rel_err", "max_density_rel_err",
              "max_velocity_err"):
        assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-9), k


def test_port_reads_and_verifies_a_jax_catalog(qa_catalogs):
    fn = qa_catalogs["jax"]
    _assert_same(dict(TM.read_merger_catalog(fn)),
                 dict(JM.read_merger_catalog(fn)))
    got = TM.verify_merger_catalog(fn, device="cpu")
    assert got["violations"] == [] and got["n_scenes_checked"] == 3
    assert TE.verify_catalog(fn, device="cpu")["n_scenes_checked"] == 3
    want = JM.verify_merger_catalog(fn)
    for k in ("n_particles_checked", "max_radius_frac", "max_speed_frac"):
        assert got[k] == pytest.approx(want[k], rel=1e-9), k
    parts = TE.catalog_to_particles(fn, 2, device="cpu")
    (_, sc), = JM.read_merger_catalog(fn, indices=[2])
    np.testing.assert_array_equal(parts["gas", "density"].numpy(),
                                  sc["gas_density"])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_zeroed_extents_fail_both_verifiers(tmp_path, qa_catalogs, writer):
    fn = _copy(qa_catalogs[writer], tmp_path / "zeroed.h5")
    with h5py.File(fn, "a") as f:  # the batch at offset 0: scenes 0 and 1
        for name in ("scene_000000", "scene_000001"):
            for k in f[name]:
                f[name][k][...] = 0.0
    for verify in (JM.verify_merger_catalog,
                   lambda fn, **kw: TM.verify_merger_catalog(fn, device="cpu",
                                                             **kw)):
        with pytest.raises(ValueError, match="physics QA"):
            verify(fn)
        bad = verify(fn, strict=False)["violations"]
        for i in (0, 1):
            assert any(f"scene {i}" in v and "zero" in v for v in bad)
        assert not any("scene 2" in v for v in bad)


def test_resume_across_the_packages_is_refused(tmp_path, qa_catalogs):
    p = _params(3, 5)
    for writer, resume in (
            ("port", lambda fn: JM.merger_datagen(
                p, fn, QA_COUNTS, batch_size=2, num_points=128,
                key=jax.random.key(4), resume=True)),
            ("jax", lambda fn: TM.merger_datagen(
                p, fn, QA_COUNTS, batch_size=2, num_points=128, seed=4,
                resume=True, device="cpu"))):
        fn = _copy(qa_catalogs[writer], tmp_path / f"{writer}.h5")
        with h5py.File(fn, "a") as f:
            del f.attrs["complete"]
        with pytest.raises(ValueError, match="resume config mismatch on "
                                             "'draws_version'"):
            resume(fn)
