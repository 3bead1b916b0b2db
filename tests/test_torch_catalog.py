"""The ensemble datagen catalogs of the PyTorch port against the JAX
package's, on the CPU at a small size (a 128-point grid, a few hundred
particles per cluster).

* The port's catalog holds exactly what its ``datagen_batches`` yields for
  the same (seed, batch_size, num_points), bit for bit; resume, shards,
  readers, the QA gate and the particle bridge keep the JAX package's
  semantics, case for case with tests/test_parallel.py.
* Files cross both ways: the JAX package's ``read_catalog``,
  ``catalog_batches`` and ``verify_catalog(strict=True)`` read a port
  catalog with every array bit for bit, and the port's readers and
  verifier read a JAX catalog the same way; zeroed extents fail both
  verifiers; a resume across the packages is refused (the draws can never
  match), in both directions.
"""

import os
import subprocess
import sys

import h5py
import jax
import numpy as np
import pytest
import torch
from scipy.stats import ks_2samp, kstest

from cluster_generator_tpu.parallel import ensemble as JE
from cluster_generator_tpu_torch import ClusterModel
from cluster_generator_tpu_torch.core.staging import stream_to_host
from cluster_generator_tpu_torch.parallel import ensemble as TE

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COUNTS = {"dm": 300, "gas": 200, "star": 80}
KW = dict(batch_size=2, num_points=128, seed=11, device="cpu")


def _params(n, seed):
    rng = np.random.RandomState(seed)
    M200 = 10.0 ** rng.uniform(14.0, 15.3, n)
    conc = np.clip(5.0 * (M200 / 1e15) ** -0.1
                   * np.exp(0.3 * rng.randn(n)), 3.0, 8.0)
    return M200, conc


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for i in want:
        assert set(got[i]) == set(want[i]), i
        for k in want[i]:
            np.testing.assert_array_equal(got[i][k], want[i][k],
                                          err_msg=f"cluster {i} {k}")


@pytest.fixture(scope="module")
def jax_catalogs(tmp_path_factory):
    """Catalogs written by the JAX package, both products (JAX compiles its
    batch programs once per file)."""
    d = tmp_path_factory.mktemp("jax_catalogs")
    M, c = _params(5, 0)
    out = {}
    for name, n in (("full", COUNTS), ("dm", 400)):
        fn = str(d / f"{name}.h5")
        JE.ensemble_datagen(M, c, fn, n, batch_size=2, num_points=128,
                            key=jax.random.key(3))
        out[name] = fn
    return out


@pytest.fixture(scope="module")
def port_catalogs(tmp_path_factory):
    d = tmp_path_factory.mktemp("port_catalogs")
    M, c = _params(5, 0)
    out = {}
    for name, n in (("full", COUNTS), ("dm", 400)):
        fn = str(d / f"{name}.h5")
        TE.ensemble_datagen(M, c, fn, n, **KW)
        out[name] = fn
    return out


@pytest.fixture(scope="module")
def ref7(tmp_path_factory):
    """An uninterrupted port catalog of 7 clusters in 4 batches, the
    reference of the resume and shard tests."""
    fn = str(tmp_path_factory.mktemp("ref7") / "cat.h5")
    M, c = _params(7, 4)
    TE.ensemble_datagen(M, c, fn, COUNTS, **KW)
    return fn, M, c


def _copy(src, dst):
    with open(src, "rb") as a, open(dst, "wb") as b:
        b.write(a.read())
    return str(dst)


# ----------------------------------------------------------------- staging
def test_stream_to_host_hands_cpu_tensors_over_in_order():
    ts = [torch.arange(6, dtype=torch.float32).reshape(2, 3),
          torch.arange(4, dtype=torch.int64)]
    got = list(stream_to_host((k, [t * k for t in ts]) for k in range(3)))
    assert [k for k, _ in got] == [0, 1, 2]
    for k, arrays in got:
        assert [a.dtype for a in arrays] == [np.float32, np.int64]
        np.testing.assert_array_equal(arrays[0], ts[0].numpy() * k)
        np.testing.assert_array_equal(arrays[1], ts[1].numpy() * k)
    assert list(stream_to_host([])) == []


class _FakeCard:
    """A stand-in for a CUDA tensor: ``stream_to_host`` takes the ring's
    path for it."""

    device = torch.device("meta")

    def __init__(self, k):
        self.k = k

    def detach(self):
        return self

    def contiguous(self):
        return self


class _FakeRing:
    """Records which batch each of the two pinned buffers holds; a batch
    handed over must still be in its buffer."""

    def __init__(self, device):
        self.slot, self.slots, self.staged = 0, [None, None], []

    def ready(self):
        return None

    def stage(self, tensors, ready=None):
        s, self.slot = self.slot, self.slot ^ 1
        self.slots[s] = tensors[0].k
        self.staged.append(tensors[0].k)
        return s, tensors[0].k

    def finish(self, staged):
        s, k = staged
        assert self.slots[s] == k, f"batch {k} overwritten by {self.slots[s]}"
        return [self.slots[s]]


@pytest.mark.parametrize("n", [1, 2, 3, 4, 7])
def test_stream_to_host_ring_schedule(monkeypatch, n):
    """The card's schedule, with the copies faked: batches come out in
    order, batch k only after batches k+1 and k+2 are enqueued and while
    its buffer still holds it."""
    from cluster_generator_tpu_torch.core import staging

    rings = []
    monkeypatch.setattr(_FakeCard, "device", type("D", (), {"type": "cuda"}))
    monkeypatch.setattr(staging, "_Ring",
                        lambda dev: rings.append(_FakeRing(dev)) or rings[-1])
    enqueued = []

    def programs():
        for k in range(n):
            enqueued.append(k)
            yield k, [_FakeCard(k)]

    got = []
    for k, arrays in staging.stream_to_host(programs()):
        assert arrays == [k] and len(enqueued) >= min(n, k + 3)
        got.append(k)
    assert got == list(range(n)) and rings[0].staged == got


# ------------------------------------------------------------ the writer
def test_ensemble_datagen_streams_to_hdf5(tmp_path, port_catalogs):
    """The DM-only product: a group per cluster, shapes, attrs, physical
    draws, batches spanning the file; overwrite refused."""
    M, c = _params(5, 0)
    fn = port_catalogs["dm"]
    with pytest.raises(IOError, match="resume=True"):
        TE.ensemble_datagen(M, c, fn, 10, **KW)
    with h5py.File(fn) as f:
        assert f.attrs["n_clusters"] == 5
        assert f.attrs["draws_version"] == 2002
        np.testing.assert_array_equal(f.attrs["key_data"], [11])
        names = sorted(k for k in f.keys())
        assert names == [f"cluster_{i:06d}" for i in range(5)]
        for i, name in enumerate(names):
            g = f[name]
            pos, vel = g["particle_position"][()], g["particle_velocity"][()]
            assert pos.shape == vel.shape == (400, 3)
            assert pos.dtype == np.float32
            assert np.isfinite(pos).all() and np.isfinite(vel).all()
            assert np.linalg.norm(pos, axis=1).max() <= 10_000.0 * 1.001
            assert g.attrs["M200"] == M[i] and g.attrs["conc"] == c[i]
            assert g.attrs["particle_mass"] > 0
            assert (np.linalg.norm(vel, axis=1) < 15.0).all()
        assert not np.allclose(f["cluster_000000/particle_position"][()],
                               f["cluster_000004/particle_position"][()])
        assert bool(f.attrs["complete"])


def test_ensemble_datagen_full_species(tmp_path):
    """Each species' radii KS-consistent with its mass CDF, gas energies at
    1.5 P / rho, speeds under the local escape speed, DM and star speeds
    KS-consistent with the class API's draws of the same model."""
    counts = {"dm": 20_000, "gas": 20_000, "star": 10_000}
    fn = str(tmp_path / "full.h5")
    TE.ensemble_datagen([1.2e15], [5.0], fn, counts, batch_size=1,
                        num_points=256, seed=2, device="cpu")
    f = TE.build_ensemble([1.2e15], [5.0], num_points=256, with_df=False,
                          device="cpu")
    fields = {k: v[0].numpy() for k, v in f.items()}
    rr = fields["radius"]
    (_, cl), = TE.read_catalog(fn)
    with h5py.File(fn) as h:
        assert h.attrs["n_dm_per_cluster"] == counts["dm"]
    for sp, mkey in (("dm", "dark_matter_mass"), ("gas", "gas_mass"),
                     ("star", "stellar_mass")):
        pos = cl[f"{sp}_position"]
        assert pos.shape == (counts[sp], 3) and pos.dtype == np.float32
        mm = fields[mkey]
        _, pval = kstest(np.linalg.norm(pos.astype(np.float64), axis=1),
                         lambda x: np.interp(x, rr, mm / mm[-1]))
        assert pval > 1e-3, (sp, pval)
        assert cl[f"particle_mass_{sp}"] == pytest.approx(
            mm[-1] / counts[sp], rel=1e-5)
    r_gas = np.linalg.norm(cl["gas_position"], axis=1)
    e_ref = np.interp(r_gas, rr, 1.5 * fields["pressure"] / fields["density"])
    e = cl["gas_thermal_energy"]
    assert np.median(np.abs(e - e_ref) / e_ref) < 2e-3 and (e > 0).all()
    psi = -fields["gravitational_potential"]
    for sp in ("dm", "star"):
        r = np.linalg.norm(cl[f"{sp}_position"], axis=1)
        v = np.linalg.norm(cl[f"{sp}_velocity"], axis=1)
        assert (v <= np.sqrt(2.0 * np.interp(r, rr, psi)) * (1 + 1e-4)).all()
    m = ClusterModel.from_arrays(fields, device="cpu")
    for sp, gen, seed in (("dm", m.generate_dm_particles, 7),
                          ("star", m.generate_star_particles, 8)):
        p = gen(counts[sp], prng=seed)
        v_cls = p[sp, "particle_velocity"].norm(dim=1).numpy()
        v_cat = np.linalg.norm(cl[f"{sp}_velocity"].astype(np.float64),
                               axis=1)
        _, pval = ks_2samp(v_cat, v_cls)
        assert pval > 1e-3, (sp, pval)


def test_ensemble_datagen_rejects_unknown_species(tmp_path):
    with pytest.raises(ValueError, match="unknown species"):
        TE.ensemble_datagen([1e15], [5.0], str(tmp_path / "x.h5"),
                            {"dm": 100, "stars": 10}, device="cpu")


def test_int_and_dict_catalogs_agree_exactly(tmp_path):
    """The DM-only product IS the full-species core with gas = star = 0:
    the same seed gives bit-identical DM datasets through both."""
    M, c = _params(3, 4)
    a, b = str(tmp_path / "int.h5"), str(tmp_path / "dict.h5")
    TE.ensemble_datagen(M, c, a, 500, **KW)
    TE.ensemble_datagen(M, c, b, {"dm": 500}, **KW)
    for (_, x), (_, y) in zip(TE.read_catalog(a), TE.read_catalog(b)):
        np.testing.assert_array_equal(x["particle_position"], y["dm_position"])
        np.testing.assert_array_equal(x["particle_velocity"], y["dm_velocity"])
        assert x["particle_mass"] == y["particle_mass_dm"]


def test_catalog_holds_what_datagen_batches_yields(port_catalogs):
    """Bit for bit, both products; an incomplete catalog read names
    resume=True."""
    M, c = _params(5, 0)
    for name, n in (("full", COUNTS), ("dm", 400)):
        cat = dict(TE.read_catalog(port_catalogs[name]))
        seen = 0
        for b0, out in TE.datagen_batches(M, c, n, **KW):
            out = out if isinstance(out, dict) else {"dm": out}
            for j in range(out["dm"][0].shape[0]):
                rec = TE._record_dict(next(TE._cluster_records(
                    isinstance(n, dict), b0 + j, M[b0 + j:b0 + j + 1],
                    c[b0 + j:b0 + j + 1],
                    {sp: tuple(a[j:j + 1].numpy() for a in v)
                     for sp, v in out.items()})))
                _assert_same({0: cat[b0 + j]}, {0: rec})
                seen += 1
        assert seen == 5


def test_read_catalog_roundtrip(port_catalogs, tmp_path):
    """Every dataset and attr of each group, identical to an h5py read;
    ``indices`` and ``fields`` subsets; unknown fields and missing groups
    raise."""
    fn = port_catalogs["full"]
    got = dict(TE.read_catalog(fn))
    assert sorted(got) == list(range(5))
    with h5py.File(fn) as f:
        for i in range(5):
            g = f[f"cluster_{i:06d}"]
            assert set(g.keys()) | set(g.attrs) == set(got[i])
            for k in g:
                np.testing.assert_array_equal(got[i][k], g[k][()], err_msg=k)
            for k, v in g.attrs.items():
                assert got[i][k] == v, k
    assert [i for i, _ in TE.read_catalog(fn, indices=[3, 1])] == [3, 1]
    (_, sub), = TE.read_catalog(fn, indices=[2], fields=["dm_position"])
    assert "dm_position" in sub and "dm_velocity" not in sub
    assert "M200" in sub
    with pytest.raises(KeyError, match="not in cluster group"):
        next(TE.read_catalog(fn, fields=["dm_positoin"]))
    cut = str(tmp_path / "cut.h5")
    with h5py.File(fn) as src, h5py.File(cut, "w") as dst:
        for k, v in src.attrs.items():
            dst.attrs[k] = v
        for name in list(src)[:-1]:
            src.copy(name, dst)
    with pytest.raises(KeyError, match="resume=True"):
        dict(TE.read_catalog(cut))


def test_verify_catalog_qa_gate(tmp_path, port_catalogs):
    """Clean catalogs pass (both products; a shard list in the shard
    test); injected corruption is caught and named: speed past escape, a
    wrong thermal energy, a radius off the grid, a broken mass budget."""
    full = _copy(port_catalogs["full"], tmp_path / "full.h5")
    rep = TE.verify_catalog(full, device="cpu", batch_size=3)
    assert rep["violations"] == []
    assert rep["n_clusters_checked"] == 5
    assert rep["n_particles_checked"] == 5 * sum(COUNTS.values())
    assert rep["max_speed_frac"] <= 1.0 + 5e-3
    assert 0 < rep["max_energy_rel_err"] <= 2e-2
    assert rep["max_mass_rel_err"] <= 1e-5
    assert TE.verify_catalog(port_catalogs["dm"],
                             device="cpu")["violations"] == []

    with h5py.File(full, "r+") as f:
        g = f["cluster_000001"]
        v = g["dm_velocity"][()]
        v[7] *= 50.0
        g["dm_velocity"][...] = v
        e = g["gas_thermal_energy"][()]
        e[3] *= 2.0
        g["gas_thermal_energy"][...] = e
        p = g["star_position"][()]
        p[0] = [50000.0, 0.0, 0.0]
        g["star_position"][...] = p
        g.attrs["particle_mass_dm"] = g.attrs["particle_mass_dm"] * 1.1
    with pytest.raises(ValueError, match="physics QA"):
        TE.verify_catalog(full, device="cpu")
    text = "\n".join(TE.verify_catalog(full, strict=False,
                                       device="cpu")["violations"])
    assert "speed" in text and "thermal energy" in text
    assert "radius" in text and "mass budget" in text


def test_multihost_datagen_shards_reassemble_bit_identical(tmp_path, ref7):
    """Three ranks' strided shards equal the one-process catalog bit for
    bit through read_catalog and catalog_batches, and verify as a shard
    list; a shard resumes alone; a rank out of range raises."""
    single, M, c = ref7
    kw = dict(KW, n_particles_per_cluster=COUNTS)
    ref = dict(TE.read_catalog(single))
    stem = str(tmp_path / "cat.h5")
    shards = [TE.ensemble_datagen_multihost(M, c, stem, rank=r, nproc=3, **kw)
              for r in range(3)]
    assert shards == [str(tmp_path / f"cat.{r}of3.h5") for r in range(3)]
    _assert_same(dict(TE.read_catalog(shards)), ref)
    with h5py.File(shards[0]) as f:
        assert sorted(k for k in f if k.startswith("cluster_")) == [
            "cluster_000000", "cluster_000001", "cluster_000006"]
        assert f.attrs["shard_rank"] == 0 and f.attrs["shard_count"] == 3
    for b1, b2 in zip(TE.catalog_batches(single, 3),
                      TE.catalog_batches(shards, 3)):
        for k in b1:
            np.testing.assert_array_equal(b1[k], b2[k], err_msg=k)
    assert TE.verify_catalog(shards, device="cpu")["violations"] == []
    with h5py.File(shards[1], "a") as f:
        del f.attrs["complete"]
        del f["cluster_000002"]
        del f["cluster_000003"]
    TE.ensemble_datagen_multihost(M, c, stem, rank=1, nproc=3, resume=True,
                                  **kw)
    _assert_same(dict(TE.read_catalog(shards)), ref)
    with pytest.raises(ValueError, match="rank"):
        TE.ensemble_datagen_multihost(M, c, str(tmp_path / "x.h5"), rank=3,
                                      nproc=3, **kw)


def test_multihost_rank_defaults_to_torch_distributed(tmp_path):
    """Uninitialized: rank 0 of 1.  Under an initialized process group the
    rank and world size come from ``torch.distributed``."""
    import torch.distributed as dist

    assert TE._rank_and_count(None, None) == (0, 1)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        M, c = _params(3, 5)
        fn = TE.ensemble_datagen_multihost(M, c, str(tmp_path / "d.h5"), 200,
                                           **KW)
    finally:
        dist.destroy_process_group()
    assert fn == str(tmp_path / "d.0of1.h5")
    assert sorted(dict(TE.read_catalog(fn))) == [0, 1, 2]


def test_multihost_datagen_two_real_processes(tmp_path):
    """Two OS processes each write their shard at once; the shard set
    equals the one-process catalog."""
    code = """
import sys
sys.path.insert(0, {root!r})
import numpy as np, torch
torch.set_num_threads(1)
from cluster_generator_tpu_torch.parallel.ensemble import (
    ensemble_datagen_multihost)
rng = np.random.RandomState(31)
M = 10.0 ** rng.uniform(14.0, 15.3, 6)
c = np.full(6, 5.0)
ensemble_datagen_multihost(M, c, {fn!r}, 500, batch_size=2, num_points=128,
                           seed=2, rank=int(sys.argv[1]), nproc=2,
                           device="cpu")
"""
    fn = str(tmp_path / "mh.h5")
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, "-c", code.format(root=ROOT, fn=fn), str(r)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err.decode()[-2000:]
    rng = np.random.RandomState(31)
    M = 10.0 ** rng.uniform(14.0, 15.3, 6)
    single = str(tmp_path / "single.h5")
    TE.ensemble_datagen(M, np.full(6, 5.0), single, 500,
                        **dict(KW, seed=2))
    _assert_same(dict(TE.read_catalog([str(tmp_path / f"mh.{r}of2.h5")
                                       for r in range(2)])),
                 dict(TE.read_catalog(single)))


# ------------------------------------------------------------------ resume
def test_ensemble_datagen_resume_is_bit_identical(tmp_path, ref7):
    """A cut catalog resumed equals the uninterrupted one; a complete one
    returns at once; mismatched configs (seed, batch size, draws version)
    refuse; resume with overwrite is rejected."""
    ref_fn, M, c = ref7
    kw = dict(KW, n_particles_per_cluster=COUNTS)
    ref = dict(TE.read_catalog(ref_fn))
    cut = _copy(ref_fn, tmp_path / "cut.h5")
    with h5py.File(cut, "a") as f:
        del f.attrs["complete"]
        for i in (4, 5, 6):
            del f[f"cluster_{i:06d}"]
        del f["cluster_000003"]["star_velocity"]
    with pytest.raises(IOError, match="resume=True"):
        TE.ensemble_datagen(M, c, cut, **kw)
    TE.ensemble_datagen(M, c, cut, resume=True, **kw)
    _assert_same(dict(TE.read_catalog(cut)), ref)
    TE.ensemble_datagen(M, c, cut, resume=True, **kw)  # complete: no-op
    with h5py.File(cut, "a") as f:
        del f.attrs["complete"]
    with pytest.raises(ValueError, match="key_data"):
        TE.ensemble_datagen(M, c, cut, resume=True, **dict(kw, seed=99))
    with pytest.raises(ValueError, match="batch_size"):
        TE.ensemble_datagen(M, c, cut, resume=True, **dict(kw, batch_size=3))
    with h5py.File(cut, "a") as f:
        f.attrs["draws_version"] = 1001
    with pytest.raises(ValueError, match="draws_version"):
        TE.ensemble_datagen(M, c, cut, resume=True, **kw)
    with h5py.File(cut, "a") as f:
        del f.attrs["draws_version"]
    with pytest.raises(ValueError, match="draws_version"):
        TE.ensemble_datagen(M, c, cut, resume=True, **kw)
    with pytest.raises(ValueError, match="mutually"):
        TE.ensemble_datagen(M, c, cut, resume=True, overwrite=True, **kw)


def test_interrupted_run_resumes_bit_identical(tmp_path, monkeypatch, ref7):
    """A run whose write raises at the batch at offset 2, resumed, equals
    an uninterrupted run: batch 0 kept, batches 2.. recomputed."""
    ref_fn, M, c = ref7
    kw = dict(KW, n_particles_per_cluster=COUNTS)
    fn = str(tmp_path / "crash.h5")
    write = TE._write_records

    def crash(f, records):
        records = list(records)
        if records[0][0] == "cluster_000002":
            raise OSError("disk full")
        write(f, records)

    monkeypatch.setattr(TE, "_write_records", crash)
    with pytest.raises(OSError, match="disk full"):
        TE.ensemble_datagen(M, c, fn, **kw)
    monkeypatch.setattr(TE, "_write_records", write)
    with h5py.File(fn) as f:
        assert list(f.attrs["_batches_done"]) == [0]
        assert "complete" not in f.attrs
    TE.ensemble_datagen(M, c, fn, resume=True, **kw)
    _assert_same(dict(TE.read_catalog(fn)), dict(TE.read_catalog(ref_fn)))


def test_datagen_resume_detects_unwritten_extents(tmp_path, ref7):
    """Datasets present but never written (the raw write window) and the
    marker not recorded: the verifier names the zeros, resume recomputes
    the batch; a file without the marker falls back to presence."""
    ref_fn, M, c = ref7
    kw = dict(KW, n_particles_per_cluster=COUNTS)
    ref = dict(TE.read_catalog(ref_fn))
    fn = _copy(ref_fn, tmp_path / "crash.h5")
    with h5py.File(fn, "a") as f:
        assert sorted(f.attrs["_batches_done"]) == [0, 2, 4, 6]
        del f.attrs["complete"]
        f.attrs["_batches_done"] = np.asarray([0, 4, 6], np.int64)
        for i in (2, 3):
            g = f[f"cluster_{i:06d}"]
            for k in g:
                g[k][...] = 0.0
    with pytest.raises(ValueError, match="zero"):
        TE.verify_catalog(fn, device="cpu")
    TE.ensemble_datagen(M, c, fn, resume=True, **kw)
    _assert_same(dict(TE.read_catalog(fn)), ref)
    assert TE.verify_catalog(fn, device="cpu")["violations"] == []
    with h5py.File(fn, "a") as f:
        del f.attrs["complete"]
        del f.attrs["_batches_done"]
        del f["cluster_000004"]
    TE.ensemble_datagen(M, c, fn, resume=True, **kw)
    np.testing.assert_array_equal(dict(TE.read_catalog(fn))[4]["dm_position"],
                                  ref[4]["dm_position"])


def test_multihost_shard_resume_requires_matching_rank(tmp_path):
    M, c = _params(6, 2)
    kw = dict(KW, n_particles_per_cluster=400)
    shard = TE.ensemble_datagen_multihost(M, c, str(tmp_path / "s.h5"),
                                          rank=1, nproc=3, **kw)
    with h5py.File(shard, "a") as f:
        del f.attrs["complete"]
    with pytest.raises(ValueError, match="shard_rank"):
        TE.ensemble_datagen(M, c, shard, resume=True, **kw)
    TE.ensemble_datagen_multihost(M, c, str(tmp_path / "s.h5"), rank=1,
                                  nproc=3, resume=True, **kw)


# --------------------------------------------------------------- consumers
def test_catalog_batches_training_loop_form(tmp_path):
    """Stacked batches of datasets and attrs; drop or keep the remainder;
    a seeded shuffle by torch.randperm, the same with and without the
    prefetch thread; field subsets; batch_size checked."""
    M, c = _params(7, 9)
    fn = str(tmp_path / "cat.h5")
    TE.ensemble_datagen(M, c, fn, {"dm": 400, "gas": 300, "star": 100},
                        **dict(KW, batch_size=4))
    singles = dict(TE.read_catalog(fn))
    got = list(TE.catalog_batches(fn, 3))
    assert len(got) == 2
    assert got[0]["dm_position"].shape == (3, 400, 3)
    assert got[0]["gas_thermal_energy"].shape == (3, 300)
    assert got[0]["M200"].shape == (3,)
    np.testing.assert_array_equal(got[0]["star_velocity"][1],
                                  singles[1]["star_velocity"])
    np.testing.assert_array_equal(got[1]["particle_mass_gas"],
                                  [singles[i]["particle_mass_gas"]
                                   for i in (3, 4, 5)])
    tails = list(TE.catalog_batches(fn, 3, drop_remainder=False))
    assert [b["M200"].shape[0] for b in tails] == [3, 3, 1]
    np.testing.assert_array_equal(tails[2]["dm_velocity"][0],
                                  singles[6]["dm_velocity"])
    perm = torch.randperm(7, generator=torch.Generator().manual_seed(3))
    sh1 = list(TE.catalog_batches(fn, 3, generator=3))
    sh2 = list(TE.catalog_batches(fn, 3, prefetch=False,
                                  generator=torch.Generator().manual_seed(3)))
    for b1, b2 in zip(sh1, sh2):
        for k in b1:
            np.testing.assert_array_equal(b1[k], b2[k], err_msg=k)
    np.testing.assert_array_equal(np.concatenate([b["M200"] for b in sh1]),
                                  [singles[int(i)]["M200"] for i in perm[:6]])
    sel = list(TE.catalog_batches(fn, 3, fields=["dm_position"]))
    assert "dm_position" in sel[0] and "dm_velocity" not in sel[0]
    assert "M200" in sel[0]
    np.testing.assert_array_equal(sel[0]["dm_position"],
                                  got[0]["dm_position"])
    with pytest.raises(ValueError, match="batch_size"):
        next(TE.catalog_batches(fn, 0))


def test_catalog_to_particles_bridge(tmp_path, port_catalogs):
    """One cluster as a ClusterParticles, both products, into a Gadget file
    with nothing clipped."""
    p = TE.catalog_to_particles(port_catalogs["full"], 1, device="cpu")
    assert sorted(p.particle_types) == ["dm", "gas", "star"]
    assert p.num_particles == {"dm": 300, "gas": 200, "star": 80}
    assert bool((p["gas", "particle_velocity"] == 0).all())
    assert bool((p["gas", "thermal_energy"] > 0).all())
    assert bool((p["dm", "particle_mass"] > 0).all())
    (_, cl), = TE.read_catalog(port_catalogs["full"], indices=[1])
    np.testing.assert_array_equal(p["star", "particle_position"].numpy(),
                                  cl["star_position"])
    p.add_offsets([15000.0] * 3, [0.0] * 3)
    out = p.write_to_gadget_file(str(tmp_path / "ic.h5"), box_size=30000.0,
                                 overwrite=True)
    assert out == {"dm": 300, "gas": 200, "star": 80}
    p2 = TE.catalog_to_particles(port_catalogs["dm"], 2, device="cpu")
    assert p2.particle_types == ["dm"] and p2.num_particles == {"dm": 400}


def test_catalog_consumers_accept_one_shot_iterables(port_catalogs):
    fn = port_catalogs["dm"]
    n = sum(b["M200"].shape[0] for b in
            TE.catalog_batches(iter([fn]), 2, drop_remainder=False))
    assert n == 5
    assert TE.verify_catalog(iter([fn]), device="cpu")["violations"] == []


# ---------------------------------------------- files across the packages
@pytest.mark.parametrize("product", ["full", "dm"])
def test_jax_package_reads_and_verifies_a_port_catalog(port_catalogs,
                                                       product):
    fn = port_catalogs[product]
    _assert_same(dict(JE.read_catalog(fn)), dict(TE.read_catalog(fn)))
    for b1, b2 in zip(JE.catalog_batches(fn, 2, drop_remainder=False),
                      TE.catalog_batches(fn, 2, drop_remainder=False)):
        assert set(b1) == set(b2)
        for k in b1:
            np.testing.assert_array_equal(b1[k], b2[k], err_msg=k)
    rep = JE.verify_catalog(fn, strict=True)
    assert rep["violations"] == [] and rep["n_clusters_checked"] == 5
    mine = TE.verify_catalog(fn, device="cpu")
    for k in ("n_particles_checked", "max_radius_frac", "max_speed_frac"):
        assert mine[k] == pytest.approx(rep[k], rel=1e-9), k


@pytest.mark.parametrize("product", ["full", "dm"])
def test_port_reads_and_verifies_a_jax_catalog(jax_catalogs, product):
    fn = jax_catalogs[product]
    _assert_same(dict(TE.read_catalog(fn)), dict(JE.read_catalog(fn)))
    for b1, b2 in zip(TE.catalog_batches(fn, 2), JE.catalog_batches(fn, 2)):
        for k in b2:
            np.testing.assert_array_equal(b1[k], b2[k], err_msg=k)
    rep = TE.verify_catalog(fn, device="cpu")
    assert rep["violations"] == [] and rep["n_clusters_checked"] == 5
    want = JE.verify_catalog(fn)
    for k in ("n_particles_checked", "max_radius_frac", "max_speed_frac",
              "max_mass_rel_err"):
        assert rep[k] == pytest.approx(want[k], rel=1e-6, abs=1e-12), k
    p = TE.catalog_to_particles(fn, 3, device="cpu")
    (_, cl), = JE.read_catalog(fn, indices=[3])
    key = "dm_position" if product == "full" else "particle_position"
    np.testing.assert_array_equal(p["dm", "particle_position"].numpy(),
                                  cl[key])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_zeroed_extents_fail_both_verifiers(tmp_path, port_catalogs,
                                            jax_catalogs, writer):
    src = (port_catalogs if writer == "port" else jax_catalogs)["full"]
    fn = _copy(src, tmp_path / "zeroed.h5")
    with h5py.File(fn, "a") as f:
        for i in (2, 3):
            for k in f[f"cluster_{i:06d}"]:
                f[f"cluster_{i:06d}"][k][...] = 0.0
    for verify in (JE.verify_catalog,
                   lambda fn, **kw: TE.verify_catalog(fn, device="cpu",
                                                      **kw)):
        with pytest.raises(ValueError, match="zero"):
            verify(fn)
        bad = verify(fn, strict=False)["violations"]
        assert any("cluster 2" in v for v in bad)
        assert not any("cluster 1 " in v for v in bad)


def test_resume_across_the_packages_is_refused(tmp_path, port_catalogs,
                                               jax_catalogs):
    """Draws of torch's generators never equal threefry's: each package
    refuses to resume the other's catalog, on the draws' version."""
    M, c = _params(5, 0)
    for src, resume in ((port_catalogs["full"],
                         lambda fn: JE.ensemble_datagen(
                             M, c, fn, COUNTS, batch_size=2, num_points=128,
                             key=jax.random.key(3), resume=True)),
                        (jax_catalogs["full"],
                         lambda fn: TE.ensemble_datagen(
                             M, c, fn, COUNTS, resume=True, **KW))):
        fn = _copy(src, tmp_path / os.path.basename(os.path.dirname(src)))
        with h5py.File(fn, "a") as f:
            del f.attrs["complete"]
        with pytest.raises(ValueError, match="resume config mismatch on "
                                             "'draws_version'"):
            resume(fn)
