"""The port's command line (``python -m cluster_generator_tpu_torch``)
against the JAX package's, subcommand by subcommand, in-process
(``cli.main(argv)``) on the CPU (``--device cpu``) at toy sizes: the eight
cases of tests/test_cli.py, with the files each CLI writes read by the
other package.

Tolerances: a model file built by both CLIs from the same flags agrees
field by field within 1e-12 of each field's max and DFs within rtol 1e-6
(tests/test_torch_class_api.py's bounds between the packages); a grid
painted by either engine of the port matches the JAX CLI's grid within
1e-12 of each field's max in f8 and within one float32 rounding (2**-23
relative) in f4.  The draws of the two CLIs differ (torch generators are
not threefry), so catalogs and particles are held to the JAX package's
readers and QA gate, not to its values.
"""

import json
import os

import h5py
import numpy as np
import pytest
import torch

from cluster_generator_tpu.cli import main as jmain
from cluster_generator_tpu_torch.cli import main

torch.set_num_threads(1)

NP = 128  # model grid points: small but enough for stable HSE/DF
CPU = ["--device", "cpu"]
FIELD_ATOL = 1e-12   # of each field's max, between the packages
DF_RTOL = 1e-6
GRID_F8 = 1e-12      # of each field's max
GRID_F4 = 2.0 ** -23  # one float32 rounding, relative

BUILD = ["build", "--m200", "1.2e15", "--conc", "4.5", "--num-points",
         str(NP), "--beta", "100"]


def _json(capsys):
    out = capsys.readouterr().out
    return json.loads(out[out.index("{"):])


@pytest.fixture(scope="module")
def model_file(tmp_path_factory):
    fn = str(tmp_path_factory.mktemp("cli_model") / "model.h5")
    assert main(BUILD + ["-o", fn] + CPU) == 0
    return fn


@pytest.fixture(scope="module")
def jax_model_file(tmp_path_factory):
    fn = str(tmp_path_factory.mktemp("cli_jax_model") / "model.h5")
    assert jmain(BUILD + ["-o", fn]) == 0
    return fn


def test_info(capsys):
    assert main(["info"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "cluster_generator_tpu_torch 0.1.0"
    cuda = torch.cuda.is_available()
    assert f"torch {torch.__version__}" in out[1]
    assert f"backend={'cuda' if cuda else 'cpu'}" in out[1]
    assert f"devices={torch.cuda.device_count() if cuda else 0}" in out[1]
    assert jmain(["info"]) == 0
    # the profile count and the exporters: the same line as the JAX CLI's
    assert out[-1] == capsys.readouterr().out.splitlines()[-1]


def test_build_writes_loadable_model(model_file, jax_model_file, tmp_path):
    import cluster_generator_tpu_torch as tcg
    from cluster_generator_tpu.model import ClusterModel as JModel

    m = tcg.ClusterModel.from_h5_file(model_file, device="cpu")
    assert m.num_elements == NP
    for f in ("density", "temperature", "dark_matter_density",
              "magnetic_field_strength"):
        assert f in m, f
    # the DF is stored ONCE, as the top-level dataset the loader resumes
    # from, not as a radial field
    with h5py.File(model_file) as f:
        assert "dm_df" in f and "dm_df" not in f["fields"]
    assert m._dm_virial is not None  # resumed, not recomputed
    assert float(m.check_hse()[2:-2].abs().max()) < 1e-2

    # field by field against the JAX CLI's file from the same flags, each
    # file read by the other package's reader too
    jm = JModel.from_h5_file(jax_model_file)
    assert sorted(m.keys()) == sorted(jm.keys())
    for k in jm.keys():
        want = np.asarray(jm[k])
        np.testing.assert_allclose(m[k].numpy(), want, rtol=0,
                                   atol=FIELD_ATOL * np.abs(want).max(),
                                   err_msg=k)
    np.testing.assert_allclose(m.dm_virial.df.numpy(),
                               np.asarray(jm.dm_virial.df), rtol=DF_RTOL)
    jm2 = JModel.from_h5_file(model_file)
    assert jm2._dm_virial is not None
    np.testing.assert_array_equal(np.asarray(jm2["density"]),
                                  m["density"].numpy())

    # no --device: the card, which raises without one
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(BUILD + ["-o", str(tmp_path / "x.h5")])
        assert not (tmp_path / "x.h5").exists()


def test_particles_native_and_gadget(model_file, tmp_path):
    from cluster_generator_tpu.particles import ClusterParticles as JParts
    from cluster_generator_tpu_torch import ClusterModel
    from cluster_generator_tpu_torch import sampling as TSamp

    fn = str(tmp_path / "parts.h5")
    assert main(["particles", model_file, "--dm", "4000", "--gas", "2000",
                 "--star", "500", "--tracer", "200", "--r-max", "5000",
                 "-o", fn] + CPU) == 0
    p = JParts.from_file(fn)
    assert p.num_particles == {"dm": 4000, "gas": 2000, "star": 500,
                               "tracer": 200}
    for sp in ("dm", "gas", "star", "tracer"):
        pos = np.asarray(p[sp, "particle_position"])
        assert pos.dtype == np.float64 and np.isfinite(pos).all(), sp
    # KS of the DM radii against the model's truncated mass CDF
    m = ClusterModel.from_h5_file(model_file, device="cpu")
    P, rr, _ = TSamp._truncated_cdf(m["radius"], m["dark_matter_mass"],
                                    m["dark_matter_density"], 5000.0)
    r = np.sort(np.linalg.norm(np.asarray(p["dm", "particle_position"]),
                               axis=1))
    c = np.interp(r, rr.numpy(), P.numpy())
    i = np.arange(1, r.size + 1)
    ks = max((i / r.size - c).max(), (c - (i - 1) / r.size).max())
    assert r.max() <= 5000.0 and ks < 2.23 / np.sqrt(r.size)

    gd = str(tmp_path / "snap.h5")
    assert main(["particles", model_file, "--dm", "1000", "--r-max",
                 "5000", "--gadget", "14000", "-o", gd] + CPU) == 0
    with h5py.File(gd) as f:
        assert f["Header"].attrs["NumPart_ThisFile"][1] == 1000
        assert f["PartType1/Coordinates"].dtype == np.float32
    g = JParts.from_gadget_file(gd)
    pos = np.asarray(g["dm", "particle_position"])
    assert pos.shape == (1000, 3)
    assert 6000 < pos.mean() < 8000  # centred at box/2

    # no counts -> usage error
    assert main(["particles", model_file, "-o",
                 str(tmp_path / "x.h5")] + CPU) == 2


def test_ics_subcommand(model_file, tmp_path):
    from cluster_generator_tpu.ics import ClusterICs
    from cluster_generator_tpu.particles import ClusterParticles as JParts

    yml = str(tmp_path / "scene.yaml")
    ClusterICs("cli_demo", 2, [model_file, model_file],
               [[-1000.0, 0.0, 0.0], [1000.0, 0.0, 0.0]],
               [[200.0, 0.0, 0.0], [-200.0, 0.0, 0.0]],
               num_particles={"dm": 3000, "gas": 1500, "star": 400},
               r_max=4000.0).to_file(yml, overwrite=True)
    out = str(tmp_path / "merger.h5")
    assert main(["ics", yml, "-o", out] + CPU) == 0
    # per-halo particle files land NEXT TO the output, not in cwd
    assert (tmp_path / "cli_demo_0_particles.h5").exists()
    p = JParts.from_file(out)
    assert p.num_particles["dm"] == 3000
    assert set(p.particle_types) == {"dm", "gas", "star"}
    # two equal halos at opposite bulk velocities: the mean is ~0
    v = np.asarray(p["dm", "particle_velocity"])[:, 0]
    assert np.isfinite(v).all() and abs(v.mean()) < 50.0
    assert main(["ics", yml, "--code", "arepo", "-o",
                 str(tmp_path / "a.h5")] + CPU) == 2  # no --boxsize


def test_datagen_verify_roundtrip(tmp_path, capsys):
    from cluster_generator_tpu.parallel.ensemble import verify_catalog

    cat = str(tmp_path / "cat.h5")
    gen = ["--batch-size", "2", "--num-points", str(NP)] + CPU
    assert main(["datagen", "-n", "4", "--dm", "600", "--gas", "400",
                 "--star", "150", "-o", cat] + gen) == 0
    capsys.readouterr()
    assert main(["verify", cat] + CPU) == 0
    report = _json(capsys)
    assert report["n_clusters_checked"] == 4
    assert report["violations"] == []
    # the JAX package's QA gate passes the port's catalog
    want = verify_catalog(cat, strict=True)
    assert want["n_clusters_checked"] == 4
    assert report["max_speed_frac"] == pytest.approx(want["max_speed_frac"],
                                                     rel=1e-6)
    with h5py.File(cat) as f:  # torch draws: the JAX version + 2000
        assert f.attrs["draws_version"] > 1000

    # corrupt one dataset -> verify exits 1 and names the violation
    with h5py.File(cat, "a") as f:
        d = f["cluster_000002/gas_thermal_energy"]
        d[...] = np.asarray(d[()]) * 3.0
    assert main(["verify", cat] + CPU) == 1
    assert "thermal energy" in capsys.readouterr().out

    # DM-only product + resume flag on a complete catalog (no-op)
    cat2 = str(tmp_path / "cat_dm.h5")
    assert main(["datagen", "-n", "3", "--dm", "500", "-o", cat2] + gen) == 0
    with h5py.File(cat2) as f:
        before = f["cluster_000001/particle_position"][()]
    assert main(["datagen", "-n", "3", "--dm", "500", "-o", cat2,
                 "--resume"] + gen) == 0
    with h5py.File(cat2) as f:
        np.testing.assert_array_equal(
            f["cluster_000001/particle_position"][()], before)
    assert verify_catalog(cat2, strict=True)["violations"] == []

    # usage errors, the refused ahead-of-time flags among them
    assert main(["datagen", "-n", "2", "-o", cat2] + CPU) == 2
    assert main(["datagen", "-n", "2", "--prorate", "1000", "--dm", "5",
                 "-o", cat2] + CPU) == 2
    assert main(["datagen", "-n", "2", "--dm", "10", "--rank", "0",
                 "-o", cat2] + CPU) == 2  # --rank without --nproc
    for aot in (["--aot-dir", str(tmp_path / "aot")], ["--prime-aot"]):
        assert main(["datagen", "-n", "2", "--dm", "10", "-o",
                     str(tmp_path / "aot.h5")] + aot + CPU) == 2
        assert "eager" in capsys.readouterr().err
    assert not (tmp_path / "aot.h5").exists()


def test_catalog_inspect_and_multihost(tmp_path, capsys):
    from cluster_generator_tpu.parallel.ensemble import read_catalog

    # two shards of one 5-cluster run via --rank/--nproc
    base = str(tmp_path / "mh.h5")
    for r in (0, 1):
        assert main(["datagen", "-n", "5", "--dm", "300",
                     "--batch-size", "2", "--num-points", str(NP),
                     "-o", base, "--rank", str(r), "--nproc", "2"]
                    + CPU) == 0
    shards = [str(tmp_path / f"mh.{r}of2.h5") for r in (0, 1)]
    capsys.readouterr()
    assert main(["catalog"] + shards) == 0
    info = _json(capsys)
    assert info["n_clusters"] == 5 and info["groups_present"] == 5
    assert info["complete"] is True
    # the JAX CLI's inspector prints the same report
    assert jmain(["catalog"] + shards) == 0
    assert _json(capsys) == info
    assert main(["verify"] + shards + CPU) == 0
    # the shard set equals a one-process catalog of the same seed
    one = str(tmp_path / "one.h5")
    assert main(["datagen", "-n", "5", "--dm", "300", "--batch-size", "2",
                 "--num-points", str(NP), "-o", one] + CPU) == 0
    got, want = dict(read_catalog(shards)), dict(read_catalog(one))
    assert sorted(got) == sorted(want) == list(range(5))
    for i in want:
        np.testing.assert_array_equal(got[i]["particle_position"],
                                      want[i]["particle_position"])

    # a lost shard must NOT pass the completeness gate: supplying only
    # rank 0 of 2 exits 1 and names the missing rank
    capsys.readouterr()
    assert main(["catalog", shards[0]]) == 1
    info = _json(capsys)
    assert info["missing_shard_ranks"] == [1]

    # a bare --indices (flag with no values) is an argparse error, not a
    # vacuous zero-cluster pass of the QA gate
    with pytest.raises(SystemExit) as e:
        main(["verify", shards[0], "--indices"])
    assert e.value.code == 2

    # a plain catalog missing groups is flagged
    with h5py.File(shards[0], "a") as f:
        f.attrs["shard_count"] = 1
    capsys.readouterr()
    assert main(["catalog", shards[0]]) == 1


def test_grid_subcommand(jax_model_file, tmp_path):
    out = {}
    for dtype in ("f8", "f4"):
        fn = str(tmp_path / f"jax_{dtype}.h5")
        assert jmain(["grid", jax_model_file, "--dims", "32", "--chunksize",
                      "16", "--dtype", dtype, "-o", fn]) == 0
        out["jax", dtype] = fn
        for engine in ("device", "native"):
            fn = str(tmp_path / f"{engine}_{dtype}.h5")
            assert main(["grid", jax_model_file, "--dims", "32",
                         "--chunksize", "16", "--dtype", dtype, "--engine",
                         engine, "-o", fn] + CPU) == 0
            out[engine, dtype] = fn
    for dtype in ("f8", "f4"):
        with h5py.File(out["jax", dtype]) as fj:
            assert fj.attrs["chunksize"] == 16
            for engine in ("device", "native"):
                with h5py.File(out[engine, dtype]) as f:
                    assert sorted(f.attrs) == sorted(fj.attrs)
                    np.testing.assert_array_equal(
                        f["chunks/chunkmap"][()], fj["chunks/chunkmap"][()])
                    for k in fj["grid"]:
                        got, want = f["grid"][k][()], fj["grid"][k][()]
                        assert got.dtype == np.dtype(dtype), (engine, k)
                        msg = f"{engine} {dtype} {k}"
                        if dtype == "f8":
                            np.testing.assert_allclose(
                                got, want, rtol=0,
                                atol=GRID_F8 * np.abs(want).max(),
                                err_msg=msg)
                        else:
                            np.testing.assert_allclose(
                                got, want, rtol=GRID_F4, atol=0,
                                err_msg=msg)


def test_mergers_subcommand(tmp_path, capsys):
    from cluster_generator_tpu.parallel.ensemble import verify_catalog
    from cluster_generator_tpu.parallel.mergers import read_merger_catalog

    cat = str(tmp_path / "mergers.h5")
    gen = ["--num-points", str(NP)] + CPU
    assert main(["mergers", "-n", "3", "--dm", "400", "--gas", "300",
                 "--batch-size", "2", "-o", cat] + gen) == 0
    capsys.readouterr()
    # the catalog inspector understands scene_ groups
    assert main(["catalog", cat]) == 0
    info = _json(capsys)
    assert info["n_clusters"] == 3 and info["groups_present"] == 3
    assert info["complete"] is True
    assert info["files"][0]["attrs"]["product"] == "merger_scenes"

    # scenes carry both halos' species segments and finite draws, read by
    # the JAX package's reader; both packages' QA gates pass them
    for _, scene in read_merger_catalog(cat, indices=[1]):
        assert scene["dm_position"].shape == (400, 3)
        assert scene["gas_thermal_energy"].shape == (300,)
        assert np.isfinite(scene["dm_velocity"]).all()
        assert scene["M200"].shape == (2,)
    assert verify_catalog(cat, strict=True)["violations"] == []
    assert main(["verify", cat] + CPU) == 0
    assert _json(capsys)["violations"] == []

    # resume on a complete catalog is a no-op; usage errors exit 2
    assert main(["mergers", "-n", "3", "--dm", "400", "--gas", "300",
                 "--batch-size", "2", "-o", cat, "--resume"] + gen) == 0
    assert main(["mergers", "-n", "2", "-o", cat] + CPU) == 2
    assert main(["mergers", "-n", "2", "--dm", "10", "--rank", "0",
                 "-o", cat] + CPU) == 2
    assert main(["mergers", "-n", "2", "--dm", "10", "--aot-dir",
                 str(tmp_path), "-o", str(tmp_path / "x.h5")] + CPU) == 2

    # multihost shards reassemble under the inspector
    base = str(tmp_path / "mh_sc.h5")
    for r in (0, 1):
        assert main(["mergers", "-n", "3", "--dm", "200",
                     "--batch-size", "1", "-o", base, "--rank", str(r),
                     "--nproc", "2"] + gen) == 0
    shards = [str(tmp_path / f"mh_sc.{r}of2.h5") for r in (0, 1)]
    capsys.readouterr()
    assert main(["catalog"] + shards) == 0
    info = _json(capsys)
    assert info["groups_present"] == 3 and info["complete"] is True
    assert os.path.getsize(shards[1]) > 0
