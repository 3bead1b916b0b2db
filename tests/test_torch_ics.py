"""The port's multi-cluster IC scene (``ClusterICs``, gas mixing,
resampling, Gadget and YAML files, the ``utils`` shims) against the JAX
package's, on the CPU at ~1e4 particles.

Both packages read one model HDF5 file, written by the JAX package from
the canonical cluster with both DFs, and the same per-halo particle
files, written by the JAX package (the particles are the port's draws,
which are quick here).  Tolerances: float64 fields rtol 1e-10 (the same
splines, one summation order apart); counts, masks, headers and YAML
exact; Gadget float32 blocks within one float32 ulp; IDs per type, since
the JAX package orders a summed container's types by set iteration (the
port keeps their order of first appearance, the same under every hash
seed).
"""

import os
import subprocess
import sys
import types

import h5py
import numpy as np
import pytest
import torch

import cluster_generator_tpu as jcg
import cluster_generator_tpu.particles as JP
import cluster_generator_tpu.utils as JU
import cluster_generator_tpu_torch as tcg
import cluster_generator_tpu_torch.ics as TI
import cluster_generator_tpu_torch.particles as TP
import cluster_generator_tpu_torch.utils as TU
from cluster_generator_tpu_torch.convert import cluster_model_from_numpy

torch.set_num_threads(2)

RTOL = 1e-10
CENTERS = [[-2000.0, 0.0, 0.0], [2000.0, 0.0, 0.0], [0.0, 2500.0, 0.0]]
VELOCITIES = [[0.2, 0.0, 0.0], [-0.2, 0.0, 0.0], [0.0, -0.25, 0.0]]
R_MAX = [3000.0, 2500.0, 2000.0]
TOTALS = {"dm": 6000, "gas": 4000, "star": 1200, "tracer": 600}
HALO_COUNTS = {"dm": 2000, "gas": 1500, "star": 400, "tracer": 200}
BOX = 16000.0


@pytest.fixture(scope="module")
def scene_files(canonical_model, tmp_path_factory):
    """The profile file and three halos' particle files, all written by
    the JAX package."""
    d = tmp_path_factory.mktemp("torch_ics")
    canonical_model.dm_virial, canonical_model.star_virial  # noqa: B018
    prof = str(d / "prof.h5")
    canonical_model.write_model_to_h5(prof)
    tm = tcg.ClusterModel.from_h5_file(prof, device="cpu")
    base = torch.Generator().manual_seed(21)
    files = []
    for i in range(3):
        p = TI.draw_halo_particles(tm, HALO_COUNTS, R_MAX[i],
                                   generators=TI.halo_generators(base))
        fn = str(d / f"halo{i}_particles.h5")
        jcg.ClusterParticles.from_fields(p.to_numpy()).write_particles(fn)
        files.append(fn)
    return prof, files


def _scenes(n_halos, scene_files, **kw):
    """The same scene in both packages, on the same particle files."""
    prof, files = scene_files
    args = ("scene", n_halos, [prof] * n_halos, CENTERS[:n_halos],
            VELOCITIES[:n_halos])
    kw = dict(num_particles=dict(TOTALS), r_max=R_MAX[:n_halos],
              particle_files=files[:n_halos], **kw)
    return jcg.ClusterICs(*args, **kw), tcg.ClusterICs(*args, **kw,
                                                       device="cpu")


def _assert_ids_match(got, want, runs=False, union=False):
    """Gadget IDs by type: the same count per type; ``runs``: each type's
    IDs one run of consecutive values, as within one file; ``union``: the
    same IDs over all types, as over one whole file.  Which IDs a type gets
    follows the order of the types, and the JAX package orders the types
    of a summed container by set iteration (it changes with the hash
    seed), while the port keeps their order of first appearance."""
    assert set(got) == set(want)
    for ptype in want:
        g, w = np.asarray(got[ptype]), np.asarray(want[ptype])
        assert g.shape == w.shape, ptype
        for ids in (g, w) if runs else ():
            np.testing.assert_array_equal(np.diff(ids.astype(np.int64)), 1,
                                          err_msg=ptype)
    if union and want:
        np.testing.assert_array_equal(
            np.sort(np.concatenate([np.asarray(v, np.int64)
                                    for v in got.values()])),
            np.sort(np.concatenate([np.asarray(v, np.int64)
                                    for v in want.values()])))


def _assert_particles_match(got, want, rtol=RTOL):
    assert sorted(got.particle_types) == sorted(want.particle_types)
    assert got.num_particles == want.num_particles
    assert set(got.fields) == set(want.fields)
    assert got.passive_scalars == want.passive_scalars
    for key, w in want.fields.items():
        g = got[key].numpy()
        w = np.asarray(w)
        assert g.shape == w.shape, key
        if key[1] != "particle_index":
            assert got[key].dtype == torch.float64
            np.testing.assert_allclose(g, w, rtol=rtol, atol=0.0,
                                       err_msg=str(key))
    _assert_ids_match(
        {k[0]: v.numpy() for k, v in got.fields.items()
         if k[1] == "particle_index"},
        {k[0]: v for k, v in want.fields.items() if k[1] == "particle_index"})


def _pair(tp):
    """A JAX container and a port container of the same values."""
    host = tp.to_numpy()
    return (jcg.ClusterParticles.from_fields(
        {k: v.copy() for k, v in host.items()}),
            tcg.ClusterParticles.from_fields(
                {k: torch.from_numpy(v.copy()) for k, v in host.items()}))


def _assert_gadget_files_match(a, b):
    """Same groups, datasets and attributes: integers and header exact,
    float32 blocks within one ulp, float64 blocks at RTOL; IDs by
    :func:`_assert_ids_match`."""
    ids = ({}, {})
    with h5py.File(a, "r") as fa, h5py.File(b, "r") as fb:
        assert list(fa.keys()) == list(fb.keys())
        for g in fa:
            if "ParticleIDs" in fa[g]:
                ids[0][g] = fa[g]["ParticleIDs"][()]
                ids[1][g] = fb[g]["ParticleIDs"][()]
                assert ids[0][g].dtype == ids[1][g].dtype == np.uint32, g
            assert list(fa[g].keys()) == list(fb[g].keys()), g
            assert set(fa[g].attrs) == set(fb[g].attrs), g
            for k in fa[g].attrs:
                x, y = np.asarray(fa[g].attrs[k]), np.asarray(fb[g].attrs[k])
                assert x.dtype == y.dtype, (g, k)
                np.testing.assert_array_equal(x, y, err_msg=f"{g}/{k}")
            for k in fa[g]:
                x, y = fa[g][k][()], fb[g][k][()]
                assert x.dtype == y.dtype and x.shape == y.shape, (g, k)
                if x.dtype == np.float32:
                    np.testing.assert_array_max_ulp(x, y, maxulp=1)
                elif x.dtype == np.float64:
                    np.testing.assert_allclose(x, y, rtol=RTOL, atol=0.0)
                elif k != "ParticleIDs":
                    np.testing.assert_array_equal(x, y, err_msg=f"{g}/{k}")
    _assert_ids_match(*ids, runs=True, union=True)


# ---------------------------------------------------- geometry, counting
@pytest.mark.parametrize("args", [([0.0, 0.0, 0.0], 3000.0, 500.0, 100.0),
                                  ([7000.0] * 3, 3000.0, 500.0, 0.0),
                                  ([1.0, -2.0, 3.5], 4123.5, 0.0, 250.0)])
def test_compute_centers_for_binary_matches_jax(args):
    got = tcg.compute_centers_for_binary(*args)
    want = jcg.compute_centers_for_binary(*args)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    diff = got[1] - got[0]
    assert np.linalg.norm(diff) == pytest.approx(args[1])


@pytest.mark.parametrize("n_halos", [1, 2, 3])
def test_prorating_matches_jax(scene_files, n_halos):
    J, T = _scenes(n_halos, scene_files,
                   r_max_tracer=[1500.0, 1200.0, 900.0][:n_halos])
    assert dict(T.num_particles) == dict(J.num_particles)
    for key, n in TOTALS.items():
        assert abs(sum(T.num_particles[key]) - n) <= n_halos
    # the module function is the seam the methods use
    models = [T.load_model(i) for i in range(n_halos)]
    assert T.load_model(0) is models[0]
    assert TI.halo_particle_counts(models, T.r_max, TOTALS,
                                   T.r_max_tracer) == T.num_particles
    none = TI.halo_particle_counts(models, T.r_max, {"dm": 10})
    assert none["gas"] == [0] * n_halos and sum(none["dm"]) == 10


# ------------------------------------------------------ setup, resample
@pytest.mark.parametrize("n_halos", [1, 2, 3])
def test_setup_particle_ics_matches_jax(scene_files, n_halos):
    J, T = _scenes(n_halos, scene_files)
    want = J.setup_particle_ics()
    got = T.setup_particle_ics()
    _assert_particles_match(got, want)
    assert got.device.type == "cpu"
    if n_halos > 1:
        # mixed gas velocities inside the hull of the bulk velocities
        v = got["gas", "particle_velocity"]
        bulk = torch.tensor(VELOCITIES[:n_halos], dtype=torch.float64)
        assert bool((v >= bulk.min(0).values - 1e-12).all()
                    and (v <= bulk.max(0).values + 1e-12).all())


@pytest.mark.parametrize("n_halos", [1, 2, 3])
def test_resample_particle_ics_matches_jax(scene_files, n_halos):
    J, T = _scenes(n_halos, scene_files)
    out = []
    for ics in (J, T):
        parts = ics.setup_particle_ics()
        for i in range(n_halos):
            m = ics.load_model(i)
            m.set_field("metallicity", np.linspace(1.0, 0.1, m.num_elements))
        n = parts.num_particles["gas"]
        parts.set_field("gas", "metallicity", np.zeros(n),
                        passive_scalar=True)
        # relax: every gas particle moved a little, so the resample
        # rewrites new radii
        parts["gas", "particle_position"] = (
            parts["gas", "particle_position"] * 1.01)
        out.append(ics.resample_particle_ics(
            parts, passive_scalars=["metallicity"]))
    _assert_particles_match(out[1], out[0])
    if n_halos > 1:
        z = out[1]["gas", "metallicity"]
        assert bool((z > 0).any()) and float(z.max()) <= 1.0 + 1e-12


def test_combine_with_heterogeneous_grids_matches_jax(canonical_model):
    """Halos on radial grids of different sizes mix (JAX
    tests/test_particles.py:203)."""
    rhot = jcg.snfw_density_profile(5e14, 400.0)
    rhog = jcg.vikhlinin_density_profile(1.0, 80.0, 1200.0, 1.0, 0.67, 3)
    small = jcg.ClusterModel.from_dens_and_tden(0.1, 1e4, rhog, rhot,
                                                num_points=500)
    big = canonical_model
    t_big, t_small = (cluster_model_from_numpy(
        {k: np.asarray(v) for k, v in m.fields.items()}, device="cpu")
        for m in (big, small))
    jp1, tp1 = _pair(t_big.generate_gas_particles(3000, r_max=2500.0,
                                                  prng=31))
    jp2, tp2 = _pair(t_small.generate_gas_particles(3000, r_max=2500.0,
                                                    prng=32))
    args = ([2000.0, 3000.0, 3000.0], [4000.0, 3000.0, 3000.0],
            [0.3, 0.0, 0.0], [-0.3, 0.0, 0.0])
    want = JP.combine_two_clusters(jp1, jp2, big, small, *args)
    got = TP.combine_two_clusters(tp1, tp2, t_big, t_small, *args)
    _assert_particles_match(got, want)
    assert got.num_particles["gas"] == 6000
    assert bool((got["gas", "density"] > 0).all())
    assert bool((got["gas", "particle_velocity"][:, 0].abs()
                 <= 0.3 + 1e-12).all())


def test_sample_clusters_requires_a_density_field(canonical_model):
    tm = cluster_model_from_numpy(
        {k: np.asarray(v) for k, v in canonical_model.fields.items()},
        device="cpu")
    p = tm.generate_gas_particles(1000, r_max=2000.0, prng=33)
    nogas = {"radius": tm["radius"]}
    with pytest.raises(ValueError, match="density"):
        TP._sample_clusters(p, [nogas], [[0.0] * 3], [[0.0] * 3])


def test_gas_mixing_clamps_to_model_grids_matches_jax(canonical_model):
    """Mixed gas energies stay positive with draws below the first grid
    point and far beyond the other halo (JAX tests/test_particles.py:315),
    and the values match JAX's."""
    tm = cluster_model_from_numpy(
        {k: np.asarray(v) for k, v in canonical_model.fields.items()},
        device="cpu")
    jp1, tp1 = _pair(tm.generate_gas_particles(5000, prng=11))
    jp2, tp2 = _pair(tm.generate_gas_particles(5000, prng=12))
    args = ([-3000.0, 0, 0], [3000.0, 0, 0], [100.0, 0, 0], [-100.0, 0, 0])
    want = JP.combine_two_clusters(jp1, jp2, canonical_model,
                                   canonical_model, *args)
    got = TP.combine_two_clusters(tp1, tp2, tm, tm, *args)
    _assert_particles_match(got, want)
    for name in ("thermal_energy", "density"):
        v = got["gas", name]
        assert bool(torch.isfinite(v).all() and (v > 0).all())


def test_generation_with_prng(scene_files, tmp_path):
    """Per-halo counts as pro-rated, every species inside its r_max,
    the same particles again for the same seed, others for another, and
    the particle files written and read back."""
    prof, _ = scene_files
    ics = tcg.ClusterICs("gen", 2, [prof] * 2, CENTERS[:2], VELOCITIES[:2],
                         num_particles=dict(TOTALS), r_max=R_MAX[:2],
                         r_max_tracer=[1500.0, 1200.0], device="cpu")
    out = str(tmp_path)
    a = ics._generate_particles(output_directory=out, prng=5)
    b = ics._generate_particles(output_directory=out, prng=5,
                                regenerate_particles=True)
    c = ics._generate_particles(output_directory=out, prng=6,
                                regenerate_particles=True)
    cached = ics._generate_particles(output_directory=out, prng=99)
    for i in range(2):
        for sp in TI.SPECIES:
            assert a[i].num_particles[sp] == ics.num_particles[sp][i]
            r = a[i][sp, "particle_position"].norm(dim=1)
            lim = ics.r_max_tracer[i] if sp == "tracer" else ics.r_max[i]
            assert float(r.max()) <= lim
        for key, v in a[i].fields.items():
            assert torch.equal(v, b[i][key]), key
            assert torch.equal(cached[i][key], c[i][key]), key
        assert not torch.equal(a[i]["dm", "particle_position"],
                               c[i]["dm", "particle_position"])
        assert ics.particle_files[i] == f"{out}/gen_{i}_particles.h5"
    # one species' draws do not depend on another's count
    ics.tot_np = dict(TOTALS, star=0)
    ics._determine_num_particles()
    d = ics._generate_particles(output_directory=out, prng=5,
                                regenerate_particles=True)
    assert "star" not in d[0].particle_types
    assert torch.equal(d[0]["gas", "particle_position"],
                       a[0]["gas", "particle_position"])


# ------------------------------------------------------------------ files
def test_yaml_crosses_both_ways(scene_files, tmp_path):
    J, T = _scenes(2, scene_files, mag_file="b.h5",
                   r_max_tracer=[1500.0, 1200.0])
    ours, theirs = str(tmp_path / "torch.yaml"), str(tmp_path / "jax.yaml")
    T.to_file(ours)
    J.to_file(theirs)
    with open(ours) as a, open(theirs) as b:
        assert a.read() == b.read()
    with pytest.raises(RuntimeError, match="overwrite=False"):
        T.to_file(ours)
    for back in (jcg.ClusterICs.from_file(ours),
                 tcg.ClusterICs.from_file(theirs, device="cpu")):
        assert back.basename == "scene" and back.num_halos == 2
        assert back.profiles == T.profiles
        assert back.particle_files[:2] == T.particle_files[:2]
        np.testing.assert_array_equal(back.center, T.center)
        np.testing.assert_array_equal(back.velocity, T.velocity)
        np.testing.assert_array_equal(back.r_max, T.r_max)
        np.testing.assert_array_equal(back.r_max_tracer, T.r_max_tracer)
        assert back.mag_file == "b.h5" and back.tot_np == T.tot_np
        assert dict(back.num_particles) == dict(T.num_particles)


def test_gadget_files_cross_both_ways(scene_files, tmp_path):
    J, T = _scenes(2, scene_files)
    parts = []
    for ics in (J, T):
        p = ics.setup_particle_ics()
        p.set_field("gas", "metallicity",
                    np.linspace(0.0, 1.0, p.num_particles["gas"]),
                    passive_scalar=True)
        p.add_offsets([BOX / 2] * 3, [0.0] * 3)
        parts.append(p)
    jp, tp = parts
    ours, theirs = str(tmp_path / "torch.h5"), str(tmp_path / "jax.h5")
    counts = tp.write_to_gadget_file(ours, BOX, code="arepo")
    assert counts == jp.write_to_gadget_file(theirs, BOX, code="arepo")
    with pytest.raises(IOError, match="overwrite=False"):
        tp.write_to_gadget_file(ours, BOX)
    _assert_gadget_files_match(ours, theirs)
    with h5py.File(ours, "r") as f:
        assert f["PartType0"]["PassiveScalars"].dtype == np.float64
        assert "GFM_Metallicity" in f["PartType0"]
        assert f["Config"].attrs["VORONOI"] == 1
    # each package reads the other's file
    back = jcg.ClusterParticles.from_gadget_file(ours)
    want = jcg.ClusterParticles.from_gadget_file(theirs)
    got = tcg.ClusterParticles.from_gadget_file(theirs, device="cpu")
    for k, v in want.fields.items():
        if k[1] != "particle_index":
            np.testing.assert_array_equal(back[k], v)
        np.testing.assert_array_equal(got[k].numpy(), v)
    _assert_ids_match(
        {k[0]: v for k, v in back.fields.items() if k[1] == "particle_index"},
        {k[0]: v for k, v in want.fields.items() if k[1] == "particle_index"},
        runs=True)
    assert got["dm", "particle_index"].dtype == torch.int64  # from uint32
    only = tcg.ClusterParticles.from_gadget_file(ours, ptypes=["dm", "star"],
                                                 device="cpu")
    assert only.particle_types == ["dm", "star"]
    assert only.num_particles["dm"] == counts["dm"]


def test_gadget_multi_file_with_id_offset(scene_files, tmp_path):
    """Two halos as the two files of one snapshot: IDs continue across
    files, NumPart_Total holds both, and the shards read back whole."""
    J, T = _scenes(2, scene_files)
    halos = {"jax": J._generate_particles(), "torch": T._generate_particles()}
    for pkg, parts in halos.items():
        for p, c in zip(parts, CENTERS):
            p.add_offsets(np.asarray(c) + BOX / 2, [0.0] * 3)
    counts = [tp.num_particles for tp in halos["torch"]]
    order = ["gas", "dm", "tracer", None, "star", "black_hole"]
    total = np.array([sum(c.get(k, 0) for c in counts) if k else 0
                      for k in order], dtype="uint32")
    for pkg, parts in halos.items():
        off = 0
        for i, p in enumerate(parts):
            fn = str(tmp_path / f"{pkg}.{i}.h5")
            n = p.write_to_gadget_file(fn, BOX, num_files=2, file_num=i,
                                       id_offset=off, npart_total=total)
            off += sum(n.values())
    for i in range(2):
        _assert_gadget_files_match(str(tmp_path / f"torch.{i}.h5"),
                                   str(tmp_path / f"jax.{i}.h5"))
    got = tcg.ClusterParticles.from_gadget_files(str(tmp_path / "torch.0.h5"),
                                                 device="cpu")
    want = jcg.ClusterParticles.from_gadget_files(str(tmp_path / "jax.0.h5"))
    _assert_particles_match(got, want, rtol=0.0)
    ids = []
    for i in range(2):
        with h5py.File(tmp_path / f"torch.{i}.h5", "r") as f:
            np.testing.assert_array_equal(
                f["Header"].attrs["NumPart_Total"], total)
            assert f["Header"].attrs["NumFilesPerSnapshot"] == 2
            ids += [f[g]["ParticleIDs"][()] for g in f if g != "Header"]
    ids = np.sort(np.concatenate(ids))
    np.testing.assert_array_equal(ids, np.arange(1, ids.size + 1))
    assert ids.size == int(total.sum())
    with pytest.raises(ValueError, match="shard 0"):
        tcg.ClusterParticles.from_gadget_files(str(tmp_path / "torch.1.h5"),
                                               device="cpu")


def test_gadget_blocks_on_the_device(scene_files):
    """The block assembly: in-box selection, IDs 1..N over the types in
    order, MassTable the first mass as the file stores it, the potential
    block from 'particle_potential'."""
    prof, _ = scene_files
    m = tcg.ClusterModel.from_h5_file(prof, device="cpu")
    p = (m.generate_dm_particles(3000, compute_potential=True, prng=5)
         + m.generate_star_particles(500, prng=6))
    p.add_offsets([2000.0] * 3, [0.0] * 3)
    for dtype in ("float32", "float64"):
        blocks, counts, table = p.gadget_blocks(4000.0, dtype=dtype,
                                                id_offset=7)
        inside = {sp: int(p._clip_to_box(sp, 4000.0).sum())
                  for sp in p.particle_types}
        assert counts == inside and 0 < counts["dm"] < 3000
        ids = np.concatenate([blocks[sp]["ParticleIDs"]
                              for sp in p.particle_types])
        assert ids.dtype == np.uint32
        np.testing.assert_array_equal(ids, np.arange(8, 8 + ids.size))
        assert blocks["dm"]["Potential"].dtype == np.dtype(dtype)
        assert (blocks["dm"]["Potential"] < 0).all()
        for sp, slot in (("dm", 1), ("star", 4)):
            mass = blocks[sp]["Masses"]
            assert mass.dtype == np.dtype(dtype)
            assert table[slot] == np.float64(mass[0])
            assert table[slot] == np.float64(np.dtype(dtype).type(
                float(p[sp, "particle_mass"][0]) / 1e10))
        assert table[[0, 2, 3, 5]].tolist() == [0.0] * 4
        keep = p._clip_to_box("star", 4000.0)
        np.testing.assert_array_equal(
            blocks["star"]["Coordinates"],
            p["star", "particle_position"][keep].numpy().astype(dtype))


def test_to_yt_dataset_matches_jax(scene_files, monkeypatch):
    calls = []
    yt = types.ModuleType("yt")
    yt.load_particles = lambda data, **kw: calls.append((data, kw)) or "ds"
    monkeypatch.setitem(sys.modules, "yt", yt)
    J, T = _scenes(1, scene_files)
    jp, tp = J._generate_particles()[0], T._generate_particles()[0]
    assert tp.to_yt_dataset(8000.0, ptypes=["dm", "gas"]) == "ds"
    jp.to_yt_dataset(8000.0, ptypes=["dm", "gas"])
    (got, got_kw), (want, want_kw) = calls
    assert list(got) == list(want)
    assert {k[0] for k in got} == {"dm", "gas"}
    for k, (arr, unit) in want.items():
        assert got[k][1] == unit
        np.testing.assert_array_equal(got[k][0], np.asarray(arr))
    assert set(got_kw) == set(want_kw)
    np.testing.assert_array_equal(got_kw.pop("bbox"), want_kw.pop("bbox"))
    assert got_kw == want_kw


def test_create_dataset_names_its_slice_and_the_card_is_the_default(
        scene_files, tmp_path):
    prof, _ = scene_files
    ics = tcg.ClusterICs("ds", 1, [prof], [0.0] * 3, [0.0] * 3,
                         num_particles={"dm": 100}, r_max=2000.0,
                         device="cpu")
    fn = ics.create_dataset(str(tmp_path / "scene.h5"), (16, 16, 16),
                            chunksize=16)
    from cluster_generator_tpu_torch.data_structures import YTHDF5

    assert YTHDF5.load(fn).model_count == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tcg.ClusterICs("ds", 1, [prof], [0.0] * 3, [0.0] * 3,
                           num_particles={"dm": 100}, r_max=2000.0)
    with pytest.raises(ValueError, match="particle_files"):
        tcg.ClusterICs("ds", 1, [prof], [0.0] * 3, [0.0] * 3,
                       num_particles={"dm": 100}, particle_files=["a", "b"],
                       device="cpu")


def test_utils_match_jax():
    assert set(TU.__all__) == set(JU.__all__)
    rho = jcg.snfw_density_profile(1e15, 400.0)
    trho = tcg.snfw_density_profile(1e15, 400.0)
    rr = np.geomspace(1.0, 5000.0, 64)
    for name in ("integrate_mass", "integrate", "integrate_toinf"):
        got = getattr(TU, name)(trho, rr, device="cpu")
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), getattr(JU, name)(rho, rr),
                                   rtol=1e-12, err_msg=name)
    assert TU.ensure_list(np.arange(2)) == [0, 1]
    assert TU.ensure_list("a") == ["a"] and TU.ensure_list((1,)) == [1]
    assert TU.field_label_map == JU.field_label_map
    for k in ("G", "mp", "kboltz", "kpc_to_cm", "X_H", "mu", "mue"):
        assert getattr(TU, k) == getattr(JU, k), k


# ------------------------------------------------ repaired faults (F1, F2)
SUM_PROGRAM = """
import numpy as np
import torch
torch.set_num_threads(1)
from cluster_generator_tpu_torch.particles import ClusterParticles
rng = np.random.RandomState(0)

def part(types):
    f = {}
    for t in types:
        f[t, "particle_position"] = rng.uniform(100.0, 900.0, (5, 3))
        f[t, "particle_velocity"] = np.zeros((5, 3))
        f[t, "particle_mass"] = np.ones(5)
    return ClusterParticles.from_fields(f, device="cpu")

p = part(["dm", "star", "gas", "tracer"]) + part(["dm", "star", "gas"])
blocks, counts, _ = p.gadget_blocks(1000.0)
ids = {t: (int(b["ParticleIDs"][0]), int(b["ParticleIDs"][-1]))
       for t, b in blocks.items()}
print("ORDER", p.particle_types, ids)
"""


def test_summed_species_order_does_not_depend_on_the_hash_seed():
    """``ClusterParticles.__add__`` keeps the types in order of first
    appearance: under PYTHONHASHSEED 0-5 one order and one ID range per
    type."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, "-c", SUM_PROGRAM], cwd=root, text=True,
        env=dict(os.environ, PYTHONPATH=root, PYTHONHASHSEED=str(seed)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE) for seed in range(6)]
    lines = set()
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-2000:]
        lines.update(line for line in out.splitlines()
                     if line.startswith("ORDER"))
    assert lines == {"ORDER ['dm', 'star', 'gas', 'tracer'] {'dm': (1, 10), "
                     "'star': (11, 20), 'gas': (21, 30), 'tracer': (31, 35)}"}


def test_gadget_ids_keep_their_dtype_through_write_particles(tmp_path):
    """IDs read from a Gadget file (uint32) are int64 in the container and
    uint32 again in ``write_particles``' file, which the JAX package reads
    with the same dtype and values as its own round trip."""
    rng = np.random.RandomState(1)
    fields = {}
    for t, n in (("gas", 40), ("dm", 60)):
        fields[t, "particle_position"] = rng.uniform(100.0, 900.0, (n, 3))
        fields[t, "particle_velocity"] = rng.randn(n, 3)
        fields[t, "particle_mass"] = np.ones(n)
    fields["gas", "thermal_energy"] = np.ones(40)
    fields["gas", "density"] = np.ones(40)
    gadget = str(tmp_path / "snap.h5")
    tcg.ClusterParticles.from_fields(fields, device="cpu").write_to_gadget_file(
        gadget, 1000.0)
    tp = tcg.ClusterParticles.from_gadget_file(gadget, device="cpu")
    assert tp["dm", "particle_index"].dtype == torch.int64
    assert tp.to_numpy()["dm", "particle_index"].dtype == np.uint32
    ours, theirs = str(tmp_path / "ours.h5"), str(tmp_path / "theirs.h5")
    tp.write_particles(ours)
    jcg.ClusterParticles.from_gadget_file(gadget).write_particles(theirs)
    got = jcg.ClusterParticles.from_file(ours)
    want = jcg.ClusterParticles.from_file(theirs)
    for t in ("gas", "dm"):
        assert got[t, "particle_index"].dtype == np.uint32
        np.testing.assert_array_equal(got[t, "particle_index"],
                                      want[t, "particle_index"])
    with h5py.File(ours) as a, h5py.File(theirs) as b:
        for t in ("gas", "dm"):
            assert a[t]["particle_index"].dtype == b[t][
                "particle_index"].dtype == np.uint32
    # the dtype survives a sum of such containers
    summed = tp + tcg.ClusterParticles.from_gadget_file(gadget,
                                                        device="cpu")
    assert summed.to_numpy()["gas", "particle_index"].dtype == np.uint32
