"""The port's simulation-code exporters (``codes.py``) against the JAX
package's, on the CPU at ~1e4 particles.

Each package runs in a directory of its own holding the same files under
the same names: one model file and two halos' particle files, written by
the JAX package (the particles are the port's draws).  So the outlines
must be equal as strings, and every file written must hold the same
values: Fortran records and text byte for byte, HDF5 datasets and
attributes exactly, Gadget float32 blocks within one float32 ulp.
"""

import hashlib
import os
import shutil

import h5py
import numpy as np
import pytest
import torch

import cluster_generator_tpu as jcg
import cluster_generator_tpu.codes as JC
import cluster_generator_tpu_torch as tcg
import cluster_generator_tpu_torch.codes as TC
import cluster_generator_tpu_torch.ics as TI

torch.set_num_threads(2)

CENTERS = [[5000.0, 5000.0, 5000.0], [9000.0, 5000.0, 5000.0]]
VELOCITIES = [[0.1, 0.0, 0.0], [-0.1, 0.02, 0.0]]
R_MAX = [2500.0, 2000.0]
HALO_COUNTS = {"dm": 1500, "gas": 1000, "star": 300, "tracer": 200}
TOTALS = {"dm": 3000, "gas": 2000, "star": 600, "tracer": 400}
BOX = 14000.0


@pytest.fixture(scope="module")
def src(canonical_model, tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_codes")
    canonical_model.dm_virial, canonical_model.star_virial  # noqa: B018
    canonical_model.write_model_to_h5(str(d / "prof.h5"))
    tm = tcg.ClusterModel.from_h5_file(str(d / "prof.h5"), device="cpu")
    base = torch.Generator().manual_seed(3)
    for i in range(2):
        p = TI.draw_halo_particles(tm, HALO_COUNTS, R_MAX[i],
                                   generators=TI.halo_generators(base))
        jcg.ClusterParticles.from_fields(p.to_numpy()).write_particles(
            str(d / f"halo{i}_particles.h5"))
    return d


def _workdirs(src, tmp_path):
    out = {}
    for pkg in ("jax", "torch"):
        out[pkg] = tmp_path / pkg
        shutil.copytree(src, out[pkg])
    return out


def _scene(pkg, n_halos, **kw):
    """The scene in package ``pkg``, on relative file names."""
    args = ("codes", n_halos, ["prof.h5"] * n_halos, CENTERS[:n_halos],
            VELOCITIES[:n_halos])
    kw = dict(num_particles=dict(TOTALS), r_max=R_MAX[:n_halos],
              particle_files=[f"halo{i}_particles.h5"
                              for i in range(n_halos)], **kw)
    if pkg == "jax":
        return jcg.ClusterICs(*args, **kw)
    return tcg.ClusterICs(*args, **kw, device="cpu")


def _run_both(dirs, monkeypatch, fn):
    """``fn(pkg, codes module)`` in each package's directory."""
    out = {}
    for pkg, mod in (("jax", JC), ("torch", TC)):
        monkeypatch.chdir(dirs[pkg])
        out[pkg] = fn(pkg, mod)
    return out


def _assert_h5_equal(a, b, float32_ulp=False):
    """Every group, dataset and attribute of two HDF5 files equal, but the
    Gadget IDs: per type the same count and one run of consecutive values,
    over the file the same IDs.  Which run a type gets follows the order of
    a summed container's types, which the JAX package takes from a set
    (it changes with the hash seed) and the port from first appearance."""
    ids = ({}, {})
    with h5py.File(a, "r") as fa, h5py.File(b, "r") as fb:
        def walk(x, y, path):
            if path.endswith("/ParticleIDs"):
                u, v = x[()], y[()]
                assert u.dtype == v.dtype and u.shape == v.shape, path
                for got, arr in zip(ids, (u, v)):
                    np.testing.assert_array_equal(
                        np.diff(arr.astype(np.int64)), 1, err_msg=path)
                    got[path] = arr
                return
            assert sorted(x.attrs) == sorted(y.attrs), path
            for k in x.attrs:
                u, v = np.asarray(x.attrs[k]), np.asarray(y.attrs[k])
                assert u.dtype == v.dtype, (path, k)
                np.testing.assert_array_equal(u, v, err_msg=f"{path}@{k}")
            if isinstance(x, h5py.Dataset):
                u, v = x[()], y[()]
                assert u.dtype == v.dtype and np.shape(u) == np.shape(v), path
                if float32_ulp and u.dtype == np.float32:
                    np.testing.assert_array_max_ulp(u, v, maxulp=1)
                else:
                    np.testing.assert_array_equal(u, v, err_msg=path)
                return
            assert list(x.keys()) == list(y.keys()), path
            for k in x:
                walk(x[k], y[k], f"{path}/{k}")

        walk(fa, fb, "")
    if ids[0]:
        np.testing.assert_array_equal(
            np.sort(np.concatenate(list(ids[0].values()))),
            np.sort(np.concatenate(list(ids[1].values()))))


@pytest.mark.parametrize("fmt", ["hdf5", "fortran"])
@pytest.mark.parametrize("in_cgs", [False, True])
def test_write_amr_particles_matches_jax(src, tmp_path, fmt, in_cgs):
    jp = jcg.ClusterParticles.from_file(str(src / "halo0_particles.h5"))
    tp = tcg.ClusterParticles.from_file(str(src / "halo0_particles.h5"),
                                        device="cpu")
    ptypes, nums = ["tracer", "dm", "star"], {"tracer": 0, "dm": 2, "star": 3}
    a, b = tmp_path / "torch.dat", tmp_path / "jax.dat"
    TC.write_amr_particles(tp, str(a), ptypes, nums, in_cgs=in_cgs,
                           format=fmt)
    JC.write_amr_particles(jp, str(b), ptypes, nums, in_cgs=in_cgs,
                           format=fmt)
    if fmt == "fortran":
        assert a.read_bytes() == b.read_bytes()
        from scipy.io import FortranFile

        with FortranFile(str(a), "r") as f:
            n = int(f.read_ints()[0])
            rec = f.read_reals().reshape(n, 7)
        assert n == sum(HALO_COUNTS[p] for p in ptypes)
        pos = torch.cat([tp[p, "particle_position"] for p in ptypes])
        scale = TC._cgs_factor("particle_position") if in_cgs else 1.0
        np.testing.assert_array_equal(rec[:, :3], (pos * scale).numpy())
    else:
        _assert_h5_equal(str(a), str(b))
    with pytest.raises(IOError, match="overwrite=False"):
        TC.write_amr_particles(tp, str(a), ptypes, nums, overwrite=False,
                               format=fmt)
    with pytest.raises(ValueError, match="Unknown format"):
        TC.write_amr_particles(tp, str(a), ptypes, nums, format="csv")


@pytest.mark.parametrize("use_tracers", [False, True])
def test_setup_gamer_ics_matches_jax(src, tmp_path, monkeypatch,
                                     use_tracers):
    dirs = _workdirs(src, tmp_path)
    out = _run_both(dirs, monkeypatch, lambda pkg, mod: mod.setup_gamer_ics(
        _scene(pkg, 2, mag_file="b.h5"), use_tracers=use_tracers))
    assert out["torch"] == out["jax"]
    for name in ("codes_gamerp_1.h5", "codes_gamerp_2.h5", "prof_gamer.h5"):
        _assert_h5_equal(str(dirs["torch"] / name), str(dirs["jax"] / name))
    with h5py.File(dirs["torch"] / "codes_gamerp_1.h5", "r") as f:
        types = set(np.unique(f["particle_type"][()]).tolist())
    assert types == ({0.0, 2.0, 3.0} if use_tracers else {2.0, 3.0})


def test_setup_flash_ics_matches_jax(src, tmp_path, monkeypatch):
    dirs = _workdirs(src, tmp_path)
    out = _run_both(dirs, monkeypatch, lambda pkg, mod: mod.setup_flash_ics(
        _scene(pkg, 2)))
    assert out["torch"] == out["jax"]
    assert any("Merger_File_Par2" in ln for ln in out["torch"])
    no_parts = TC.setup_flash_ics(_scene("torch", 1), use_particles=False)
    assert not any("Merger_File_Par" in ln for ln in no_parts)


def test_setup_ramses_ics_matches_jax(src, tmp_path, monkeypatch):
    dirs = _workdirs(src, tmp_path)
    out = _run_both(dirs, monkeypatch, lambda pkg, mod: mod.setup_ramses_ics(
        _scene(pkg, 2)))
    assert out["torch"] == out["jax"]
    for name in ("Merger_Config.txt", "halo1_prof.dat", "halo2_prof.dat",
                 "halo1_part.dat", "halo2_part.dat"):
        assert ((dirs["torch"] / name).read_bytes()
                == (dirs["jax"] / name).read_bytes()), name


def test_setup_arepo_and_resample_match_jax(src, tmp_path, monkeypatch):
    dirs = _workdirs(src, tmp_path)

    def run(pkg, mod):
        ics = _scene(pkg, 2)
        parts = mod.setup_arepo_ics(ics, BOX, 12, "arepo.h5")
        mod.resample_arepo_ics(ics, "arepo.h5", "arepo_rs.h5")
        return parts

    out = _run_both(dirs, monkeypatch, run)
    assert out["torch"].num_particles == out["jax"].num_particles
    for name in ("arepo.h5", "arepo_rs.h5"):
        _assert_h5_equal(str(dirs["torch"] / name), str(dirs["jax"] / name),
                         float32_ulp=True)
    with h5py.File(dirs["torch"] / "arepo.h5", "r") as f:
        assert f["Config"].attrs["VORONOI"] == 1
        assert f["Header"].attrs["NumPart_ThisFile"][0] > TOTALS["gas"]


def test_arepo_background_excludes_every_halo(src):
    """Background cells lie outside every halo (the AND of the per-halo
    outside masks), at the scene's lowest gas density, on the numpy
    grid's exact coordinates."""
    gas = tcg.ClusterParticles.from_file(str(src / "halo0_particles.h5"),
                                         ptypes=["gas"], device="cpu")
    nx = 16
    bg = TC._arepo_background(CENTERS, R_MAX, BOX, nx, gas)
    pos = bg["gas", "particle_position"].numpy()
    dx = BOX / nx
    ax = np.linspace(0.5 * dx, BOX - 0.5 * dx, nx)
    grid = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"),
                    axis=0).reshape(3, nx**3).T
    keep = np.ones(nx**3, dtype=bool)
    for c, rm in zip(CENTERS, R_MAX):
        keep &= ((grid - np.asarray(c)) ** 2).sum(axis=1) > rm**2
    np.testing.assert_array_equal(pos, grid[keep])
    assert 0 < len(pos) < nx**3
    for c, rm in zip(CENTERS, R_MAX):
        assert (np.linalg.norm(pos - np.asarray(c), axis=1) > rm).all()
    dmin = gas["gas", "density"].min()
    assert bool((bg["gas", "density"] == dmin).all())
    assert bool((bg["gas", "particle_mass"] == dmin * dx**3).all())
    assert not bool(bg["gas", "particle_velocity"].any())


def test_gamer_profile_naming_never_overwrites_source(src, tmp_path,
                                                      monkeypatch):
    """A profile named 'halo.hdf5' is not rewritten: the GAMER table goes
    to 'halo_gamer.hdf5'."""
    monkeypatch.chdir(tmp_path)
    shutil.copy(src / "prof.h5", tmp_path / "halo.hdf5")
    before = hashlib.sha256((tmp_path / "halo.hdf5").read_bytes()).digest()
    ics = tcg.ClusterICs("gamer_hdf5", 1, ["halo.hdf5"], [7000.0] * 3,
                         [0.0] * 3, num_particles={"dm": 500}, r_max=3000.0,
                         device="cpu")
    TC.setup_gamer_ics(ics)
    assert os.path.exists(tmp_path / "halo_gamer.hdf5")
    assert hashlib.sha256(
        (tmp_path / "halo.hdf5").read_bytes()).digest() == before


def test_stub_setups_and_names():
    assert TC.__all__ == JC.__all__
    ics = object()
    for name in ("setup_athena_ics", "setup_enzo_ics", "setup_gizmo_ics",
                 "setup_art_ics"):
        assert getattr(TC, name)(ics) is None
    for k in ("particle_position", "particle_velocity", "particle_mass",
              "density"):
        assert TC._cgs_factor(k) == JC._cgs_factor(k)
