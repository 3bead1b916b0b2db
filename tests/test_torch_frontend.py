"""The port's yt frontend (``cluster_generator_tpu_torch/frontend``) against
the JAX package's, under the same yt stand-in (``tests/ytshim``), on grid
files written by either package: the cases of tests/test_frontend.py
(sniffing through ``yt.load``, parameters and code units, the hierarchy
from the chunkmap, hyperslab-batched fluid reads through grid.select,
region and sphere reads against the radial spline, chunk-cached reads,
derived fields, a two-model scene, an f4 grid, the grid's mu), and cross
reads: the JAX frontend reads a port-written grid and the port's frontend
a JAX-written one, cell for cell.

Both frontends register the same dataset type, so while both are loaded
``yt.load`` is ambiguous: there the Dataset classes are instantiated
directly, and the shim's registries are saved and restored around the
JAX frontend's import (as test_frontend.py's ``ref_frontend`` fixture
does).  Values: a grid painted by either package from the same model
arrays agrees within 1e-12 of the field's max; reads of one file through
either frontend are bit-identical; reads match a scipy spline of the
model at the cell centres to rtol 1e-7 (f8) or 3e-6 (f4).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch
from scipy.interpolate import CubicSpline

from cluster_generator_tpu_torch.convert import cluster_model_from_numpy

torch.set_num_threads(1)

_SHIM = os.path.join(os.path.dirname(__file__), "ytshim")
_FLUID = "cluster_generator"
_PORT = "cluster_generator_tpu_torch.frontend"
_JAX = "cluster_generator_tpu.frontend"


def _purge(*prefixes):
    return {k: sys.modules.pop(k) for k in list(sys.modules)
            if k == "yt" or k.startswith("yt.")
            or any(k == p or k.startswith(p + ".") for p in prefixes)}


@pytest.fixture(scope="module")
def yt_frontend():
    """The shim's yt and the port's frontend, freshly imported."""
    saved_path = list(sys.path)
    saved_mods = _purge(_PORT, _JAX)
    sys.path.insert(0, _SHIM)
    try:
        import yt

        import cluster_generator_tpu_torch.frontend as fe

        assert fe._HAS_YT, "shim yt not picked up"
        yield yt, fe
    finally:
        sys.path[:] = saved_path
        _purge(_PORT, _JAX)
        sys.modules.update(saved_mods)


@pytest.fixture()
def jax_frontend(yt_frontend):
    """The JAX package's frontend imported beside the port's; restores
    the shim's registries and modules afterwards."""
    import importlib

    from yt.data_objects.static_output import _dataset_registry
    from yt.utilities.io_handler import io_registry

    saved_io = dict(io_registry)
    saved_reg = list(_dataset_registry)
    saved = {k: sys.modules.pop(k) for k in list(sys.modules)
             if k == _JAX or k.startswith(_JAX + ".")}
    try:
        yield importlib.import_module(_JAX)
    finally:
        for k in list(sys.modules):
            if k == _JAX or k.startswith(_JAX + "."):
                sys.modules.pop(k)
        sys.modules.update(saved)
        io_registry.clear()
        io_registry.update(saved_io)
        _dataset_registry[:] = saved_reg


@pytest.fixture(scope="module")
def port_model(canonical_model):
    """The JAX canonical model's arrays as a port model on the CPU."""
    return cluster_model_from_numpy(canonical_model.fields, device="cpu")


@pytest.fixture(scope="module")
def grid_file(port_model, tmp_path_factory):
    """A 32^3 / chunksize-16 grid painted by the port (8 chunks -> 8
    grids)."""
    fn = str(tmp_path_factory.mktemp("frontend") / "grid.h5")
    port_model.create_dataset(fn, domain_dimensions=(32, 32, 32),
                              chunksize=16, left_edge=[-2000.0] * 3,
                              box_size=[4000.0] * 3)
    return fn


@pytest.fixture(scope="module")
def jax_grid_file(canonical_model, tmp_path_factory):
    """The same grid painted by the JAX package."""
    fn = str(tmp_path_factory.mktemp("frontend_jax") / "grid.h5")
    canonical_model.create_dataset(fn, domain_dimensions=(32, 32, 32),
                                   chunksize=16, left_edge=[-2000.0] * 3,
                                   box_size=[4000.0] * 3)
    return fn


def _spline(model, field="density"):
    return CubicSpline(np.asarray(model["radius"]),
                       np.asarray(model[field]), bc_type="not-a-knot")


def _all(index, io=None):
    """Every cell of every grid through ``io`` (default the index's)."""
    from yt.geometry.selection_routines import AlwaysSelector

    grids = list(index.grids)
    size = sum(int(np.prod(g.ActiveDimensions)) for g in grids)
    fields = [(_FLUID, "density"), (_FLUID, "momentum_density_x"),
              (_FLUID, "pressure")]
    out = (io or index.io)._read_fluid_selection(
        iter([type("C", (), {"objs": grids})()]), AlwaysSelector(), fields,
        size)
    centers = np.concatenate(
        [g.icoords_centers().reshape(-1, 3) for g in grids])
    return out, centers


def test_yt_load_sniffs_and_parses(yt_frontend, grid_file):
    yt, fe = yt_frontend
    ds = yt.load(grid_file)
    assert isinstance(ds, fe.ClusterGeneratorDataset)
    assert ds._is_valid(grid_file)
    assert not ds._is_valid(grid_file + ".txt")
    assert _FLUID in ds.fluid_types
    np.testing.assert_array_equal(ds.domain_dimensions, [32, 32, 32])
    np.testing.assert_allclose(ds.domain_left_edge, [-2000.0] * 3)
    np.testing.assert_allclose(ds.domain_right_edge, [2000.0] * 3)
    assert ds.parameters["chunksize"] == 16
    assert float(ds.length_unit) == 1.0 and ds.length_unit.units == "kpc"
    assert ds.mass_unit.units == "Msun"
    ds.close()


def test_hierarchy_matches_chunkmap(yt_frontend, grid_file):
    import h5py

    yt, fe = yt_frontend
    ds = yt.load(grid_file)
    index = ds.index
    with h5py.File(grid_file, "r") as f:
        cm = f["chunks"]["chunkmap"][:]
        disk_fields = set(f["grid"].keys())
    assert index.num_grids == cm.shape[-1] == 8
    assert {fname for _, fname in index.field_list} == disk_fields
    assert all(ftype == _FLUID for ftype, _ in index.field_list)
    dx = 4000.0 / 32
    np.testing.assert_allclose(index.grid_left_edge,
                               cm[:, 0, :].T * dx - 2000.0)
    np.testing.assert_allclose(index.grid_right_edge,
                               cm[:, 1, :].T * dx - 2000.0)
    assert (index.grid_dimensions == 16).all()
    for g in index.grids:
        np.testing.assert_allclose(g.dds, dx)
        assert g.Level == 0
    ds.close()


def test_fluid_read_roundtrip(yt_frontend, grid_file):
    """An all-selector read through the IO handler reproduces the raw
    chunk rows bit for bit, in grid order, x-first."""
    import h5py

    from yt.geometry.selection_routines import AlwaysSelector

    yt, fe = yt_frontend
    ds = yt.load(grid_file)
    index = ds.index
    out, _ = _all(index)
    with h5py.File(grid_file, "r") as f:
        for name in ("density", "momentum_density_x", "pressure"):
            raw = f["grid"][name][:].transpose(0, 3, 2, 1)
            np.testing.assert_array_equal(out[_FLUID, name], raw.ravel())
    grids = list(index.grids)
    with pytest.raises(NotImplementedError):
        index.io._read_fluid_selection(
            iter([type("C", (), {"objs": grids})()]), AlwaysSelector(),
            [("enzo", "Density")], 16)
    ds.close()


def test_region_read_is_radially_consistent(yt_frontend, grid_file,
                                            canonical_model):
    from yt.geometry.selection_routines import RegionSelector

    yt, fe = yt_frontend
    ds = yt.load(grid_file)
    grids = list(ds.index.grids)
    sel = RegionSelector([-2000.0, -500.0, 0.0], [500.0, 2000.0, 1750.0])
    size = sum(g.count(sel) for g in grids)
    assert 0 < size < 32**3
    out = ds.index.io._read_fluid_selection(
        iter([type("C", (), {"objs": grids})()]), sel,
        [(_FLUID, "density")], size)
    centers = np.concatenate([
        g.icoords_centers()[sel.fill_mask(g)] for g in grids])
    np.testing.assert_allclose(
        out[_FLUID, "density"],
        _spline(canonical_model)(np.linalg.norm(centers, axis=1)),
        rtol=1e-7)
    ds.close()


def test_chunk_cache_read(yt_frontend, grid_file):
    import h5py

    yt, fe = yt_frontend
    ds = yt.load(grid_file)
    grids = list(ds.index.grids)[2:5]  # a consecutive run
    gap = [list(ds.index.grids)[i] for i in (0, 6)]  # two runs
    with h5py.File(grid_file, "r") as f:
        raw = f["grid"]["pressure"][:].transpose(0, 3, 2, 1)
    for objs in (grids, gap):
        out = ds.index.io._read_chunk_data(type("C", (), {"objs": objs})(),
                                           [(_FLUID, "pressure")])
        for g in objs:
            np.testing.assert_array_equal(out[g.id][_FLUID, "pressure"],
                                          raw[g.id])
    ds.close()


def test_derived_fields(yt_frontend, grid_file):
    import h5py

    from yt.utilities.physical_constants import kboltz, mh

    yt, fe = yt_frontend
    ds = yt.load(grid_file)
    ds.index  # noqa: B018  (creates the field info)
    fi = ds.field_info
    assert (_FLUID, "density") in fi
    assert ("gas", "velocity_x") in fi and ("gas", "temperature") in fi
    with h5py.File(grid_file, "r") as f:
        data = {(_FLUID, k): f["grid"][k][0]
                for k in ("density", "momentum_density_x", "pressure")}

    class Data(dict):
        pass

    d = Data(data)
    d.ds = ds
    vx = fi[_FLUID, "velocity_x"].function(None, d)
    np.testing.assert_allclose(
        vx, data[_FLUID, "momentum_density_x"] / data[_FLUID, "density"])
    d[(_FLUID, "velocity_x")] = vx
    for ftype in ("gas", "dark_matter", "stellar"):
        assert fi[ftype, "velocity_x"].alias_of == (_FLUID, "velocity_x")
    np.testing.assert_array_equal(fi["gas", "velocity_x"].function(None, d),
                                  vx)
    d[("gas", "pressure")] = data[_FLUID, "pressure"]
    d[("gas", "density")] = data[_FLUID, "density"]
    temp = fi["gas", "temperature"].function(None, d)
    np.testing.assert_allclose(temp, data[_FLUID, "pressure"]
                               / data[_FLUID, "density"] * ds.mu * mh
                               / kboltz)
    assert (temp > 0).all()
    eth = fi["gas", "specific_thermal_energy"].function(None, d)
    np.testing.assert_allclose(
        eth, 1.5 * data[_FLUID, "pressure"] / data[_FLUID, "density"])
    ds.close()


def test_jax_frontend_reads_a_port_grid(yt_frontend, jax_frontend, grid_file,
                                        jax_grid_file):
    """The JAX frontend's classes on the port's file and the port's on the
    same file read the same grids, edges and cells bit for bit; the port's
    file holds the JAX package's cells for the same model within 1e-12 of
    each field's max."""
    yt, fe = yt_frontend
    jfe = jax_frontend
    assert jfe.ClusterGeneratorDataset._is_valid(grid_file)
    jds = jfe.ClusterGeneratorDataset(grid_file)
    ours = fe.ClusterGeneratorDataset(grid_file)
    np.testing.assert_array_equal(jds.domain_dimensions,
                                  ours.domain_dimensions)
    ji, oi = jds.index, ours.index
    assert ji.num_grids == oi.num_grids == 8
    assert sorted(ji.field_list) == sorted(oi.field_list)
    np.testing.assert_array_equal(ji.grid_left_edge, oi.grid_left_edge)
    np.testing.assert_array_equal(ji.grid_right_edge, oi.grid_right_edge)
    # the JAX IO handler was registered over the port's on import: give
    # each index its own package's handler
    got, c1 = _all(ji, jfe.ClusterGeneratorIOHandler(jds))
    mine, c2 = _all(oi, fe.ClusterGeneratorIOHandler(ours))
    np.testing.assert_array_equal(c1, c2)
    for k in got:
        np.testing.assert_array_equal(got[k], mine[k])
    theirs = fe.ClusterGeneratorDataset(jax_grid_file)
    want, _ = _all(theirs.index, fe.ClusterGeneratorIOHandler(theirs))
    for k in want:
        np.testing.assert_allclose(mine[k], want[k], rtol=0,
                                   atol=1e-12 * np.abs(want[k]).max())
    for ds in (jds, ours, theirs):
        ds.close()


def test_port_frontend_reads_a_jax_grid(yt_frontend, jax_frontend,
                                        jax_grid_file, canonical_model):
    yt, fe = yt_frontend
    jfe = jax_frontend
    assert fe.ClusterGeneratorDataset._is_valid(jax_grid_file)
    ours = fe.ClusterGeneratorDataset(jax_grid_file)
    jds = jfe.ClusterGeneratorDataset(jax_grid_file)
    mine, centers = _all(ours.index, fe.ClusterGeneratorIOHandler(ours))
    got, _ = _all(jds.index, jfe.ClusterGeneratorIOHandler(jds))
    for k in got:
        np.testing.assert_array_equal(mine[k], got[k])
    np.testing.assert_allclose(
        mine[_FLUID, "density"],
        _spline(canonical_model)(np.linalg.norm(centers, axis=1)),
        rtol=1e-7)
    # the chunk cache of the port's handler on the JAX file
    objs = list(ours.index.grids)[1:3]
    rc = ours.index.io._read_chunk_data(type("C", (), {"objs": objs})(),
                                        [(_FLUID, "pressure")])
    jc = jds.index.io._read_chunk_data(
        type("C", (), {"objs": list(jds.index.grids)[1:3]})(),
        [(_FLUID, "pressure")])
    for g in objs:
        np.testing.assert_array_equal(rc[g.id][_FLUID, "pressure"],
                                      jc[g.id][_FLUID, "pressure"])
    ours.close()
    jds.close()


def test_sphere_read_is_radially_consistent(yt_frontend, grid_file,
                                            canonical_model):
    from yt.geometry.selection_routines import SphereSelector

    yt, fe = yt_frontend
    ds = yt.load(grid_file)
    grids = list(ds.index.grids)
    sel = SphereSelector([250.0, -250.0, 0.0], 900.0)
    size = sum(g.count(sel) for g in grids)
    assert 0 < size < 32**3
    out = ds.index.io._read_fluid_selection(
        iter([type("C", (), {"objs": grids})()]), sel,
        [(_FLUID, "density")], size)
    assert out[_FLUID, "density"].shape == (size,)
    centers = np.concatenate([
        g.icoords_centers()[sel.fill_mask(g)] for g in grids])
    assert (np.linalg.norm(centers - [250.0, -250.0, 0.0],
                           axis=1) <= 900.0).all()
    np.testing.assert_allclose(
        out[_FLUID, "density"],
        _spline(canonical_model)(np.linalg.norm(centers, axis=1)),
        rtol=1e-7)
    ds.close()


def test_two_model_scene_read(yt_frontend, port_model, canonical_model,
                              tmp_path):
    """Two halos painted onto one grid, the second by the native engine,
    read back as the SUM of the two radial profiles."""
    from cluster_generator_tpu_torch.data_structures import YTHDF5

    yt, fe = yt_frontend
    fn = str(tmp_path / "scene.h5")
    ds_w = YTHDF5.build(fn, (32, 32, 32), np.array([[-4000.0, 4000.0]] * 3),
                        chunksize=16)
    c1, c2 = [-1500.0, 0.0, 0.0], [1500.0, 0.0, 0.0]
    ds_w.add_model(port_model, c1, [0.0, 0.0, 0.0])
    ds_w.add_model(port_model, c2, [0.0, 0.0, 0.0], engine="native")
    ds = fe.ClusterGeneratorDataset(fn)
    out, centers = _all(ds.index)
    sp = _spline(canonical_model)
    expect = (sp(np.linalg.norm(centers - c1, axis=1))
              + sp(np.linalg.norm(centers - c2, axis=1)))
    np.testing.assert_allclose(out[_FLUID, "density"], expect, rtol=1e-7)
    ds.close()


def test_f4_grid_reads_both_frontends(yt_frontend, jax_frontend, port_model,
                                      canonical_model, tmp_path):
    yt, fe = yt_frontend
    jfe = jax_frontend
    fn = str(tmp_path / "grid_f4.h5")
    port_model.create_dataset(fn, domain_dimensions=(32, 32, 32),
                              chunksize=16, left_edge=[-2000.0] * 3,
                              box_size=[4000.0] * 3, dtype="f4")
    sp = _spline(canonical_model)
    reads = []
    for pkg in (fe, jfe):
        ds = pkg.ClusterGeneratorDataset(fn)
        out, centers = _all(ds.index, pkg.ClusterGeneratorIOHandler(ds))
        np.testing.assert_allclose(out[_FLUID, "density"],
                                   sp(np.linalg.norm(centers, axis=1)),
                                   rtol=3e-6)
        reads.append(out[_FLUID, "density"])
        ds.close()
    np.testing.assert_array_equal(*reads)


def test_grid_mu_attr_matches_model_temperature_convention(yt_frontend,
                                                           grid_file):
    """The grid's mu (which the yt temperature multiplies by) is the MEAN
    molecular weight of the models' own temperature, not mu_e."""
    from cluster_generator_tpu_torch.core import constants as C

    yt, fe = yt_frontend
    ds = yt.load(grid_file)
    assert float(ds.mu) == pytest.approx(C.mu)
    assert float(ds.mu) != pytest.approx(C.mue)
    ds.close()


def test_frontend_without_yt_raises_import_error():
    """Without yt the subpackage imports, and any of its names raises an
    ImportError that names the dependency."""
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys\n"
        "sys.modules['yt'] = None\n"
        "import cluster_generator_tpu_torch.frontend as fe\n"
        "assert not fe._HAS_YT and fe.__all__ == []\n"
        "try:\n"
        "    fe.ClusterGeneratorDataset\n"
        "except ImportError as e:\n"
        "    assert \"'yt'\" in str(e), e\n"
        "else:\n"
        "    raise AssertionError('no ImportError')\n"
        "print('NO-YT OK')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         env=dict(os.environ, PYTHONPATH=root),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "NO-YT OK" in out.stdout
