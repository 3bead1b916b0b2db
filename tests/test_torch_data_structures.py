"""The chunked yt grid of the PyTorch port (``data_structures.YTHDF5`` and
its painter) against the JAX package's, on the CPU at a small size.

One model file written by the JAX package is read by both packages
(``ClusterModel.from_h5_file(device="cpu")`` here), so both paint the same
arrays: on a non-cubic domain the painted fields agree within 1e-12 of
each field's largest value (f8) and to float32 rounding (f4); the chunkmap,
the attrs and the paint-config digest are identical; each package's
``YTHDF5.load`` reads the other's file, a second model accumulates onto
either, and ``resume`` repaints only unfinished fields.  The cases of
tests/test_data_structures.py are mirrored; the native engine's cases are
in tests/test_torch_native.py and tests/test_torch_cli.py.
"""

import h5py
import numpy as np
import pytest
import torch
from scipy.interpolate import CubicSpline

import cluster_generator_tpu as jcg
from cluster_generator_tpu import data_structures as JD
from cluster_generator_tpu_torch import ClusterICs, ClusterModel
from cluster_generator_tpu_torch import data_structures as TD
from cluster_generator_tpu_torch.core.h5raw import RawSlabIO
from cluster_generator_tpu_torch.core.interp import cubic_spline

torch.set_num_threads(1)

BBOX = np.array([[-2000.0, 2000.0]] * 3)
NC_DIMS = (32, 48, 64)  # non-cubic, unequal cell widths per axis
NC_BBOX = np.array([[-3000.0, 3000.0], [-12000.0, 12000.0], [0.0, 15000.0]])


@pytest.fixture(scope="module")
def model_file(tmp_path_factory):
    """The canonical cluster (beta = 100) built by the JAX package on a
    400-point grid and written to HDF5."""
    z, M200, conc, f_g = 0.1, 1.5e15, 4.0, 0.12
    r200 = float(jcg.find_overdensity_radius(M200, 200.0, z=z))
    a = r200 / conc
    M = float(jcg.snfw_total_mass(M200, r200, a))
    rhot = jcg.snfw_density_profile(M, a)
    Mt = jcg.snfw_mass_profile(M, a)
    r500, M500 = jcg.find_radius_mass(Mt, z=z, delta=500.0)
    rhog = jcg.rescale_profile_by_mass(
        jcg.vikhlinin_density_profile(1.0, 100.0, r200, 1.0, 0.67, 3),
        f_g * float(M500), float(r500))
    m = jcg.ClusterModel.from_dens_and_tden(0.1, 1e4, rhog, rhot,
                                            stellar_density=0.02 * rhot,
                                            num_points=400)
    m.set_magnetic_field_from_beta(100.0, gaussian=True)
    fn = str(tmp_path_factory.mktemp("model") / "model.h5")
    m.write_model_to_h5(fn)
    return fn


@pytest.fixture(scope="module")
def models(model_file):
    return (jcg.ClusterModel.from_h5_file(model_file),
            ClusterModel.from_h5_file(model_file, device="cpu"))


def _grid(fn):
    with h5py.File(fn) as f:
        return {k: f["grid"][k][()] for k in f["grid"]}


def _scipy_paint(model, dims, bbox, starts, cs=16, center=(0.0, 0.0, 0.0)):
    sp = CubicSpline(model["radius"].numpy(), model["density"].numpy(),
                     bc_type="not-a-knot")
    deltas = (bbox[:, 1] - bbox[:, 0]) / np.asarray(dims)
    idx = np.arange(cs)
    out = []
    for s in starts:
        x, y, z = (bbox[a, 0] - center[a] + (s[a] + idx + 0.5) * deltas[a]
                   for a in range(3))
        out.append(sp(np.sqrt(z[:, None, None] ** 2 + y[None, :, None] ** 2
                              + x[None, None, :] ** 2)))
    return out


# ------------------------------------------------------------------ schema
def test_construct_chunks_shape_and_tiling():
    cm = TD.construct_chunks((128, 128, 64), 32)
    assert cm.shape == (3, 2, 4 * 4 * 2) and cm.dtype == np.uint32
    assert ((cm[:, 1, :] - cm[:, 0, :]) == 32).all()
    assert cm[:, 0, :].min() == 0
    assert cm[0, 1, :].max() == 128 and cm[2, 1, :].max() == 64
    assert len(set(map(tuple, cm[:, 0, :].T.tolist()))) == cm.shape[-1]
    for dims, cs in (((128, 128, 64), 32), (NC_DIMS, 16), ((64,) * 3, 64)):
        np.testing.assert_array_equal(TD.construct_chunks(dims, cs),
                                      JD.construct_chunks(dims, cs))


def test_build_schema(tmp_path):
    fn = str(tmp_path / "grid.h5")
    ds = TD.YTHDF5.build(fn, (64, 64, 64), np.array([[-1000.0, 1000.0]] * 3),
                         chunksize=32)
    assert ds.chunksize == 32
    assert (np.asarray(ds.domain_dimensions) == 64).all()
    with h5py.File(fn) as f:
        assert set(f["grid"].keys()) == set(TD.YTHDF5._yt_fields)
        assert f["grid"]["density"].shape == (8, 32, 32, 32)
        assert f.attrs["model_count"] == 0
    with pytest.raises(IOError):
        TD.YTHDF5.build(fn, (64, 64, 64))
    with pytest.raises(ValueError, match="chunksize"):
        TD.YTHDF5.build(str(tmp_path / "g2.h5"), (100, 100, 100),
                        chunksize=64)
    with pytest.raises(ValueError, match="dtype"):
        TD.YTHDF5.build(str(tmp_path / "g3.h5"), (32, 32, 32), dtype="f2")
    with pytest.raises(FileNotFoundError):
        TD.YTHDF5.load(str(tmp_path / "missing.h5"))


# ------------------------------------------------------------------- paint
def test_add_model_paints_fields(models, tmp_path):
    _, tm = models
    fn = str(tmp_path / "grid.h5")
    ds = TD.YTHDF5.build(fn, (32, 32, 32), BBOX, chunksize=16)
    ds.add_model(tm, [0, 0, 0], [0.1, 0.0, 0.0])
    assert ds.model_count == 1
    g = _grid(fn)
    assert (g["density"] > 0).all() and (g["magnetic_pressure"] > 0).all()
    np.testing.assert_allclose(g["momentum_density_x"], g["density"] * 0.1,
                               rtol=1e-12)
    assert (g["momentum_density_y"] == 0).all()
    c = 3
    want, = _scipy_paint(tm, (32, 32, 32), BBOX, [ds.chunkmap[:, 0, c]])
    np.testing.assert_allclose(g["density"][c], want, rtol=1e-8)


def test_noncubic_domain_orientation(models, tmp_path):
    """block[k, j, i] = f(x_i, y_j, z_k), each axis with its own width."""
    _, tm = models
    fn = str(tmp_path / "nc.h5")
    dd = (64, 32, 32)
    bbox = np.array([[-3000.0, 3000.0], [-1000.0, 1000.0], [0.0, 1500.0]])
    ds = TD.YTHDF5.build(fn, dd, bbox, chunksize=16)
    ds.add_model(tm, [0, 0, 0], [0.0, 0.0, 0.0])
    dens = _grid(fn)["density"]
    picks = (0, 5, ds.chunkmap.shape[-1] - 1)
    for c, want in zip(picks, _scipy_paint(
            tm, dd, bbox, [ds.chunkmap[:, 0, c] for c in picks])):
        np.testing.assert_allclose(dens[c], want, rtol=1e-8, err_msg=str(c))


def test_painter_stream_and_clamped_corners(models):
    """The painter's generator yields every batch in order, each the batch
    painter's blocks; cells beyond the model's grid hold its boundary
    value, also in f4."""
    _, tm = models
    sp = cubic_spline(tm["radius"], tm["density"])
    dims = np.array([32, 32, 32])
    box = np.array([[-12000.0, 12000.0]] * 3)  # corners at 2.1e4 > r_max
    starts = TD.construct_chunks(dims, 16)[:, 0, :].T.astype(np.float64)
    deltas = (box[:, 1] - box[:, 0]) / dims
    got = list(TD._paint_blocks(sp, starts, deltas, box[:, 0], 16, batch=3))
    assert [i0 for i0, _ in got] == [0, 3, 6]
    blocks = np.concatenate([b for _, b in got])
    assert blocks.shape == (8, 16, 16, 16) and blocks.dtype == np.float64
    np.testing.assert_array_equal(
        blocks, TD._paint_batch(sp, starts, deltas, box[:, 0], 16).numpy())
    edge = float(TD._paint_batch(sp, starts[:1], deltas, box[:, 0], 1)[0, 0,
                                                                     0, 0])
    assert edge == pytest.approx(float(tm["density"][-1]), rel=1e-10)
    assert (blocks[0, 0, 0, 0] == edge) and (blocks[-1, -1, -1, -1] == edge)
    assert np.isfinite(blocks).all() and (blocks > 0).all()
    f4 = np.concatenate([b for _, b in TD._paint_blocks(
        sp, starts, deltas, box[:, 0], 16, batch=8, f32=True)])
    assert f4.dtype == np.float32
    np.testing.assert_array_equal(f4, blocks.astype(np.float32))


def test_create_dataset_end_to_end(models, tmp_path):
    _, tm = models
    fn = tm.create_dataset(str(tmp_path / "ds.h5"),
                           domain_dimensions=(32, 32, 32), chunksize=16)
    ds = TD.YTHDF5.load(fn)
    assert ds.model_count == 1
    np.testing.assert_array_equal(ds.bbox, [[-1e4, 1e4]] * 3)
    ds.survey_memory()
    # the host C++ painter writes the same grid
    fn_n = tm.create_dataset(str(tmp_path / "n.h5"), (32, 32, 32),
                             chunksize=16, engine="native")
    with h5py.File(fn) as f, h5py.File(fn_n) as g:
        assert sorted(f.attrs) == sorted(g.attrs)
        for k in f["grid"]:
            want = f["grid"][k][()]
            np.testing.assert_allclose(g["grid"][k][()], want, rtol=0,
                                       atol=1e-12 * np.abs(want).max(),
                                       err_msg=k)


def test_add_ics_matches_the_jax_package(model_file, tmp_path):
    """Both halos of a ClusterICs scene painted onto one grid, through
    ``add_ICs`` and ``ClusterICs.create_dataset``, as the JAX package
    paints them."""
    args = ("ds", 2, [model_file, model_file], [[-1000, 0, 0], [1000, 0, 0]],
            [[0.1, 0, 0], [-0.1, 0, 0]])
    kw = dict(num_particles={"dm": 100}, r_max=3000.0)
    t_ics = ClusterICs(*args, device="cpu", **kw)
    j_ics = jcg.ClusterICs(*args, **kw)
    box = np.array([[-4000.0, 4000.0]] * 3)
    fn = str(tmp_path / "ics_grid.h5")
    ds = TD.YTHDF5.build(fn, (32, 32, 32), box, chunksize=16)
    ds.add_ICs(t_ics)
    assert ds.model_count == 2
    t_fn = t_ics.create_dataset(str(tmp_path / "t.h5"), (32, 32, 32),
                                chunksize=16)
    j_fn = j_ics.create_dataset(str(tmp_path / "j.h5"), (32, 32, 32),
                                chunksize=16)
    np.testing.assert_array_equal(TD.YTHDF5.load(t_fn).bbox,
                                  [[-3000.0, 3000.0]] * 3)
    got, want = _grid(t_fn), _grid(j_fn)
    for k in want:
        scale = np.abs(want[k]).max()
        assert np.abs(got[k] - want[k]).max() <= 1e-12 * scale, k
    same = t_ics.create_dataset(str(tmp_path / "same.h5"), (32, 32, 32),
                                left_edge=box[:, 0], box_size=8000.0,
                                chunksize=16)
    np.testing.assert_array_equal(_grid(fn)["density"],
                                  _grid(same)["density"])


def test_raw_slab_io_matches_h5py_path(models, tmp_path, monkeypatch):
    """The pwrite path and the h5py fallback give identical files, the
    second model's read-modify-write included."""
    _, tm = models

    def build_and_add(fn):
        ds = TD.YTHDF5.build(fn, (32, 32, 32), BBOX, chunksize=16)
        ds.add_model(tm, [0, 0, 0], [0.1, 0, 0])
        ds.add_model(tm, [300.0, 0, 0], [-0.2, 0, 0])

    f_raw = str(tmp_path / "raw.h5")
    build_and_add(f_raw)
    orig_init = RawSlabIO.__init__

    def no_raw(self, fileio, dset):
        orig_init(self, fileio, dset)
        self.close()
        self.eligible = False

    monkeypatch.setattr(RawSlabIO, "__init__", no_raw)
    f_h5 = str(tmp_path / "h5.h5")
    build_and_add(f_h5)
    a, b = _grid(f_raw), _grid(f_h5)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_f4_dtype_option(models, tmp_path):
    _, tm = models
    f8, f4 = str(tmp_path / "f8.h5"), str(tmp_path / "f4.h5")
    ds8 = TD.YTHDF5.build(f8, (32, 32, 32), BBOX, chunksize=16)
    ds8.add_model(tm, [0, 0, 0], [0.1, 0, 0])
    ds4 = TD.YTHDF5.build(f4, (32, 32, 32), BBOX, chunksize=16, dtype="f4")
    ds4.add_model(tm, [0, 0, 0], [0.1, 0, 0])
    assert ds4._itemsize == 4 and ds8._itemsize == 8
    assert ds4._estimated_size == ds8._estimated_size / 2
    a, b = _grid(f8), _grid(f4)
    for k in a:
        assert b[k].dtype == np.dtype("<f4"), k
        np.testing.assert_allclose(b[k].astype(np.float64), a[k], rtol=2e-7,
                                   atol=0, err_msg=k)


def test_two_model_grid_is_sum_of_singles(models, tmp_path):
    _, tm = models
    adds = {"both": [([0, 0, 0], [0.1, 0, 0]), ([300.0, 0, 0], [0, -0.2, 0])],
            "a": [([0, 0, 0], [0.1, 0, 0])],
            "b": [([300.0, 0, 0], [0, -0.2, 0])]}
    grids = {}
    for tag, calls in adds.items():
        fn = str(tmp_path / f"{tag}.h5")
        ds = TD.YTHDF5.build(fn, (32, 32, 32), BBOX, chunksize=16)
        for ctr, vel in calls:
            ds.add_model(tm, ctr, vel)
        grids[tag] = _grid(fn)
    for k in grids["both"]:
        np.testing.assert_allclose(grids["both"][k],
                                   grids["a"][k] + grids["b"][k],
                                   rtol=1e-12, atol=1e-300, err_msg=k)


def test_add_model_resume_repaints_unfinished_fields(models, tmp_path):
    """A first paint cut after the density (and its momenta) resumes to the
    uninterrupted grid; another configuration, or a grid that already
    holds a model, refuses to resume."""
    _, tm = models
    ref_fn = str(tmp_path / "ref.h5")
    TD.YTHDF5.build(ref_fn, (32, 32, 32), BBOX, chunksize=16).add_model(
        tm, [0, 0, 0], [0.1, 0, 0])
    cut_fn = str(tmp_path / "cut.h5")
    TD.YTHDF5.build(cut_fn, (32, 32, 32), BBOX, chunksize=16).add_model(
        tm, [0, 0, 0], [0.1, 0, 0])
    keep = {"density", "momentum_density_x", "momentum_density_y",
            "momentum_density_z"}
    with h5py.File(cut_fn, "a") as f:
        f.attrs["_fields_done"] = sorted(keep)
        f.attrs["model_count"] = 0
        for field in f["grid"]:
            if field not in keep:
                f["grid"][field][...] = np.nan
    with pytest.raises(ValueError, match="different"):
        TD.YTHDF5.load(cut_fn).add_model(tm, [0, 0, 0], [0.2, 0, 0],
                                         resume=True)
    ds = TD.YTHDF5.load(cut_fn)
    ds.add_model(tm, [0, 0, 0], [0.1, 0, 0], resume=True)
    assert ds.model_count == 1
    a, b = _grid(ref_fn), _grid(cut_fn)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with pytest.raises(ValueError, match="FIRST model"):
        ds.add_model(tm, [0, 0, 0], [0.0, 0, 0], resume=True)


# ---------------------------------------------- files across the packages
@pytest.mark.parametrize("dtype", ["f8", "f4"])
def test_both_packages_paint_the_same_grid(models, tmp_path, dtype):
    jm, tm = models
    ctr, vel = [100.0, -200.0, 300.0], [0.1, 0.0, -0.2]
    assert TD._paint_config_digest(tm, ctr, vel) == \
        JD._paint_config_digest(jm, ctr, vel)
    files = {}
    for name, mod, m in (("jax", JD, jm), ("port", TD, tm)):
        fn = files[name] = str(tmp_path / f"{name}.h5")
        mod.YTHDF5.build(fn, NC_DIMS, NC_BBOX, chunksize=16,
                         dtype=dtype).add_model(m, ctr, vel)
    with h5py.File(files["jax"]) as a, h5py.File(files["port"]) as b:
        np.testing.assert_array_equal(a["chunks/chunkmap"][()],
                                      b["chunks/chunkmap"][()])
        assert set(a.attrs) == set(b.attrs)
        for k in a.attrs:
            np.testing.assert_array_equal(a.attrs[k], b.attrs[k], err_msg=k)
        for k in a["grid"]:
            x, y = a["grid"][k][()], b["grid"][k][()]
            assert x.dtype == y.dtype == np.dtype(f"<{dtype}"), k
            assert dict(a["grid"][k].attrs) == dict(b["grid"][k].attrs), k
            x, y = x.astype(np.float64), y.astype(np.float64)
            if dtype == "f8":
                assert np.abs(x - y).max() <= 1e-12 * np.abs(x).max(), k
            else:
                np.testing.assert_allclose(y, x, rtol=2 ** -23, atol=0,
                                           err_msg=k)


def test_each_package_loads_the_others_grid_and_accumulates(models,
                                                            tmp_path):
    """YTHDF5.load of the other package's file; a second model added by
    one package onto the other's grid equals the grid of both models from
    one package."""
    jm, tm = models
    first, second = ([0, 0, 0], [0.1, 0, 0]), ([300.0, 0, 0], [0, -0.2, 0])
    ref = str(tmp_path / "ref.h5")
    ds = JD.YTHDF5.build(ref, (32, 32, 32), BBOX, chunksize=16)
    ds.add_model(jm, *first)
    ds.add_model(jm, *second)
    for writer, reader, m1, m2 in ((JD, TD, jm, tm), (TD, JD, tm, jm)):
        fn = str(tmp_path / f"{writer.__name__.split('.')[0]}.h5")
        writer.YTHDF5.build(fn, (32, 32, 32), BBOX, chunksize=16).add_model(
            m1, *first)
        other = reader.YTHDF5.load(fn)
        assert other.model_count == 1 and other.chunksize == 16
        np.testing.assert_array_equal(other.domain_dimensions, [32] * 3)
        np.testing.assert_array_equal(other.bbox, BBOX)
        other.add_model(m2, *second)
        assert other.model_count == 2
        got, want = _grid(fn), _grid(ref)
        for k in want:
            assert np.abs(got[k] - want[k]).max() <= 1e-12 * np.abs(
                want[k]).max(), k


def test_magnetic_pressure_under_either_convention(model_file, tmp_path):
    """p_B = B^2 / (8 pi) (Gaussian) or B^2 / 2 (Lorentz-Heaviside), as the
    model's field was set, in both packages; the convention enters the
    paint-config digest."""
    out = {}
    for gaussian in (True, False):
        jm = jcg.ClusterModel.from_h5_file(model_file)
        tm = ClusterModel.from_h5_file(model_file, device="cpu")
        for m in (jm, tm):
            m.set_magnetic_field_from_beta(100.0, gaussian=gaussian)
        digest = TD._paint_config_digest(tm, [0] * 3, [0] * 3)
        tm.magnetic_gaussian = not gaussian
        assert TD._paint_config_digest(tm, [0] * 3, [0] * 3) != digest
        tm.magnetic_gaussian = gaussian
        for name, mod, m in (("jax", JD, jm), ("port", TD, tm)):
            fn = str(tmp_path / f"{name}{gaussian}.h5")
            mod.YTHDF5.build(fn, (32, 32, 32), BBOX, chunksize=16).add_model(
                m, [0] * 3, [0] * 3)
            out[name, gaussian] = _grid(fn)["magnetic_pressure"]
        x, y = out["jax", gaussian], out["port", gaussian]
        assert np.abs(x - y).max() <= 1e-12 * np.abs(x).max(), gaussian
    # the same pressure: the field strength differs by sqrt(4 pi)
    np.testing.assert_allclose(out["port", False], out["port", True],
                               rtol=1e-10)
