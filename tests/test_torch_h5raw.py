"""The port's copy of the raw HDF5 I/O helpers (``core/h5raw.py``):
eligibility, fallbacks, bytes equal to what h5py writes, and files equal
to the JAX module's for the same calls."""

import os

import h5py
import numpy as np
import pytest

import cluster_generator_tpu.core.h5raw as JH
import cluster_generator_tpu_torch.core.h5raw as TH


def test_create_early_alloc_offset_and_dtype(tmp_path):
    with h5py.File(str(tmp_path / "a.h5"), "w") as f:
        d8 = TH.create_early_alloc(f, "x", (4, 8), "f8")
        d4 = TH.create_early_alloc(f, "y", (4, 8), "f4")
        assert d8.id.get_offset() is not None
        assert d4.id.get_offset() is not None
        assert d8.dtype == np.dtype("<f8") and d4.dtype == np.dtype("<f4")
        with pytest.raises(ValueError):
            TH.create_early_alloc(f, "z", (4,), "f2")


def test_rawslabio_roundtrip_and_accumulate(tmp_path):
    fn = str(tmp_path / "b.h5")
    rng = np.random.default_rng(7)
    a, b = rng.random((6, 5, 4)), rng.random((6, 5, 4))
    with h5py.File(fn, "a") as f:
        ds = TH.create_early_alloc(f, "x", a.shape, "f8")
        raw = TH.RawSlabIO(f, ds)
        assert raw.eligible
        raw.write(0, a[:3])
        raw.write(3, a[3:])
        raw.accumulate(2, b[2:5])
        raw.close()
    with h5py.File(fn) as f:
        got = f["x"][()]
    want = a.copy()
    want[2:5] += b[2:5]
    np.testing.assert_array_equal(got, want)


def test_rawslabio_ineligible_on_chunked_and_compressed(tmp_path):
    with h5py.File(str(tmp_path / "c.h5"), "a") as f:
        chunked = f.create_dataset("ch", (8, 4), dtype="f8", chunks=(2, 4))
        gz = f.create_dataset("gz", (8, 4), dtype="f8", chunks=(2, 4),
                              compression="gzip")
        i32 = f.create_dataset("i32", (8, 4), dtype="i4")
        late = f.create_dataset("late", (8, 4), dtype="f8")
        for ds in (chunked, gz, i32, late):
            assert not TH.RawSlabIO(f, ds).eligible


def _write(mod, fn, arrs, raw=True):
    with h5py.File(fn, "w") as f:
        g = f.create_group("g")
        if raw:
            w = mod.RawWriter(f)
            for k, v in arrs.items():
                w.add(g, k, v).attrs["units"] = "kpc"
            w.flush()
        else:
            for k, v in arrs.items():
                g.create_dataset(k, data=v).attrs["units"] = "kpc"


def test_rawwriter_matches_h5py_and_the_jax_module(tmp_path):
    """RawWriter's datasets read back as create_dataset's for f4, f8 and
    the integer fallback, and the port's file is byte for byte the JAX
    module's."""
    rng = np.random.default_rng(3)
    arrs = {"p32": rng.random((100, 3)).astype(np.float32),
            "p64": rng.random((50,)),
            "ids": np.arange(20, dtype=np.uint32)}
    ours, theirs, plain = (str(tmp_path / n) for n in
                           ("torch.h5", "jax.h5", "h5py.h5"))
    _write(TH, ours, arrs)
    _write(JH, theirs, arrs)
    _write(None, plain, arrs, raw=False)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    with h5py.File(ours) as a, h5py.File(plain) as b:
        for k in arrs:
            np.testing.assert_array_equal(a["g"][k][()], b["g"][k][()],
                                          err_msg=k)
            assert a["g"][k].dtype == b["g"][k].dtype, k
            assert a["g"][k].attrs["units"] == "kpc"


def test_pread_pwrite_all_loop_and_eof(tmp_path):
    fn = str(tmp_path / "plain.bin")
    a = np.arange(5000, dtype=np.float64)
    fd = os.open(fn, os.O_RDWR | os.O_CREAT)
    try:
        TH._pwrite_all(fd, a, 128)
        got = np.frombuffer(TH._pread_all(fd, a.nbytes, 128), dtype=a.dtype)
        np.testing.assert_array_equal(got, a)
        with pytest.raises(OSError, match="EOF"):
            TH._pread_all(fd, a.nbytes + 1, 128)
        with pytest.raises(OSError, match="EOF"):
            TH._pread_all(fd, 8, 128 + a.nbytes)
    finally:
        os.close(fd)


def test_rawwriter_empty_flush(tmp_path):
    with h5py.File(str(tmp_path / "e.h5"), "w") as f:
        TH.RawWriter(f).flush()


def test_read_slab_and_reader_match_h5py(tmp_path):
    fn = str(tmp_path / "s.h5")
    a = np.random.default_rng(1).random((10, 4, 3)).astype(np.float32)
    with h5py.File(fn, "w") as f:
        w = TH.RawWriter(f)
        w.add(f, "x", a)
        w.flush()
        f.create_dataset("ch", data=a.astype(np.float64), chunks=(2, 4, 3))
    with h5py.File(fn) as f:
        np.testing.assert_array_equal(TH.read_slab(f["x"], 2, 7), a[2:7])
        np.testing.assert_array_equal(TH.read_slab(f["x"], 0, 10), a)
        np.testing.assert_array_equal(TH.read_slab(f["ch"], 1, 4),
                                      a[1:4].astype(np.float64))
        np.testing.assert_array_equal(TH.read_slab(f["x"], 8, 14), a[8:])
        np.testing.assert_array_equal(TH.read_slab(f["ch"], 8, 14),
                                      a[8:].astype(np.float64))
        assert TH.read_slab(f["x"], 7, 7).shape == (0, 4, 3)
        with pytest.raises(ValueError, match="lo"):
            TH.read_slab(f["x"], -1, 2)
        for name in ("x", "ch"):
            with pytest.raises(ValueError, match="hi"):
                TH.read_slab(f[name], 0, -1)
        with TH.RawReader(f) as r:
            np.testing.assert_array_equal(r.read(f["x"]), a)
            np.testing.assert_array_equal(r.read(f["ch"]),
                                          a.astype(np.float64))


def test_raw_reads_see_buffered_h5py_writes(tmp_path):
    fn = str(tmp_path / "b.h5")
    a = np.arange(40, dtype=np.float64).reshape(10, 4)
    with h5py.File(fn, "w") as f:
        w = TH.RawWriter(f)
        d = w.add(f, "x", a)
        w.flush()
        d[3:5] = -a[3:5]  # through h5py, possibly buffered
        np.testing.assert_array_equal(TH.read_slab(d, 2, 6)[1:3], -a[3:5])
        r = TH.RawReader(f)
        np.testing.assert_array_equal(r.read(d)[3:5], -a[3:5])
        r.close()
