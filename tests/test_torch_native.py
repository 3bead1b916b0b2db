"""The port's ctypes binding of the host C++ utilities
(``cluster_generator_tpu_torch/ops/native.py`` over the unchanged
``native/cg_native.cpp``), the cases of tests/test_native.py: chunks equal
numpy and the JAX package's library; the native spline evaluation equals
the port's torch ``spline_eval`` within 1e-14 of the max; the native
painter equals the port's device painter (``data_structures._paint_batch``
on the CPU) within 1e-12 of the max; trilinear equals scipy within 1e-13;
the input guards raise before the C++ code sees a bad buffer; a library
older than its source is rebuilt; and a library that cannot be built
raises, with the compiler's output, everywhere the native engine is asked
for: there is no fallback.
"""

import os

import numpy as np
import pytest
import torch

from cluster_generator_tpu_torch import ClusterModel
from cluster_generator_tpu_torch import data_structures as TD
from cluster_generator_tpu_torch.core.interp import cubic_spline, spline_eval
from cluster_generator_tpu_torch.ops import native

torch.set_num_threads(1)


def _spline(n=300, fn=lambda x: 1.0 / x):
    x = torch.logspace(-1, 4, n, dtype=torch.float64)
    return cubic_spline(x, fn(x))


@pytest.fixture
def unbuilt(tmp_path, monkeypatch):
    """The binding pointed at an empty build directory, nothing loaded."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "_lib", None)
    return tmp_path / "native" / "libcg_native.so"


def test_construct_chunks_matches_numpy_and_the_jax_library():
    from cluster_generator_tpu import data_structures as JD
    from cluster_generator_tpu.ops import native as jnative

    for dims, cs in (((128, 128, 64), 32), ((32, 48, 64), 16)):
        cm = native.construct_chunks(dims, cs)
        counts = np.array(dims) // cs
        ii, jj, kk = np.meshgrid(*[np.arange(c) for c in counts],
                                 indexing="ij")
        starts = np.stack([ii.ravel(), jj.ravel(),
                           kk.ravel()]).astype(np.uint32) * cs
        ref = np.stack([starts, starts + cs], axis=1)
        assert cm.dtype == np.uint32
        np.testing.assert_array_equal(cm, ref)
        np.testing.assert_array_equal(TD.construct_chunks(dims, cs), cm)
        np.testing.assert_array_equal(JD.construct_chunks(dims, cs), cm)
        np.testing.assert_array_equal(jnative.construct_chunks(dims, cs), cm)


def test_spline_eval_matches_torch():
    sp = _spline(500, lambda x: torch.sin(x / 1000.0) + 1.0 / x)
    q = np.logspace(-1.2, 4.1, 50_000)  # extrapolates at both ends
    v_native = native.spline_eval(sp, q)
    v_torch = spline_eval(sp, torch.as_tensor(q)).numpy()
    assert v_native.shape == q.shape and v_native.dtype == np.float64
    assert np.abs(v_native - v_torch).max() < 1e-14 * np.abs(v_torch).max()
    # a tensor query, and a 2-D one, keep their shape
    q2 = torch.as_tensor(q[:1000].reshape(20, 50))
    np.testing.assert_array_equal(native.spline_eval(sp, q2),
                                  v_native[:1000].reshape(20, 50))


def test_paint_radial_chunks_matches_the_device_painter():
    sp = _spline()
    cs = 16
    # chunks at the centre, off-centre and in the far corner, whose outer
    # cells lie past the last knot (1e4), where both painters clamp to it
    starts = np.array([[0, 0, 0], [16, 16, 0], [48, 32, 16], [112, 112, 112]],
                      dtype=np.int64)
    deltas, left = np.array([60.0, 62.5, 65.0]), np.array([-960.0, -1000.0,
                                                           -1040.0])
    buf = np.empty((4, cs, cs, cs))
    blocks = native.paint_radial_chunks(sp, starts, cs, deltas, left,
                                        out=buf)
    assert blocks is buf
    want = TD._paint_batch(sp, starts.astype(np.float64), deltas, left,
                           cs).numpy()
    assert np.abs(blocks - want).max() <= 1e-12 * np.abs(want).max()
    edge = float(spline_eval(sp, sp.x[-1:])[0])
    assert blocks[3, -1, -1, -1] == pytest.approx(edge, rel=1e-14)
    # the z-first layout: block[k, j, i] = f(x_i, y_j, z_k)
    i, j, k = 3, 5, 7
    r = np.sqrt(((left + (starts[1] + [i, j, k] + 0.5) * deltas) ** 2).sum())
    assert blocks[1, k, j, i] == pytest.approx(
        float(spline_eval(sp, torch.tensor([r], dtype=torch.float64))[0]),
        rel=1e-12)


def test_trilinear_matches_scipy():
    from scipy.interpolate import RegularGridInterpolator

    rng = np.random.RandomState(0)
    xs = np.linspace(0, 1, 24)
    ys = np.linspace(-1, 1, 20)
    field = rng.rand(24, 20, 24)
    pts = rng.rand(5000, 3) * 1.2 - 0.1  # includes out-of-domain
    pts[:, 1] = pts[:, 1] * 2.0 - 1.0
    v_nat = native.trilinear(xs, ys, xs, torch.as_tensor(field), pts)
    ref = RegularGridInterpolator((xs, ys, xs), field, bounds_error=False,
                                  fill_value=0.0)(pts)
    assert np.abs(v_nat - ref).max() < 1e-13


def test_input_validation_guards():
    """Ill-shaped inputs raise real exceptions BEFORE the C++ code sees
    them (a bad buffer handed to ctypes is heap corruption)."""
    with pytest.raises(ValueError, match="3 values"):
        native.construct_chunks((128, 128), 32)
    with pytest.raises(ValueError, match="chunksize"):
        native.construct_chunks((128, 128, 128), 0)
    xs = np.linspace(0, 1, 8)
    with pytest.raises(ValueError, match="field shape"):
        native.trilinear(xs, xs, xs, np.zeros((8, 8, 7)), np.zeros((4, 3)))
    with pytest.raises(ValueError, match=">= 2 coordinates"):
        native.trilinear(np.zeros(1), xs, xs, np.zeros((1, 8, 8)),
                         np.zeros((4, 3)))
    with pytest.raises(ValueError, match="pts"):
        native.trilinear(xs, xs, xs, np.zeros((8, 8, 8)), np.zeros((4, 2)))
    sp = cubic_spline(torch.linspace(1.0, 2.0, 16, dtype=torch.float64),
                      torch.ones(16, dtype=torch.float64))
    starts = np.zeros((2, 3), dtype=np.int64)
    for bad in (np.empty((2, 4, 4, 3)), np.empty((2, 4, 4, 4), np.float32),
                np.empty((2, 4, 4, 8))[..., ::2]):
        with pytest.raises(ValueError, match="out buffer"):
            native.paint_radial_chunks(sp, starts, 4, np.ones(3),
                                       np.zeros(3), out=bad)
    with pytest.raises(ValueError, match="chunksize"):
        native.paint_radial_chunks(sp, starts, 0, np.ones(3), np.zeros(3))
    with pytest.raises(ValueError, match="starts"):
        native.paint_radial_chunks(sp, np.zeros((2, 2)), 4, np.ones(3),
                                   np.zeros(3))
    with pytest.raises(ValueError, match="at least 2 knots"):
        native.spline_eval(sp._replace(x=sp.x[:1]), np.ones(3))
    batched = cubic_spline(torch.ones(2, 1) * torch.linspace(
        1.0, 2.0, 16, dtype=torch.float64), torch.ones(2, 16,
                                                       dtype=torch.float64))
    with pytest.raises(ValueError, match="1-D"):
        native.spline_eval(batched, np.ones(3))


def test_stale_library_is_rebuilt_not_dlopened(unbuilt):
    """A library older than cg_native.cpp is rebuilt on first load: loading
    stale native code is how missing symbols and silently divergent
    kernels happen."""
    assert native.available()
    old = native.NATIVE_SRC.stat().st_mtime - 100.0
    os.utime(unbuilt, (old, old))
    native._lib = None
    assert native.available()
    assert unbuilt.stat().st_mtime > old, "not rebuilt"
    # a fresh library is loaded as it is, not rebuilt
    mtime = unbuilt.stat().st_mtime
    native._lib = None
    assert native.available() and unbuilt.stat().st_mtime == mtime


def test_no_library_raises_and_nothing_falls_back(unbuilt, monkeypatch,
                                                  tmp_path):
    sp = _spline()
    starts = np.zeros((1, 3), dtype=np.int64)
    # no compiler: every entry point raises, and available() says no
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    assert not native.available()
    for call in (lambda: native.construct_chunks((16, 16, 16), 8),
                 lambda: native.spline_eval(sp, np.ones(3)),
                 lambda: native.paint_radial_chunks(sp, starts, 4, np.ones(3),
                                                    np.zeros(3)),
                 lambda: native.trilinear(np.arange(2.0), np.arange(2.0),
                                          np.arange(2.0), np.zeros((2, 2, 2)),
                                          np.zeros((1, 3)))):
        with pytest.raises(RuntimeError, match="no-such-compiler"):
            call()
    assert not unbuilt.exists()
    # the grid writer asked for the native engine raises too: no quiet
    # switch to the device painter
    m = TD.YTHDF5.build(str(tmp_path / "g.h5"), (16, 16, 16),
                        np.array([[-1000.0, 1000.0]] * 3), chunksize=8)
    model = ClusterModel.from_arrays({"radius": sp.x, "density": 1.0 / sp.x},
                                     device="cpu")
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        m.add_model(model, [0.0] * 3, [0.0] * 3, engine="native")
    # a compiler error is raised with the compiler's own output
    monkeypatch.delenv("CXX")
    bad = tmp_path / "broken.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(native, "NATIVE_SRC", bad)
    with pytest.raises(RuntimeError, match="broken.cpp"):
        native.spline_eval(sp, np.ones(3))
