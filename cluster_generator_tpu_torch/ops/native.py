"""ctypes binding of the host C++ utilities in ``native/cg_native.cpp``.

The library is compiled at first use by the port's own command,
``g++ -O3 -std=c++17 -fPIC -pthread -Wall -shared`` (the flags of
``native/Makefile``; ``$CXX`` names another compiler), into
``build/native/libcg_native.so`` at the root of the checkout, and compiled
again when the source is newer than the library.  The build and the first
load hold an exclusive file lock, so that processes starting together
never load a half-written library.

Unlike the JAX package's binding, nothing here falls back to another
engine: a library that cannot be built raises, with the compiler's
output, since a quiet fallback would hide which engine the caller got.
:func:`available` says whether the library loads.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np
import torch

__all__ = ["available", "construct_chunks", "spline_eval",
           "paint_radial_chunks", "trilinear"]

NATIVE_SRC = Path(__file__).resolve().parents[2] / "native" / "cg_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-pthread", "-Wall", "-shared"]
_LIB_NAME = "libcg_native.so"
_lib = None


@contextlib.contextmanager
def _build_lock(build_dir: Path):
    """Exclusive lock serializing build and first load across processes."""
    import fcntl

    build_dir.mkdir(parents=True, exist_ok=True)
    fd = os.open(str(build_dir / ".build.lock"), os.O_CREAT | os.O_RDWR,
                 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        fcntl.flock(fd, fcntl.LOCK_UN)
        os.close(fd)


def _bind(lib):
    """Declare the signatures; AttributeError on a library that lacks a
    symbol."""
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")

    lib.cg_construct_chunks.restype = ctypes.c_int64
    lib.cg_construct_chunks.argtypes = [u32p, ctypes.c_uint32, u32p]
    lib.cg_spline_eval.restype = None
    lib.cg_spline_eval.argtypes = [f64p] * 5 + [ctypes.c_int64, f64p,
                                                ctypes.c_int64, f64p]
    lib.cg_paint_radial_chunks.restype = None
    lib.cg_paint_radial_chunks.argtypes = [f64p] * 5 + [
        ctypes.c_int64, i64p, ctypes.c_int64, ctypes.c_int64, f64p, f64p,
        f64p]
    lib.cg_trilinear.restype = None
    lib.cg_trilinear.argtypes = [f64p, ctypes.c_int64, f64p, ctypes.c_int64,
                                 f64p, ctypes.c_int64, f64p, f64p,
                                 ctypes.c_int64, f64p]


def _compile(src: Path, target: Path):
    """Compile ``src`` into ``target`` (through a temporary file and an
    atomic rename); raises RuntimeError with the compiler's output."""
    cxx = os.environ.get("CXX", "g++")
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx, *CXXFLAGS, "-o", str(tmp), str(src)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"cannot build {target.name}: {' '.join(cmd)} "
                           f"failed to run: {e}") from e
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"cannot build {target.name}: {' '.join(cmd)} "
                           f"exited {res.returncode}:\n{res.stderr}")
    os.replace(tmp, target)


def _load():
    """The bound library, built first when missing or older than its
    source.  Raises RuntimeError when it cannot be built or loaded."""
    global _lib
    if _lib is not None:
        return _lib
    if not NATIVE_SRC.exists():
        raise RuntimeError(f"native source {NATIVE_SRC} not found: the "
                           "native engine needs a checkout of the repo")
    target = BUILD_DIR / _LIB_NAME
    with _build_lock(BUILD_DIR):
        if (not target.exists()
                or target.stat().st_mtime < NATIVE_SRC.stat().st_mtime):
            _compile(NATIVE_SRC, target)
        try:
            lib = ctypes.CDLL(str(target))
            _bind(lib)
        except (OSError, AttributeError) as e:
            raise RuntimeError(f"cannot load {target}: {e}") from e
    _lib = lib
    return lib


def available() -> bool:
    """Whether the native library builds (if needed) and loads."""
    try:
        _load()
    except RuntimeError:
        return False
    return True


def _host64(a):
    """``a`` (a tensor on any device, an array or a sequence) as a
    C-contiguous float64 numpy array."""
    if isinstance(a, torch.Tensor):
        a = a.detach().to("cpu", torch.float64).numpy()
    return np.ascontiguousarray(a, dtype=np.float64)


def construct_chunks(domain_dimensions, chunksize: int) -> np.ndarray:
    """Chunkmap uint32[3, 2, N] (the same as
    ``data_structures.construct_chunks``)."""
    dd = np.ascontiguousarray(domain_dimensions, dtype=np.uint32)
    if dd.shape != (3,):
        raise ValueError(f"domain_dimensions must be 3 values, got "
                         f"shape {dd.shape}")  # C++ reads exactly dd[0..2]
    if int(chunksize) <= 0:  # the C++ code divides by it
        raise ValueError(f"chunksize must be positive, got {chunksize}")
    lib = _load()
    n = int(np.prod(dd // np.uint32(chunksize)))
    out = np.empty(3 * 2 * n, dtype=np.uint32)
    got = lib.cg_construct_chunks(dd, np.uint32(chunksize), out)
    if got != n:
        raise RuntimeError(f"native chunk count {got} != expected {n}")
    return out.reshape(3, 2, n)


def _spline_arrays(sp):
    """A 1-D :class:`~..core.interp.CubicSpline` as contiguous host f64
    arrays (knots, a, b, c, d)."""
    xs, a, b, c, d = (_host64(v) for v in (sp.x, sp.a, sp.b, sp.c, sp.d))
    if xs.ndim != 1:
        raise ValueError(f"spline knots must be 1-D, got shape {xs.shape}")
    if xs.size < 2:  # the C++ evaluators index interval 0 unconditionally
        raise ValueError("spline needs at least 2 knots")
    if any(v.shape != (xs.size - 1,) for v in (a, b, c, d)):
        raise ValueError("spline coefficients must have one value per "
                         "interval")
    return xs, a, b, c, d


def spline_eval(sp, q) -> np.ndarray:
    """Evaluate a CubicSpline at points ``q`` on the host (multithreaded);
    returns float64 numpy of ``q``'s shape."""
    xs, a, b, c, d = _spline_arrays(sp)
    q = _host64(q)
    lib = _load()
    out = np.empty(q.size, dtype=np.float64)
    lib.cg_spline_eval(xs, a, b, c, d, xs.size, q.ravel(), q.size, out)
    return out.reshape(q.shape)


def paint_radial_chunks(sp, starts, chunksize, deltas, left,
                        out=None) -> np.ndarray:
    """Evaluate a radial spline field on chunk cell centres.

    ``starts``: (N, 3) first-cell indices; returns (N, cs, cs, cs) blocks
    in the on-disk z-first layout ``block[k, j, i] = f(x_i, y_j, z_k)``,
    the radii clamped to the knots (as ``data_structures._paint_batch``).

    ``out``: optional preallocated (N, cs, cs, cs) f64 buffer.  A fresh
    ~100 MB allocation per batch costs first-touch page faults on every
    call, several times the paint at 512^3: a streaming caller allocates
    once and passes it back in."""
    xs, a, b, c, d = _spline_arrays(sp)
    if isinstance(starts, torch.Tensor):
        starts = starts.detach().cpu().numpy()
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    if starts.ndim != 2 or starts.shape[1] != 3:
        raise ValueError(f"starts must be (N, 3), got {starts.shape}")
    n = starts.shape[0]
    cs = int(chunksize)
    if cs <= 0:
        raise ValueError(f"chunksize must be positive, got {chunksize}")
    deltas, left = _host64(deltas), _host64(left)
    if deltas.shape != (3,) or left.shape != (3,):
        raise ValueError("deltas and left must be 3 values each")
    if out is None:
        out = np.empty((n, cs, cs, cs), dtype=np.float64)
    elif (not isinstance(out, np.ndarray) or out.dtype != np.float64
          or not out.flags.c_contiguous or out.shape != (n, cs, cs, cs)):
        # a real exception: an undersized buffer handed to the C++ painter
        # is heap corruption
        raise ValueError(
            f"out buffer must be C-contiguous f64 {(n, cs, cs, cs)}, got "
            f"{getattr(out, 'dtype', type(out))} "
            f"{getattr(out, 'shape', None)}")
    lib = _load()
    lib.cg_paint_radial_chunks(xs, a, b, c, d, xs.size, starts.ravel(), n,
                               cs, deltas, left, out.reshape(-1))
    return out


def trilinear(xs, ys, zs, field, pts) -> np.ndarray:
    """Trilinear sample of ``field`` (nx, ny, nz) on the axes ``xs``,
    ``ys``, ``zs`` at ``pts`` (N, 3); 0 outside the grid."""
    xs, ys, zs, field, pts = (_host64(v) for v in (xs, ys, zs, field, pts))
    if field.shape != (xs.size, ys.size, zs.size):
        raise ValueError(f"field shape {field.shape} != grid "
                         f"{(xs.size, ys.size, zs.size)}")
    if min(xs.size, ys.size, zs.size) < 2:
        raise ValueError("trilinear needs >= 2 coordinates per axis")
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"pts must be (N, 3), got {pts.shape}")
    lib = _load()
    out = np.empty(pts.shape[0], dtype=np.float64)
    lib.cg_trilinear(xs, xs.size, ys, ys.size, zs, zs.size, field.ravel(),
                     pts.ravel(), pts.shape[0], out)
    return out
