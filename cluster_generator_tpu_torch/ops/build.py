"""Build and load the hand-written CUDA kernels.

Each ``csrc/*.cu`` file has a plain C interface.  At first use it is
compiled by ``nvcc`` for ``sm_90a`` into ``build/kernels/`` at the root of
the checkout (named by a hash of the source and flags, so an edit
rebuilds) and loaded with ``ctypes``.  :func:`build_all` starts one
``nvcc`` per source at once; :func:`load_library` calls it for every
source the first time it meets one not built.  :func:`launch` calls a
kernel's C entry point on PyTorch's current stream.  The stage marks
(``stage_marks.cu``) sit in every program body, so every path on a card
needs ``nvcc``.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from ..core.compiled import count_launch

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "SMEM_OPTIN_BYTES",
           "nvcc_path", "build_all", "load_library", "entry_point", "launch"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
# no --use_fast_math: denormals are kept and divisions are IEEE
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

# The shared memory a block may opt in to on an H100
# (cudaDevAttrMaxSharedMemoryPerBlockOptin), which bounds the rows the
# kernels take; each C entry point queries its own card's limit again and
# refuses a launch that does not fit.
SMEM_OPTIN_BYTES = 232448

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on the PATH, or
    ``/usr/local/cuda/bin/nvcc``."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(on_path)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are compiled at first use")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _start(name: str):
    """Start compiling ``csrc/<name>.cu`` unless its library is built;
    returns ``(target, process or None, temporary output)``."""
    target = _target(name)
    if target.exists():
        return target, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return target, proc, tmp


def _finish(name: str, target: Path, proc, tmp: Path) -> None:
    if proc is None:
        return
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, target)  # atomic: concurrent builders never see half a file


def build_all(names=None) -> list[str]:
    """Compile every kernel source (or ``names``) in parallel; returns the
    names built."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    started = [(n, *_start(n)) for n in names]
    errors = []
    for n, target, proc, tmp in started:  # wait for every nvcc started
        try:
            _finish(n, target, proc, tmp)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return list(names)


def load_library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``.  The first load of
    a library not yet built builds every source at once, so a process
    pays one parallel ``nvcc`` pass whichever kernel it needs first."""
    lib = _LIBS.get(name)
    if lib is None:
        if not _target(name).exists():
            build_all()
        lib = ctypes.CDLL(str(_target(name)))
        _LIBS[name] = lib
    return lib


@functools.lru_cache(maxsize=None)
def entry_point(name: str, argtypes: tuple, entry: str | None = None):
    """``cg_<entry>`` (default ``cg_<name>``) of ``csrc/<name>.cu``, bound
    once: it takes ``argtypes`` and then a stream, and returns a
    ``cudaError_t``."""
    fn = getattr(load_library(name), f"cg_{entry or name}")
    fn.argtypes = list(argtypes) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch(kernel, name: str, argtypes: tuple, device: torch.device,
           *args, entry: str | None = None) -> None:
    """Run ``cg_<entry>(*args, stream)`` of ``csrc/<name>.cu`` (``entry``
    default ``name``) on ``device``'s current stream (the C functions
    launch on the current device), raise on a non-zero ``cudaError_t`` and
    count one launch of ``kernel``, the kernel's Python wrapper
    (:func:`..core.compiled.count_launch`)."""
    fn = entry_point(name, argtypes, entry)
    if device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry or name} kernel launch failed: "
                           f"cudaError_t {err}")
    count_launch(kernel)
