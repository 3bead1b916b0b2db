"""The constant-rms random field's k-space stage, in place on its spectra.

Between the forward and the inverse transforms of
:func:`..fields.grf._constant_rms_field`: the spectrum's shaping, the rms
normalisation, the divergence projection with its power-preserving rescale
and the vector potential, on the three ``(nx, ny, nz // 2 + 1)`` half
spectra of the noise.  :func:`grf_kspace` launches the hand-written
kernel ``csrc/grf_kspace.cu`` on CUDA tensors (two passes, the power sum
and then the spectra scaled in place, one C call).  The field program
chooses by the device: on the CPU it runs ``fields.grf._kspace``, the
same stage as torch arithmetic slab by slab along x, which is the plain
twin the kernel is held against.  The kernel replaces no TPU kernel; the
source note in the ``.cu`` file gives why it was added, its design and its
bound.

The launch goes on PyTorch's current stream, so inside a captured program
(:mod:`..core.compiled`) it is recorded into the graph;
``grf_kspace.launches`` counts the launches the card runs, a replay adding
the nodes of its graph.
"""

from __future__ import annotations

import ctypes

import torch

from .build import launch

__all__ = ["grf_kspace"]

# the C entry point's arguments before the stream: the three spectra, the
# wave vector, k0, k1, alpha, g_rms, the partial sums; their room, nx, ny,
# nz, float32, div_clean, vec_pot
ARGTYPES = (ctypes.c_void_p,) * 9 + (ctypes.c_int,) * 7

# room for the first pass's partial sums, one a block: more than the
# blocks a card holds at once (132 SMs x 8 blocks of 256 on an H100)
_PARTIALS = 4096

_COMPLEX = {torch.float64: torch.complex128, torch.float32: torch.complex64}


def _check(W, waves, shape, dtype):
    """Raises on spectra or a wave vector the stage does not take."""
    if dtype not in _COMPLEX:
        raise TypeError(f"grf_kspace: dtype must be torch.float64 or "
                        f"torch.float32, got {dtype}")
    nx, ny, nz = (int(n) for n in shape)
    nzh = nz // 2 + 1
    if len(W) != 3:
        raise ValueError(f"grf_kspace: three spectra expected, got {len(W)}")
    named = [(f"W[{c}]", w) for c, w in enumerate(W)] + [("waves", waves)]
    for name, t in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"grf_kspace: {name} must be a torch.Tensor")
        if t.device != waves.device:
            raise ValueError(f"grf_kspace: {name} is on {t.device}, waves on "
                             f"{waves.device}")
        if not t.is_contiguous():
            raise ValueError(f"grf_kspace: {name} must be contiguous")
    for name, w in named[:3]:
        if w.dtype != _COMPLEX[dtype]:
            raise TypeError(f"grf_kspace: {name} must be {_COMPLEX[dtype]} "
                            f"for a {dtype} field, got {w.dtype}")
        if tuple(w.shape) != (nx, ny, nzh):
            raise ValueError(f"grf_kspace: {name} must be shaped "
                             f"{(nx, ny, nzh)}, got {tuple(w.shape)}")
    if waves.dtype != torch.float64 or tuple(waves.shape) != (
            3 * (nx + ny + nzh) + nzh,):
        raise ValueError(f"grf_kspace: waves must be the float64 wave vector "
                         f"of {(nx, ny, nz)}, got {waves.dtype} "
                         f"{tuple(waves.shape)}")


def _scalar(name, v, device):
    """``v``, a float input of the kernel; raises unless it is one float64
    on ``device`` (a program lifts its floats to such tensors)."""
    if not (isinstance(v, torch.Tensor) and v.dtype == torch.float64
            and v.numel() == 1 and v.device == device):
        raise ValueError(f"grf_kspace: {name} must be one float64 on "
                         f"{device}, got {v!r}")
    return v


def grf_kspace(W, waves, k0, k1, alpha, g_rms, shape, dtype, div_clean,
               vec_pot):
    """The k-space stage of a constant-rms field of ``shape`` (nx, ny, nz)
    and real ``dtype``, in place on ``W``, its three contiguous
    (nx, ny, nz // 2 + 1) half spectra (complex128 for float64, complex64
    for float32): shaped by the spectrum of ``k0``, ``k1`` and ``alpha``,
    scaled to the rms ``g_rms``, projected onto the divergence-free part
    with the power kept (``div_clean``) and replaced by the vector
    potential (``vec_pot``).  ``waves``: ``fields.grf._wave_vector``'s
    float64 array on the spectra's device.

    The tensors are CUDA tensors, the floats one-element float64 tensors
    on the card, as a program lifts them (``grf_kspace.launches`` counts
    the launches on the card, a graph's on each replay).  Any other device
    raises, as do spectra of another dtype or shape, non-contiguous
    spectra and tensors on two devices."""
    _check(W, waves, shape, dtype)
    dev = waves.device
    if dev.type != "cuda":
        raise ValueError(f"grf_kspace: unsupported device {dev}")
    floats = [_scalar(name, v, dev) for name, v in
              (("k0", k0), ("k1", k1), ("alpha", alpha), ("g_rms", g_rms))]
    partials = torch.empty(_PARTIALS, dtype=torch.float64, device=dev)
    nx, ny, nz = (int(n) for n in shape)
    launch(grf_kspace, "grf_kspace", ARGTYPES, dev,
           *(t.data_ptr() for t in (*W, waves, *floats, partials)),
           _PARTIALS, nx, ny, nz, int(dtype == torch.float32),
           int(bool(div_clean)), int(bool(vec_pot)))


grf_kspace.launches = 0
