"""The plain reference of the random-field cell: a call's magnetic field B,
or its vector potential A, worked out again from the call's seed and the
rules the configuration file states, in plain PyTorch.

It shares with the port only the standard normals (one ``torch.randn`` draw
of shape ``(3, nx, ny, nz)`` from the call's generator; a test pins that
the port draws the same numbers) and the units.  Everything else is done
the plain way, as upstream's ``RandomMagneticField`` does it: full complex
transforms (``torch.fft.fftn`` / ``ifftn``) of whole components, with no
half spectra, no slabs and nothing in place; the rms normalisation and the
projection's power-preserving rescale summed over the grid in real space;
the vector potential the real part of a full complex inverse transform, so
the Nyquist planes need no rule of their own.

Precision (the controls of ``portbench/calibrate.py``): ``dt`` is the real
dtype of the whole field (float32: complex64 transforms); ``df_dt`` that of
the k-space arithmetic alone (the spectra are cast to it for the shaping,
the projection and the potential, and back for the transforms); ``pdt``
the dtype the handed-over components are rounded to.  The normals are
drawn in the configuration's dtype and cast, so every control transforms
the program's noise.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_COMPLEX = {torch.float32: torch.complex64, torch.float64: torch.complex128}


def _dtype(dt):
    """A torch dtype from a torch or numpy one."""
    if isinstance(dt, torch.dtype):
        return dt
    return {np.dtype(np.float32): torch.float32,
            np.dtype(np.float64): torch.float64}[np.dtype(dt)]


def grid(cfg):
    """``(dims, deltas)`` of the configuration's grid: the box cut into
    ``ddims`` cells a side, padded by ``2 ceil(padding ddims / 2)`` cells of
    the same width."""
    ddims = np.asarray(cfg["ddims"], dtype=int)
    width = (np.asarray(cfg["right_edge_kpc"], dtype=np.float64)
             - np.asarray(cfg["left_edge_kpc"], dtype=np.float64))
    deltas = width / ddims
    pad = (2 * np.ceil(0.5 * cfg["padding"] * ddims)).astype(int)
    return tuple(int(n) for n in ddims + pad), tuple(float(d) for d in deltas)


def noise(cfg, seed, device):
    """The call's normals: one ``(3, nx, ny, nz)`` draw in the
    configuration's dtype from a generator on ``device`` seeded with
    ``seed``."""
    dims, _ = grid(cfg)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return torch.randn((3,) + dims, dtype=getattr(
        torch, cfg["precision"]["field"]), device=device, generator=gen)


def field(cfg, vector_potential, seed, device, names, dt=None, df_dt=None,
          pdt=None):
    """The call's field: B, or A with ``vector_potential``, as
    ``{"field/<name>": float64 numpy array}`` for the three ``names``
    (x, y, z); ``dt``, ``df_dt``, ``pdt`` as in the module docstring."""
    base = getattr(torch, cfg["precision"]["field"])
    real = base if dt is None else _dtype(dt)
    kreal = real if df_dt is None else _dtype(df_dt)
    cplx, kcplx = _COMPLEX[real], _COMPLEX[kreal]
    dims, deltas = grid(cfg)

    def fwd(x):
        return torch.fft.fftn(x.to(cplx)).to(kcplx)

    def inv(w):
        return torch.fft.ifftn(w.to(cplx)).real

    def axis(i, values):
        shape = [1, 1, 1]
        shape[i] = -1
        return torch.as_tensor(values, dtype=torch.float64,
                               device=device).reshape(shape)

    # the wavenumbers and their finite-difference forms as upstream writes
    # them, in float64: at a Nyquist entry sin(k d) is a rounding residue
    # (~1e-16), which sets the projection's direction where two or three
    # axes are at their Nyquist entries and the rest at 0
    kn = [np.fft.fftfreq(n, d=d / (2.0 * np.pi))
          for n, d in zip(dims, deltas)]
    k = [axis(i, v) for i, v in enumerate(kn)]
    kk = torch.sqrt(k[0] ** 2 + k[1] ** 2 + k[2] ** 2)
    k0 = 2.0 * math.pi / cfg["l_min_kpc"]
    k1 = 2.0 * math.pi / cfg["l_max_kpc"]
    sigma = ((1.0 + (kk / k1) ** 2) ** (0.25 * cfg["alpha"])
             * torch.exp(-0.5 * (kk / k0) ** 2))
    sigma = torch.where(kk > 0, sigma, 0.0).to(kreal)
    del kk

    # the spectrum, then the rms over the grid
    g = [inv(fwd(n.to(real)) * sigma) for n in noise(cfg, seed, device)]
    del sigma
    rms = torch.sqrt(torch.mean(g[0] ** 2 + g[1] ** 2 + g[2] ** 2))
    g = [x * (cfg["B_rms_gauss"] / rms) for x in g]

    # the projection with the finite-difference wavenumbers, then the
    # rescale that keeps <|g|^2>
    p0 = sum(torch.sum(x ** 2) for x in g)
    kd = [axis(i, np.sin(v * d) / d).to(kreal)
          for i, (v, d) in enumerate(zip(kn, deltas))]
    norm = torch.sqrt(kd[0] ** 2 + kd[1] ** 2 + kd[2] ** 2)
    e = [torch.where(norm > 0, c / torch.where(norm > 0, norm, 1.0), 0.0)
         for c in kd]
    del norm
    W = [fwd(x) for x in g]
    dot = e[0] * W[0] + e[1] * W[1] + e[2] * W[2]
    g = [inv(w - c * dot) for w, c in zip(W, e)]
    del W, dot, e
    p2 = sum(torch.sum(x ** 2) for x in g)
    g = [x * torch.sqrt(p0 / p2) for x in g]

    if vector_potential:
        W = [fwd(x) for x in g]
        kr = [ki.to(kreal) for ki in k]
        k2 = kr[0] ** 2 + kr[1] ** 2 + kr[2] ** 2
        inv_k2 = torch.where(k2 > 0, 1.0 / torch.where(k2 > 0, k2, 1.0), 0.0)
        A = [1j * (kr[1] * W[2] - kr[2] * W[1]) * inv_k2,
             1j * (kr[2] * W[0] - kr[0] * W[2]) * inv_k2,
             1j * (kr[0] * W[1] - kr[1] * W[0]) * inv_k2]
        del W
        g = [inv(a) for a in A]
        del A
    if pdt is not None:
        g = [x.to(pdt).to(real) for x in g]
    return {f"field/{name}": x.to(torch.float64).cpu().numpy()
            for name, x in zip(names, g)}
