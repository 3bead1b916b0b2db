"""Grid-sharded Gaussian random fields.

Scales the random-field generator (``fields/grf.py``) past one card's
memory: the grid is slab-sharded over one mesh dim, the FFTs run as pencil
decompositions (``parallel/fft.py``), and the k-space work (spectrum
shaping, finite-difference divergence projection) is elementwise on each
rank's Y-slab of the spectra, with no communication.  Each rank builds only
its Y-slab of the wavenumbers and of sigma(k), in chunks along X, so that
no rank holds a full-grid temporary beside the three spectra.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..fields.grf import _div_clean_k, _spectrum_sigma
from .fft import _bwd_local, _check_split, _fwd_local
from .mesh import _mix, mesh_device, sharded

__all__ = ["sharded_gaussian_random_field"]

# k-space entries per chunk of the shaping and projection pass
_CHUNK = 1 << 24


def _waves(n, deltas):
    kx = np.fft.fftfreq(n[0], d=deltas[0] / (2 * np.pi))[:, None, None]
    ky = np.fft.fftfreq(n[1], d=deltas[1] / (2 * np.pi))[None, :, None]
    kz = np.fft.fftfreq(n[2], d=deltas[2] / (2 * np.pi))[None, None, :]
    return kx, ky, kz


def _plane_noise(seed, comp, x0, shape, dtype, device):
    """Standard normals of the X-planes ``x0 .. x0 + shape[0]`` of field
    component ``comp``: plane x from a generator seeded by ``(seed, comp,
    x)``, so that the field of a seed does not depend on how many ranks
    share the grid."""
    out = torch.empty(shape, dtype=dtype, device=device)
    gen = torch.Generator(device=device)
    for j in range(shape[0]):
        gen.manual_seed(_mix(_mix(seed, comp), x0 + j))
        out[j].normal_(generator=gen)
    return out


def sharded_gaussian_random_field(seed, ddims, deltas, l_min, l_max, mesh,
                                  alpha=-11.0 / 3.0, g_rms=1.0,
                                  divergence_clean=True, dtype=torch.float32,
                                  axis_name="ens", noise=None):
    """Unit-rms (then ``g_rms``-scaled) solenoidal Gaussian random field,
    sharded over the mesh dim ``axis_name``.

    Returns ``(gx, gy, gz)``, each an (nx, ny, nz) DTensor sharded over its
    first axis.  Same spectrum and projection as
    :class:`~..fields.GaussianRandomField`, distributed.  ``seed``: an int;
    plane x of component c draws its normals from a generator seeded by
    ``(seed, c, x)``, so one seed gives one field whatever the mesh.
    ``noise`` (optional): the three components' X-sharded white noise
    (DTensors, or this rank's (nx/P, ny, nz) slabs) in place of the draw.
    float32 transforms in complex64, float64 in complex128.  nx and ny must
    divide by the dim's rank count."""
    from torch.distributed.tensor import DTensor

    nx, ny, nz = (int(d) for d in ddims)
    deltas = tuple(float(d) for d in deltas)
    group = mesh.get_group(axis_name)
    p = dist.get_world_size(group)
    _check_split(nx, p, "the X size")
    _check_split(ny, p, "the Y size")
    r = mesh.get_local_rank(axis_name)
    dev = mesh_device(mesh)
    nxl, nyl = nx // p, ny // p
    k0, k1 = 2.0 * np.pi / float(l_min), 2.0 * np.pi / float(l_max)

    spectra = []
    for c in range(3):
        if noise is None:
            w = _plane_noise(seed, c, r * nxl, (nxl, ny, nz), dtype, dev)
        else:
            w = noise[c]
            w = (w.to_local() if isinstance(w, DTensor) else w).to(dtype)
        spectra.append(_fwd_local(w, group))
        del w

    # this rank's Y-slab of the wavenumbers, in the field dtype (an f64
    # operand would promote the float32 spectra)
    kx, ky, kz = _waves((nx, ny, nz), deltas)
    ky = ky[:, r * nyl:(r + 1) * nyl, :]
    kxt, kyt, kzt = (torch.as_tensor(k, dtype=dtype, device=dev)
                     for k in (kx, ky, kz))
    kd = [torch.as_tensor(np.sin(k * d) / d, dtype=dtype, device=dev)
          for k, d in zip((kx, ky, kz), deltas)]
    step = max(1, _CHUNK // (nyl * nz))
    for a in range(0, nx, step):
        sl = slice(a, a + step)
        kk = torch.sqrt(kxt[sl] ** 2 + kyt ** 2 + kzt ** 2)
        sigma = _spectrum_sigma(kk, k0, k1, alpha, dtype)
        parts = [s[sl] for s in spectra]
        for s in parts:
            s.mul_(sigma)
        if divergence_clean:
            for s, v in zip(parts, _div_clean_k(*parts, kd[0][sl], kd[1],
                                                 kd[2])):
                s.copy_(v)

    comps = []
    sumsq = torch.zeros((), dtype=torch.float64, device=dev)
    for _ in range(3):
        f = _bwd_local(spectra.pop(0), group)
        g = f.real.contiguous()  # frees the complex slab with f
        del f
        sumsq += g.square().sum(dtype=torch.float64)
        comps.append(g)
    dist.all_reduce(sumsq, group=group)
    scale = (float(g_rms) / torch.sqrt(sumsq / (nx * ny * nz))).to(dtype)
    return tuple(sharded(mesh, g.mul_(scale), axis_name, nx) for g in comps)
