"""Grid-sharded Gaussian random fields.

Scales the random-field generator (``fields/grf.py``) past one card's
memory: the grid is slab-sharded over one mesh dim, the FFTs run as pencil
decompositions (the steps of ``parallel/fft.py``), and the k-space work
(spectrum shaping, finite-difference divergence projection) is elementwise
on each rank's Y-slab of the spectra, with no communication.

The local work between the collectives runs as three captured programs
(``core/compiled.run``), as the JAX package's staged rfft route splits its
programs at the transforms:

* forward: a component's X-slab of white noise -> its 2D transform over
  (Y, Z), laid out as the forward transpose's send buffer;
* k-space: the three Y-slabs -> the transform over X, the shaping, the
  projection and the inverse transform over X, in place;
* backward: the backward transpose's receive buffer -> the component's
  X-slab of the real field and its sum of squares.

The ``all_to_all_single`` transposes and the ``all_reduce`` of the sum
stay between them, outside the graphs (gloo's cannot be captured).  The
programs share their large arrays in place (``compiled.workspace``): one
noise slab, one transpose buffer and the three spectra, so each lives
once.  A transpose writes straight into the next program's buffer, and a
program's output buffer is the next transpose's send buffer.  The
k-space and layout work runs in chunks of at most :data:`_CHUNK` entries,
so that no temporary approaches a spectrum's size.

The workspace and its programs stay on the device after a call, keyed by
the grid, the group size, the rank and the dtype; the box, ``l_min``,
``l_max``, ``alpha`` and ``g_rms`` are inputs.  A call on another grid
drops them first; a call of another path that needs their room releases
them (``compiled.make_room``); ``compiled.clear()`` returns them.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..core import compiled
from ..core.device import host_to_device
from ..fields.grf import _div_clean_k, _spectrum_sigma
from .fft import _all_to_all, _check_split
from .mesh import _mix, mesh_device, sharded

__all__ = ["sharded_gaussian_random_field"]

# entries of a spectrum per chunk of a stage's work
_CHUNK = 1 << 24


def _waves(n, deltas):
    kx = np.fft.fftfreq(n[0], d=deltas[0] / (2 * np.pi))[:, None, None]
    ky = np.fft.fftfreq(n[1], d=deltas[1] / (2 * np.pi))[None, :, None]
    kz = np.fft.fftfreq(n[2], d=deltas[2] / (2 * np.pi))[None, None, :]
    return kx, ky, kz


def _plane_noise(out, seed, comp, x0):
    """Standard normals into ``out``, the X-planes ``x0 .. x0 +
    out.shape[0]`` of field component ``comp``: plane x from a generator
    seeded by ``(seed, comp, x)``, so that the field of a seed does not
    depend on how many ranks share the grid."""
    gen = torch.Generator(device=out.device)
    for j in range(out.shape[0]):
        gen.manual_seed(_mix(_mix(seed, comp), x0 + j))
        out[j].normal_(generator=gen)


def _workspace(shape, p, dtype, device):
    """The buffers the three stages share in place: the noise slab, which
    the backward stage overwrites with a component of the field; the
    transpose buffer (P, nx/P, ny/P, nz); and the three Y-slab spectra
    (nx, ny/P, nz)."""
    nx, ny, nz = shape
    nxl, nyl = nx // p, ny // p
    cdt = torch.complex128 if dtype == torch.float64 else torch.complex64
    return {"noise": torch.empty((nxl, ny, nz), dtype=dtype, device=device),
            "a2a": torch.empty((p, nxl, nyl, nz), dtype=cdt, device=device),
            "spectra": tuple(torch.empty((nx, nyl, nz), dtype=cdt,
                                         device=device) for _ in range(3))}


def _kspace_params(shape, deltas, p, r, k0, k1, alpha):
    """The k-space stage's float64 input: this rank's wavenumbers (kx, its
    slab of ky, kz), their finite-difference forms sin(k d)/d, then
    ``k0``, ``k1`` and ``alpha``."""
    kx, ky, kz = (k.reshape(-1) for k in _waves(shape, deltas))
    nyl = shape[1] // p
    ks = (kx, ky[r * nyl:(r + 1) * nyl], kz)
    return np.concatenate([*ks, *(np.sin(k * d) / d
                                  for k, d in zip(ks, deltas)),
                           [k0, k1, alpha]])


def _forward_stage(noise, send, uniforms):
    """X-slab (nx/P, ny, nz) of noise -> its transform over (Y, Z) in the
    send buffer (P, nx/P, ny/P, nz): block j is Y-chunk j, for rank j."""
    p, nxl, nyl, nz = send.shape
    step = max(1, _CHUNK // (p * nyl * nz))
    for a in range(0, nxl, step):
        f = torch.fft.fftn(noise[a:a + step], dim=(-2, -1))
        send[:, a:a + step].copy_(f.reshape(-1, p, nyl, nz).transpose(0, 1))


def _kspace_stage(s0, s1, s2, params, uniforms, *, div_clean):
    """The three Y-slabs (nx, ny/P, nz), each as the forward transpose left
    it (block j from rank j: X-slab j transformed over Y and Z), in place:
    the transform over X, the spectrum shaping, the projection and the
    inverse transform over X, chunk by chunk along Y.  ``params``:
    :func:`_kspace_params`; the wavenumbers at the field's real dtype (an
    f64 operand would promote float32 spectra)."""
    nx, nyl, nz = s0.shape
    dtype = s0.real.dtype
    *waves, consts = torch.split(params, (nx, nyl, nz) * 2 + (3,))
    k0, k1, alpha = consts
    kx, ky, kz, kxd, kyd, kzd = (
        w.to(dtype).reshape(shape) for w, shape in zip(
            waves, [(-1, 1, 1), (1, -1, 1), (1, 1, -1)] * 2))
    step = max(1, _CHUNK // (nx * nz))
    for b in range(0, nyl, step):
        sl = (slice(None), slice(b, b + step))
        parts = [torch.fft.fft(s[sl], dim=0) for s in (s0, s1, s2)]
        kk = torch.sqrt(kx ** 2 + ky[sl] ** 2 + kz ** 2)
        sigma = _spectrum_sigma(kk, k0, k1, alpha, dtype)
        parts = [w * sigma for w in parts]
        if div_clean:
            parts = list(_div_clean_k(*parts, kxd, kyd[sl], kzd))
        # every temporary of a chunk is made before the chunk is written
        # and gone before the next chunk, which reuses its blocks: a
        # warm-up that runs out of memory does so before any write, so
        # that its run again (compiled.retrying) starts from the spectra
        # as they were
        for i, w in enumerate(parts):
            parts[i] = torch.fft.ifft(w, dim=0)
        del w
        for s, w in zip((s0, s1, s2), parts):
            s[sl].copy_(w)
        del parts, kk, sigma, w


def _backward_stage(recv, out, uniforms):
    """The backward transpose's receive buffer (P, nx/P, ny/P, nz), block j
    Y-chunk j of this rank's X-slab -> the real part of its inverse
    transform over (Y, Z) in ``out`` (nx/P, ny, nz); returns the sum of
    its squares in float64."""
    p, nxl, nyl, nz = recv.shape
    step = max(1, _CHUNK // (p * nyl * nz))
    sumsq = torch.zeros((), dtype=torch.float64, device=out.device)
    for a in range(0, nxl, step):
        f = recv[:, a:a + step].transpose(0, 1).reshape(-1, p * nyl, nz)
        g = torch.fft.ifftn(f, dim=(-2, -1)).real
        out[a:a + step].copy_(g)
        sumsq = sumsq + g.square().sum(dtype=torch.float64)
    return sumsq


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
    divide by the dim's rank count.

    The stages are programs (the module docstring), the counterpart of the
    JAX package's one jitted builder per configuration: their workspace's
    key holds the grid, the group size, the rank's slab and the dtype, the
    k-space program's key ``divergence_clean``; the box, ``l_min``,
    ``l_max`` and ``alpha`` are the k-space program's input, and ``g_rms``
    scales the field after the sum's ``all_reduce``, so a sweep of any of
    them replays every program."""
    from torch.distributed.tensor import DTensor

    shape = tuple(int(d) for d in ddims)
    nx, ny, nz = shape
    deltas = tuple(float(d) for d in deltas)
    group = mesh.get_group(axis_name)
    p = dist.get_world_size(group)
    _check_split(nx, p, "the X size")
    _check_split(ny, p, "the Y size")
    r = mesh.get_local_rank(axis_name)
    dev = mesh_device(mesh)
    nxl = nx // p
    k0, k1 = 2.0 * np.pi / float(l_min), 2.0 * np.pi / float(l_max)
    params = host_to_device(_kspace_params(shape, deltas, p, r, k0, k1,
                                           float(alpha)), dev)

    meta = _workspace(shape, p, dtype, "meta")
    ws = compiled.workspace(
        "sharded_grf", (shape, p, r, dtype), dev,
        lambda: _workspace(shape, p, dtype, dev),
        nbytes=sum(t.nbytes for t in (meta["noise"], meta["a2a"],
                                      *meta["spectra"])))
    slab, a2a, spectra = (ws.buffers[k] for k in ("noise", "a2a", "spectra"))

    for c in range(3):
        if noise is None:
            _plane_noise(slab, seed, c, r * nxl)
        else:
            w = noise[c]
            slab.copy_(w.to_local() if isinstance(w, DTensor) else w)
        ws.run(("sharded_grf_forward",), _forward_stage, (slab, a2a),
               inplace=2)
        _all_to_all(a2a, group, out=spectra[c].view(a2a.shape))

    div_clean = bool(divergence_clean)
    ws.run(("sharded_grf_kspace", div_clean),
           lambda *a: _kspace_stage(*a, div_clean=div_clean),
           (*spectra, params), inplace=3)

    comps = []
    sumsq = torch.zeros((), dtype=torch.float64, device=dev)
    for c in range(3):
        _all_to_all(spectra[c].view(a2a.shape), group, out=a2a)
        sumsq += ws.run(("sharded_grf_backward",), _backward_stage,
                        (a2a, slab), inplace=2)
        comps.append(compiled.retrying(slab.clone, slab.device, (ws,)))
    dist.all_reduce(sumsq, group=group)
    scale = (float(g_rms) / torch.sqrt(sumsq / (nx * ny * nz))).to(dtype)
    return tuple(sharded(mesh, g.mul_(scale), axis_name, nx) for g in comps)
