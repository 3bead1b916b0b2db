"""Pencil-decomposed 3D FFT over one dim of a device mesh.

The grid is slab-sharded over the mesh; the transform runs as

    slab (X-sharded)      : FFT over the two local axes (Y, Z)
    all-to-all transpose  : reshard to X-full / Y-sharded
    final axis            : FFT over X (now local)

and the result lives in k-space sharded over Y, where elementwise work
(spectrum shaping, divergence projection) needs no communication;
:func:`pencil_ifftn` brings it back to X-sharded real space.  Each transpose
is one ``all_to_all_single`` on the mesh dim's process group.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import sharded

__all__ = ["pencil_fftn", "pencil_ifftn"]


def _all_to_all(x, group, out=None):
    """``all_to_all_single`` of ``x`` (P, ...) over ``group``: block j goes
    to rank j, and block j of the result came from rank j.  Complex
    tensors travel as their real view.  ``out``: the contiguous buffer to
    receive into (default a new one)."""
    x = x.contiguous()  # an FFT along dim 0 may return permuted strides
    if out is None:
        out = torch.empty_like(x)
    if x.is_complex():
        dist.all_to_all_single(torch.view_as_real(out), torch.view_as_real(x),
                               group=group)
    else:
        dist.all_to_all_single(out, x, group=group)
    return out


def _check_split(n, p, what):
    if n % p:
        raise ValueError(f"{what} {n} is not divisible by the {p} ranks of "
                         "the mesh dim")


def _fwd_local(local, group):
    """This rank's X-slab (N/P, N, N) -> its Y-slab (N, N/P, N) of the
    3D FFT."""
    p = dist.get_world_size(group)
    nxl, ny, nz = local.shape
    _check_split(ny, p, "the Y size")
    f = torch.fft.fftn(local, dim=(-2, -1))  # real input: the full spectrum
    # block j of the send buffer is Y-chunk j, for rank j
    f = f.reshape(nxl, p, ny // p, nz).transpose(0, 1).contiguous()
    f = _all_to_all(f, group)
    # block j came from rank j: X-slab j of this rank's Y-chunk
    f = f.reshape(p * nxl, ny // p, nz)
    return torch.fft.fft(f, dim=0)


def _bwd_local(local_k, group):
    """This rank's Y-slab (N, N/P, N) of a spectrum -> its X-slab
    (N/P, N, N) of the inverse transform (complex)."""
    p = dist.get_world_size(group)
    nx, nyl, nz = local_k.shape
    _check_split(nx, p, "the X size")
    f = torch.fft.ifft(local_k, dim=0)
    # block j of the send buffer is X-slab j, for rank j
    f = _all_to_all(f.reshape(p, nx // p, nyl, nz), group)
    # block j came from rank j: Y-chunk j of this rank's X-slab
    f = f.transpose(0, 1).reshape(nx // p, p * nyl, nz)
    return torch.fft.ifftn(f, dim=(-2, -1))


def pencil_fftn(x, mesh, axis_name: str = "ens"):
    """3D FFT of a global (N, N, N) DTensor sharded over its first axis
    along the mesh dim ``axis_name``.

    Returns the k-space DTensor sharded over its *second* axis (feed it to
    :func:`pencil_ifftn` to come back).  Real input is promoted: float32
    to complex64, float64 to complex128.  A size the dim's rank count does
    not divide raises ``ValueError``."""
    nx, ny, nz = x.shape
    group = mesh.get_group(axis_name)
    _check_split(nx, dist.get_world_size(group), "the X size")
    f = _fwd_local(x.to_local(), group)
    return sharded(mesh, f, axis_name, ny, dim=1)


def pencil_ifftn(xk, mesh, axis_name: str = "ens"):
    """Inverse of :func:`pencil_fftn`: a k-space DTensor (X-full,
    Y-sharded) back to real space (X-sharded).  Returns the complex
    DTensor; take ``.real`` of its local shard."""
    nx, ny, nz = xk.shape
    group = mesh.get_group(axis_name)
    _check_split(ny, dist.get_world_size(group), "the Y size")
    f = _bwd_local(xk.to_local(), group)
    return sharded(mesh, f, axis_name, nx)

