"""The ensemble datagen's particle draws, one launch a species.

A DM or star particle takes its radius from the cluster's radius-quantile
nodes, its position direction, its speed from the joint absolute-speed
table capped at the local escape speed, and its velocity direction (mapped
back from an Osipkov-Merritt model's isotropic space when ``r_a`` is set);
a gas particle its radius, its direction and the thermal energy at the
drawn radius.  The rule is :mod:`..core.draws`'.

On a CUDA tensor :func:`draw_collisionless` and :func:`draw_gas` launch the
hand-written kernel ``csrc/draw_particles.cu`` (one launch for every
particle of every cluster of a species); on a CPU tensor they run
:func:`draw_collisionless_plain` and :func:`draw_gas_plain`, the rule's
torch chain.  The kernel replaces no TPU kernel; the source note in the
``.cu`` file gives why it was added, its design and its bound.

The launch goes on PyTorch's current stream, so inside a captured program
(:mod:`..core.compiled`) it is recorded into the graph; each wrapper's
``launches`` counts the launches the card runs, a replay adding the nodes
of its graph.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.draws import (node_lerp, radial_draw, sample_speeds_joint,
                          velocity_draw)
from ..core.interp import loguniform_lerp
from .build import SMEM_OPTIN_BYTES, launch

__all__ = ["draw_collisionless", "draw_collisionless_plain", "draw_gas",
           "draw_gas_plain"]

# the C entry points' arguments before the stream: the uniforms, the
# tables, the outputs, batch, n, the table sizes, chunk, then the flags
# and float32 scalars
_COLLISIONLESS_ARGS = ((ctypes.c_void_p,) * 12
                       + (ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_int, ctypes.c_longlong, ctypes.c_int)
                       + (ctypes.c_float,) * 3)
_GAS_ARGS = ((ctypes.c_void_p,) * 8
             + (ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                ctypes.c_longlong)
             + (ctypes.c_float,) * 3)

_THREADS = 256
# particles a block takes at most (16 a thread), and the blocks a launch
# aims at (about eight on each of the card's 132 SMs) before it shortens
# the chunk
_MAX_CHUNK = 16 * _THREADS
_TARGET_BLOCKS = 8 * 132


def draw_collisionless_plain(uniforms, r_q, v_esc, joint, r_a=None):
    """``(pos, vel)`` (..., n, 3) of a DM or star draw from ``uniforms``
    ``(u_radius, u_speed, u_row, pos_dir, vel_dir)`` (each (..., n), the
    directions ``(cos_theta, u_phi)`` pairs), the radius nodes ``r_q`` and
    the escape speed there ``v_esc`` (..., RQ), and the joint table
    ``joint`` (..., RQ, n_q); ``r_a`` the Osipkov-Merritt radius or
    ``None``."""
    u_r, u_q, u_b, pos_dir, vel_dir = uniforms
    kq, wq, radius, rhat = radial_draw(r_q, u_r, pos_dir)
    speed = sample_speeds_joint(joint, kq, wq, uniforms=(u_q, u_b))
    # the Bernoulli row pick can exceed the LOCAL escape speed by the
    # inter-node v_esc difference
    v_esc = node_lerp(v_esc, kq, wq)
    speed = torch.minimum(speed, v_esc.to(speed.dtype))
    vel = velocity_draw(speed, vel_dir, rhat, radius, r_a)
    return radius[..., None] * rhat, vel


def draw_gas_plain(uniforms, r_q, grid_r, e_grid):
    """``(pos, energy)``, (..., n, 3) and (..., n), of a gas draw from
    ``uniforms`` ``(u_radius, dir)``, the radius nodes ``r_q`` (..., RQ)
    and the thermal energy ``e_grid`` on the model's log-uniform grid
    ``grid_r`` (..., N)."""
    _, _, radius, rhat = radial_draw(r_q, *uniforms)
    # thermal energy at the DRAWN radius on the log-uniform model grid: a
    # lerp of e between radius-quantile nodes is off by up to ~60% across
    # the wide innermost mass bin
    energy = loguniform_lerp(radius, grid_r, e_grid)
    return radius[..., None] * rhat, energy


def _flat(uniforms):
    out = []
    for u in uniforms:
        out.extend(u if isinstance(u, (tuple, list)) else (u,))
    return out


def _check(name, uniforms, count, tables):
    """The uniforms' leading shape and n; raises on a type, device, shape
    or layout the kernel does not take.  ``tables``: ``(name, tensor,
    ndim beyond the leading axes)``."""
    flat = _flat(uniforms)
    if len(flat) != count:
        raise ValueError(f"{name}: {count} uniform arrays expected, got "
                         f"{len(flat)}")
    device = flat[0].device if isinstance(flat[0], torch.Tensor) else None
    named = ([(f"uniforms[{i}]", u) for i, u in enumerate(flat)]
             + [(t_name, t) for t_name, t, _ in tables])
    for t_name, t in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: {t_name} must be a torch.Tensor")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {t_name} must be torch.float32, got "
                            f"{t.dtype}")
        if t.device != device:
            raise ValueError(f"{name}: {t_name} is on {t.device}, the "
                             f"uniforms on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {t_name} must be contiguous")
    shape = flat[0].shape
    if len(shape) < 1 or any(u.shape != shape for u in flat):
        raise ValueError(f"{name}: the uniforms must share one shape (..., "
                         f"n), got {[tuple(u.shape) for u in flat]}")
    lead = shape[:-1]
    for t_name, t, extra in tables:
        if t.shape[:-extra] != lead or t.shape[-1] < 2:
            raise ValueError(f"{name}: {t_name} must be {tuple(lead)} + "
                             f"{extra} axes of >= 2 nodes, got "
                             f"{tuple(t.shape)}")
    return lead, int(shape[-1])


def _chunk(batch: int, n: int) -> int:
    """Particles a block takes: the most (up to :data:`_MAX_CHUNK`, a
    multiple of 256) that still give the launch about
    :data:`_TARGET_BLOCKS` blocks."""
    per = -(-batch * n // _TARGET_BLOCKS)
    return min(_MAX_CHUNK, max(_THREADS, -(-per // _THREADS) * _THREADS))


def _hi(n: int) -> float:
    """torch.clamp's upper end in node_index, as its float32."""
    return float(np.float32(n - 1 - 1e-6))


def draw_collisionless(uniforms, r_q, v_esc, joint, r_a=None):
    """``(pos, vel)`` of :func:`draw_collisionless_plain`'s arguments, all
    float32, contiguous and on one device, with ``v_esc`` shaped as
    ``r_q`` and ``joint`` (..., RQ, n_q).

    A CUDA tensor goes through the CUDA kernel
    (``draw_collisionless.launches`` counts its launches on the card, a
    graph's on each replay), bit for bit the plain version's result,
    isotropic or Osipkov-Merritt.  A CPU tensor goes through
    :func:`draw_collisionless_plain`.  Any other device raises, as do
    other dtypes, mixed devices, non-contiguous inputs and bad shapes.
    """
    lead, n = _check("draw_collisionless", uniforms, 7,
                     (("r_q", r_q, 1), ("v_esc", v_esc, 1),
                      ("joint", joint, 2)))
    if v_esc.shape != r_q.shape or joint.shape[-2] != r_q.shape[-1]:
        raise ValueError(f"draw_collisionless: v_esc {tuple(v_esc.shape)} "
                         f"and joint {tuple(joint.shape)} must have r_q's "
                         f"{r_q.shape[-1]} nodes")
    dev = r_q.device
    if dev.type == "cpu":
        return draw_collisionless_plain(uniforms, r_q, v_esc, joint, r_a)
    if dev.type != "cuda":
        raise ValueError(f"draw_collisionless: unsupported device {dev}")
    rq, n_q = int(r_q.shape[-1]), int(joint.shape[-1])
    if 2 * 4 * rq > SMEM_OPTIN_BYTES:
        raise ValueError(f"draw_collisionless: {rq} radius nodes exceed one "
                         "block's shared memory")
    pos = torch.empty(lead + (n, 3), dtype=torch.float32, device=dev)
    vel = torch.empty_like(pos)
    batch = int(np.prod(lead, dtype=np.int64))
    if pos.numel() == 0:
        return pos, vel
    inv_ra = 0.0 if r_a is None else float(np.float32(1.0)
                                            / np.float32(r_a))
    launch(draw_collisionless, "draw_particles", _COLLISIONLESS_ARGS, dev,
           *(u.data_ptr() for u in _flat(uniforms)), r_q.data_ptr(),
           v_esc.data_ptr(), joint.data_ptr(), pos.data_ptr(),
           vel.data_ptr(), batch, n, rq, n_q, _chunk(batch, n),
           int(r_a is not None), _hi(rq), _hi(n_q), inv_ra,
           entry="draw_collisionless")
    return pos, vel


def draw_gas(uniforms, r_q, grid_r, e_grid):
    """``(pos, energy)`` of :func:`draw_gas_plain`'s arguments, all
    float32, contiguous and on one device, with ``e_grid`` shaped as
    ``grid_r``.

    A CUDA tensor goes through the CUDA kernel (``draw_gas.launches``
    counts its launches on the card, a graph's on each replay), bit for
    bit the plain version's result; a CPU tensor through
    :func:`draw_gas_plain`.  Any other device raises, as do other dtypes,
    mixed devices, non-contiguous inputs and bad shapes."""
    lead, n = _check("draw_gas", uniforms, 3,
                     (("r_q", r_q, 1), ("grid_r", grid_r, 1),
                      ("e_grid", e_grid, 1)))
    if e_grid.shape != grid_r.shape:
        raise ValueError(f"draw_gas: e_grid {tuple(e_grid.shape)} must be "
                         f"shaped as grid_r {tuple(grid_r.shape)}")
    dev = r_q.device
    if dev.type == "cpu":
        return draw_gas_plain(uniforms, r_q, grid_r, e_grid)
    if dev.type != "cuda":
        raise ValueError(f"draw_gas: unsupported device {dev}")
    rq, n_grid = int(r_q.shape[-1]), int(grid_r.shape[-1])
    if 4 * (rq + 2 * n_grid) > SMEM_OPTIN_BYTES:
        raise ValueError(f"draw_gas: {rq} radius nodes and a {n_grid}-point "
                         "grid exceed one block's shared memory")
    pos = torch.empty(lead + (n, 3), dtype=torch.float32, device=dev)
    energy = torch.empty(lead + (n,), dtype=torch.float32, device=dev)
    batch = int(np.prod(lead, dtype=np.int64))
    if energy.numel() == 0:
        return pos, energy
    launch(draw_gas, "draw_particles", _GAS_ARGS, dev,
           *(u.data_ptr() for u in _flat(uniforms)), r_q.data_ptr(),
           grid_r.data_ptr(), e_grid.data_ptr(), pos.data_ptr(),
           energy.data_ptr(), batch, n, rq, n_grid, _chunk(batch, n),
           _hi(rq), _hi(n_grid),
           float(np.float32(1.0) / np.float32(n_grid - 1)), entry="draw_gas")
    return pos, energy


draw_collisionless.launches = 0
draw_gas.launches = 0
