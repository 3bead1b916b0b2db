"""The draw rule shared by the merger pipeline, the ensemble datagen and
the class path: their uniforms, and what each product makes of them.

A draw takes a radius from a table of radius-quantile nodes at a uniform
(:func:`node_index`, :func:`node_lerp`), a position direction and a
velocity direction (:func:`isotropic`), and maps the velocity direction
back from an Osipkov-Merritt model's isotropic (v_r, gamma v_t) space
(:func:`velocity_draw`).  The speed is the joint-table lookup of
:func:`sample_speeds_joint` (the table built by
:func:`~..virial.build_joint_speed_pairs`), which takes its quantile by the
same :func:`node_index`.

Every uniform draw takes a ``torch.Generator`` on the tensors' device, or the
pre-drawn uniforms a caller wants at that random site (how the tests feed
both packages the same numbers).  ``n`` is a length or a whole shape: the
ensemble draws ``(batch, n_part)`` at once.  ``out`` (the uniforms' own
functions): tensors of the same tree, filled in place with the numbers the
call would return (a captured program's static buffers).
"""

from __future__ import annotations

import math

import torch

from .interp import _gather

__all__ = ["uniform", "isotropic", "isotropic_uniforms",
           "collisionless_uniforms", "gas_uniforms", "node_index",
           "node_lerp", "radial_draw", "sample_speeds_joint",
           "velocity_draw"]


def uniform(gen, n, dtype, device, lo=0.0, hi=1.0, out=None):
    """Uniform numbers of shape ``n`` in ``[lo, hi)`` (into ``out``)."""
    if out is None:
        u = torch.rand(n, generator=gen, dtype=dtype, device=device)
        if (lo, hi) != (0.0, 1.0):
            u = u * (hi - lo) + lo
        return u
    # torch.rand is empty + uniform_: the same numbers
    out.uniform_(generator=gen)
    if (lo, hi) != (0.0, 1.0):
        out.mul_(hi - lo).add_(lo)
    return out


def isotropic(n, dtype, device, gen=None, uniforms=None):
    """Unit vectors ``n + (3,)`` uniform on the sphere; ``uniforms`` is
    ``(cos_theta in [-1, 1), u_phi in [0, 1))``."""
    cos_t, u_phi = (isotropic_uniforms(gen, n, dtype, device)
                    if uniforms is None else uniforms)
    phi = (2.0 * math.pi) * u_phi
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    return torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi),
                        cos_t], dim=-1)


def isotropic_uniforms(gen, n, dtype, device, out=None):
    """``(cos_theta, u_phi)`` for :func:`isotropic`, drawn from ``gen``."""
    out = out or (None, None)
    return (uniform(gen, n, dtype, device, -1.0, 1.0, out=out[0]),
            uniform(gen, n, dtype, device, out=out[1]))


def collisionless_uniforms(gen, n, dtype, device, out=None):
    """Every uniform of a DM or star draw, in the order the draw takes them
    from ``gen``: ``(u_radius, u_speed, u_row, pos_dir, vel_dir)``."""
    out = out or (None,) * 5
    return (uniform(gen, n, dtype, device, out=out[0]),
            uniform(gen, n, dtype, device, out=out[1]),
            uniform(gen, n, dtype, device, out=out[2]),
            isotropic_uniforms(gen, n, dtype, device, out=out[3]),
            isotropic_uniforms(gen, n, dtype, device, out=out[4]))


def gas_uniforms(gen, n, dtype, device, out=None):
    """Every uniform of a gas (or tracer) draw, in its order:
    ``(u_radius, dir)``."""
    out = out or (None, None)
    return (uniform(gen, n, dtype, device, out=out[0]),
            isotropic_uniforms(gen, n, dtype, device, out=out[1]))


def node_index(x, n):
    """``(j, w)``: the node j in [0, n - 2] below each fractional position
    ``x`` on a table of ``n`` uniformly spaced nodes (a uniform u sits at
    ``u (n - 1)``), and the weight w = x - j in [0, 1] of node j + 1, with
    x clamped to [0, n - 1) first."""
    x = torch.clamp(x, 0.0, n - 1 - 1e-6)
    # integer clamp too: in float32 the 1e-6 margin is below the ulp at
    # n - 1 for n >= ~32, so x can still round to exactly n - 1
    j = torch.clamp_max(x.to(torch.int64), n - 2)
    return j, x - j.to(x.dtype)


def node_lerp(table, j, w):
    """Lerp of ``table`` (..., n) between nodes ``j`` and ``j + 1``."""
    return (1.0 - w) * _gather(table, j) + w * _gather(table, j + 1)


def radial_draw(r_q, u_radius, pos_dir):
    """``(kq, wq, radius, rhat)``: the node index and weight of each
    uniform ``u_radius`` on the radius-quantile nodes ``r_q`` (..., RQ),
    the radius lerped there, and the position direction drawn from the
    uniforms ``pos_dir`` (:func:`isotropic`)."""
    RQ = r_q.shape[-1]
    kq, wq = node_index(u_radius * (RQ - 1), RQ)
    rhat = isotropic(u_radius.shape, u_radius.dtype, u_radius.device,
                     uniforms=pos_dir)
    return kq, wq, node_lerp(r_q, kq, wq), rhat


def velocity_draw(speed, vel_dir, rhat, radius, r_a=None):
    """Velocities of the drawn ``speed`` (...,) along the directions drawn
    from the uniforms ``vel_dir`` (:func:`isotropic`).  ``r_a``: the
    Osipkov-Merritt radius, whose f(Q) is isotropic in (v_r, gamma v_t)
    space: the direction maps back by dividing its tangential part, with
    respect to the position direction ``rhat``, by gamma(r) =
    sqrt(1 + r^2/r_a^2) at ``radius``.  ``None``: isotropic."""
    vdir = isotropic(speed.shape, speed.dtype, speed.device,
                     uniforms=vel_dir)
    if r_a is not None:
        mu = torch.sum(vdir * rhat, dim=-1, keepdim=True)
        gamma = torch.sqrt(1.0 + (radius / r_a) ** 2)[..., None]
        vdir = mu * rhat + (vdir - mu * rhat) / gamma
    return speed[..., None] * vdir


def sample_speeds_joint(joint, kq, wq, generator=None, uniforms=None):
    """Speed draw from a joint table (..., RQ, n_q) of
    :func:`~..virial.build_joint_speed_pairs`.

    ``kq``/``wq``: each particle's radius-quantile index and fractional
    weight, (..., n).  The table row is picked between the two nodes
    bracketing the radius by a Bernoulli draw on ``wq``; the speed is the
    lerp along the quantile axis.  ``uniforms``: ``(u_quantile, u_row)``,
    else two draws from ``generator``.
    """
    dtype = joint.dtype
    n_q = joint.shape[-1]
    if uniforms is None:
        uq = uniform(generator, kq.shape, dtype, joint.device)
        ub = uniform(generator, kq.shape, dtype, joint.device)
    else:
        uq, ub = uniforms
    # m <= n_q - 2, so m + 1 never spills into the next radius row of the
    # flattened table
    m, wm = node_index(uq * (n_q - 1), n_q)
    k_row = kq + (ub < wq.to(dtype)).to(torch.int64)
    flat = joint.reshape(joint.shape[:-2] + (-1,))
    idx = k_row * n_q + m
    return ((1.0 - wm) * _gather(flat, idx) + wm * _gather(flat, idx + 1))
