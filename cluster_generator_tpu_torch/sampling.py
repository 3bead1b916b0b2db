"""Particle sampling on the model's device.

All draws are inverse-CDF transforms:

* radii: u ~ U(0,1) mapped through the normalized enclosed-mass CDF,
  tabulated at ``_RQ_CLASS`` uniform quantiles;
* angles: isotropic (cos(theta) ~ U(-1,1), phi ~ U(0, 2 pi));
* speeds: the per-model inverse speed-CDF table
  (:func:`~.virial.speed_inverse_cdf_table`, inverted by kernel K1) folded
  onto the radius-quantile nodes; no rejection loop.

Every generator takes ``prng`` (None, an int, a ``numpy.random.RandomState``
or a ``torch.Generator`` on the model's device) and, in its place, the
pre-drawn ``uniforms`` of its random sites, which is how two generators
that cannot produce the same stream are given the same numbers.  Radii and
directions are float64 draws; speeds are drawn in the table's dtype.
Nothing between the model and the returned container is copied to the
host, apart from single scalars (the mass inside ``r_max`` and the grid
index of ``r_max``).

Everything a draw needs besides its random numbers (the truncated CDF's
quantile nodes, the field splines, the joint speed table) depends only on
the model and ``r_max``.  It is built at the first draw and kept on the
object the draw belongs to (:func:`_draw_tables`), so that a second draw
is the per-particle work alone.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from .core.device import resolve_device, tensor_on
from .core.draws import isotropic, uniform
from .core.grid import linspace
from .core.interp import (cubic_spline, interp, is_loguniform, spline_eval,
                          spline_eval_loguniform)
from .core.logging import mylog
from .particles import ClusterParticles

__all__ = ["parse_prng", "generate_particle_radii", "generate_gas_particles",
           "generate_tracer_particles", "generate_collisionless_particles"]


def parse_prng(prng, device="cuda"):
    """None / int / ``numpy.random.RandomState`` / ``torch.Generator`` as
    a ``torch.Generator`` on ``device``.  A generator passed in must
    already live there."""
    device = resolve_device(device)
    if isinstance(prng, torch.Generator):
        if prng.device.type != device.type:
            raise ValueError(f"the generator lives on {prng.device}, the "
                             f"model on {device}")
        return prng
    if prng is None:
        import secrets

        seed = secrets.randbits(63)
    elif isinstance(prng, (int, np.integer)):
        seed = int(prng)
    elif isinstance(prng, np.random.RandomState):
        # the upstream package's RandomState, for API compatibility: its
        # state is folded into a seed
        seed = int(prng.randint(0, 2**31 - 1))
    else:
        raise TypeError(f"cannot make a torch.Generator from {prng!r}")
    return torch.Generator(device=device).manual_seed(seed)


def _truncated_cdf(r, m, dens=None, r_max=None):
    """Normalized enclosed mass of the float64 tensors ``r``, ``m``,
    truncated at ``r_max``: ``(P, r with a leading 0, mtot)``, the first
    two tensors on ``r``'s device, ``mtot`` a float.

    Zero-density grid points (the clamped dark-matter outskirts) are
    masked by forward-filling the mass, so they carry zero sampling
    probability.
    """
    if dens is not None:
        neg_inf = torch.full_like(m, -torch.inf)
        m_eff = torch.cummax(torch.where(dens > 0.0, m, neg_inf), dim=0).values
        m_eff = torch.where(torch.isfinite(m_eff), m_eff,
                            torch.zeros_like(m_eff))
    else:
        m_eff = m
    if r_max is None:
        ridx = r.shape[0]
    else:
        ridx = int(torch.searchsorted(
            r, torch.as_tensor(float(r_max), dtype=r.dtype, device=r.device)))
        if ridx == 0:
            # ridx - 1 would wrap to the last grid point: the full-grid
            # mass, and draws far beyond r_max
            raise ValueError(
                f"r_max={r_max} lies below the first grid point "
                f"(r[0]={float(r[0])}); nothing to sample.")
    mtot = m_eff[ridx - 1]
    P = torch.clamp(m_eff / mtot, 0.0, 1.0)
    P = torch.cummax(P, dim=0).values
    zero = torch.zeros(1, dtype=r.dtype, device=r.device)
    return torch.cat([zero, P]), torch.cat([zero, r]), float(mtot)


# radius-quantile table resolution of the generators: a draw is a
# computed-index lerp, with no per-particle search over the CDF, at an
# O(1/RQ^2) CDF resampling error
_RQ_CLASS = 4096


def _radius_quantile_nodes(P, rr):
    """The inverse CDF at ``_RQ_CLASS`` uniform quantiles.

    The top node is clamped at the radius where P first reaches 1: the
    r_max clip leaves a P = 1 plateau out to the grid end, and the
    interpolation at exactly 1.0 walks to the plateau's far edge, so that
    draws would leak past the truncation radius.  A CDF that tops out
    below 1 takes the grid end as its cap."""
    full = P >= 1.0
    r_cap = torch.where(full.any(), rr[torch.argmax(full.to(torch.int8))],
                        rr[-1])
    q = linspace(0.0, 1.0, _RQ_CLASS, device=rr.device)
    return torch.minimum(interp(q, P, rr), r_cap)


def _node_value_lerp(nodes, kq, wq):
    """Per-particle lerp of a table of values at the quantile nodes."""
    return (1.0 - wq) * nodes[kq] + wq * nodes[kq + 1]


def _sample_radii_table(r_q, num, gen=None, u=None):
    """``(radius, kq, wq)``: computed-index lerp on the quantile-node
    table.  kq/wq feed the joint speed table and any per-particle
    node-value lerp, so that later lookups share the one radius draw."""
    RQ = r_q.shape[0]
    if u is None:
        u = uniform(gen, num, torch.float64, r_q.device)
    x = torch.clamp(u * (RQ - 1), 0.0, RQ - 1 - 1e-9)
    # integer clamp as well, as at the float32 sites
    kq = torch.clamp_max(x.to(torch.int64), RQ - 2)
    wq = x - kq
    return _node_value_lerp(r_q, kq, wq), kq, wq


def generate_particle_radii(r, m, num_particles, r_max=None, prng=None,
                            dens=None, uniforms=None, device="cuda"):
    """Inverse-CDF radius sampling by per-particle interpolation of the
    CDF; returns ``(radii, mtot)``.  ``uniforms``: the (num,) float64
    draws.  The draw runs where ``r`` lives when it is a tensor, and on
    ``device`` when it is an array; ``m`` and ``dens`` as arrays follow
    ``r``, as tensors they must live there already."""
    r = tensor_on(r, device)
    m = tensor_on(m, r.device)
    if dens is not None:
        dens = tensor_on(dens, r.device)
    P, rr, mtot = _truncated_cdf(r, m, dens=dens, r_max=r_max)
    if uniforms is None:
        uniforms = uniform(parse_prng(prng, rr.device), int(num_particles),
                           torch.float64, rr.device)
    return interp(uniforms, P, rr), mtot


def _tile(arr, sub_sample, num):
    if sub_sample > 1:
        # num may be no multiple of sub_sample: one extra copy, so that
        # the truncation always has >= num elements
        reps = (sub_sample + 1,) + (1,) * (arr.ndim - 1)
        return arr.repeat(reps)[:num]
    return arr


def _draw_tables(owner, r_max, sources, build):
    """``build()``, kept on ``owner`` (a model for its gas, a virial
    object for its species) for the next draw.  One entry is held: it is
    rebuilt when ``r_max`` changes and when any tensor of ``sources``, the
    fields the tables were made of, was replaced or written in place."""
    key = None if r_max is None else float(r_max)
    stamp = tuple(t._version for t in sources)
    held = owner._draw_tables
    if (held is not None and held[0] == key and held[2] == stamp
            and all(a is b for a, b in zip(held[1], sources))):
        return held[3]
    tables = build()
    owner._draw_tables = (key, sources, stamp, tables)
    return tables


def _spline_at(rgrid, loguniform, sp, radius_sub):
    """The cubic spline ``sp`` of a field on ``rgrid`` at the drawn radii.
    Log-uniform grids (every built model) take the computed-index path,
    other grids a bracketing search.  Queries are clamped to the knot
    range: the sampling CDF starts at r = 0, so inner-bin draws land below
    ``rgrid[0]``, where the boundary polynomial's extrapolation can turn
    1.5 P/rho negative."""
    if loguniform:
        return spline_eval_loguniform(sp, radius_sub)
    return spline_eval(sp, torch.clamp(radius_sub, rgrid[0], rgrid[-1]))


def _gas_tables(model, r_max):
    """What a gas or tracer draw needs of ``model`` inside ``r_max``: the
    radius-quantile nodes, the mass, and the splines of the per-particle
    fields (the potential's joins them at the first draw that asks for
    it)."""
    rgrid = model["radius"]
    names = ["radius", "gas_mass"]
    names += [k for k in ("density", "pressure", "gravitational_potential")
              if k in model]
    sources = tuple(model[k] for k in names)

    def build():
        P, rr_ins, mtot = _truncated_cdf(rgrid, model["gas_mass"],
                                         r_max=r_max)
        tables = {"r_q": _radius_quantile_nodes(P, rr_ins), "mtot": mtot,
                  "loguniform": is_loguniform(rgrid)}
        if "pressure" in model:
            dens = model["density"]
            tables["energy"] = cubic_spline(rgrid,
                                            1.5 * model["pressure"] / dens)
            tables["density"] = cubic_spline(rgrid, dens)
        return tables

    return _draw_tables(model, r_max, sources, build)


def generate_tracer_particles(model, num_particles, r_max=None, sub_sample=1,
                              prng=None, uniforms=None):
    """Massless tracers at rest that follow the gas.  ``uniforms``:
    ``(u_radius (num // sub_sample,), (cos_theta, u_phi) (num,))``."""
    dev = model["radius"].device
    gen = None if uniforms is not None else parse_prng(prng, dev)
    u_r, u_dir = uniforms if uniforms is not None else (None, None)
    mylog.info("We will be assigning %d tracer particles.", num_particles)
    num_sub = num_particles // sub_sample
    tables = _gas_tables(model, r_max)
    radius_sub, _, _ = _sample_radii_table(tables["r_q"], num_sub, gen, u_r)
    radius = _tile(radius_sub, sub_sample, num_particles)
    pos = radius[:, None] * isotropic(num_particles, torch.float64, dev, gen,
                                      u_dir)

    fields = OrderedDict()
    fields["tracer", "particle_position"] = pos
    fields["tracer", "particle_velocity"] = torch.zeros_like(pos)
    fields["tracer", "particle_mass"] = torch.zeros_like(radius)
    return ClusterParticles("tracer", fields, device=dev)


def generate_gas_particles(model, num_particles, r_max=None, sub_sample=1,
                           compute_potential=False, prng=None, uniforms=None):
    """Gas particles in hydrostatic equilibrium: positions from the
    gas-mass CDF, thermal energies e = 1.5 P / rho and densities splined at
    each drawn radius, equal masses, zero velocities.  ``uniforms``: as
    for :func:`generate_tracer_particles`."""
    rgrid = model["radius"]
    dev = rgrid.device
    gen = None if uniforms is not None else parse_prng(prng, dev)
    u_r, u_dir = uniforms if uniforms is not None else (None, None)
    mylog.info("We will be assigning %d gas particles.", num_particles)
    num_sub = num_particles // sub_sample

    tables = _gas_tables(model, r_max)
    radius_sub, _, _ = _sample_radii_table(tables["r_q"], num_sub, gen, u_r)
    radius = _tile(radius_sub, sub_sample, num_particles)
    pos = radius[:, None] * isotropic(num_particles, torch.float64, dev, gen,
                                      u_dir)

    # field values at the DRAWN radii: lerping them between the
    # radius-quantile nodes instead would be exact for the radius but not
    # for a curved field (the innermost mass-quantile bin spans a huge
    # radius range)
    def field_at(name):
        return _tile(_spline_at(rgrid, tables["loguniform"], tables[name],
                                radius_sub), sub_sample, num_particles)

    fields = OrderedDict()
    fields["gas", "particle_position"] = pos
    fields["gas", "thermal_energy"] = field_at("energy")
    fields["gas", "particle_mass"] = torch.full_like(
        radius, tables["mtot"] / num_particles)
    fields["gas", "density"] = field_at("density")
    fields["gas", "particle_velocity"] = torch.zeros_like(pos)
    if compute_potential:
        if "potential" not in tables:  # splined when first asked for
            tables["potential"] = cubic_spline(
                rgrid, model["gravitational_potential"])
        fields["gas", "particle_potential"] = field_at("potential")
    return ClusterParticles("gas", fields, device=dev)


def _collisionless_tables(virial, r_max):
    """What a draw of ``virial``'s species needs inside ``r_max``: the
    radius-quantile nodes, the mass, psi as a spline and at the nodes
    (exact cubic spline; it feeds the joint table and the escape-speed
    cap) and the joint absolute-speed table
    (:func:`~.virial.build_joint_speed_pairs`)."""
    from .virial import build_joint_speed_pairs

    model, ptype = virial.model, virial.ptype
    rgrid = model["radius"]
    sources = (rgrid, model[f"{ptype}_mass"], model[f"{ptype}_density"],
               model["gravitational_potential"], virial.df)

    def build():
        P, rr_ins, mtot = _truncated_cdf(rgrid, model[f"{ptype}_mass"],
                                         dens=model[f"{ptype}_density"],
                                         r_max=r_max)
        r_q = _radius_quantile_nodes(P, rr_ins)
        psi_grid = torch.flip(virial.ee, (0,))  # back to radial ordering
        psi_sp = cubic_spline(rgrid, psi_grid)
        psi_q = spline_eval(psi_sp, r_q)
        row_ee, s_inv = virial._speed_table()
        joint = build_joint_speed_pairs(rgrid, psi_grid, row_ee, s_inv, r_q,
                                        dtype=s_inv.dtype, psi_q=psi_q)
        return {"r_q": r_q, "mtot": mtot, "psi": psi_sp, "psi_q": psi_q,
                "joint": joint, "loguniform": is_loguniform(rgrid)}

    return _draw_tables(virial, r_max, sources, build)


def generate_collisionless_particles(virial, num_particles, r_max=None,
                                     sub_sample=1, compute_potential=False,
                                     prng=None, uniforms=None):
    """DM or star particles in virial equilibrium.

    Speeds come from the inverse speed-CDF table folded onto the radius
    quantile nodes as a joint absolute-speed table
    (:func:`~.virial.build_joint_speed_pairs`): per particle, one
    computed-index radius lerp and one joint-table lookup, with no psi
    lookup and no search.

    When ``virial`` carries an Osipkov-Merritt anisotropy radius, the same
    speed draw applies (the OM f(Q) is isotropic in (v_r, gamma v_t)
    space) and only the velocity directions change: the tangential
    components are divided by gamma(r) = sqrt(1 + r^2/r_a^2), which gives
    beta(r) = r^2/(r^2 + r_a^2).

    ``uniforms``: ``(u_radius (num // sub_sample,), (cos_theta, u_phi) of
    the positions (num,), (u_quantile, u_row) of the speeds (num //
    sub_sample,) in the table's dtype, (cos_theta, u_phi) of the
    velocities (num,))``.
    """
    from .virial import sample_speeds_joint

    ptype = virial.ptype
    rgrid = virial.model["radius"]
    dev = rgrid.device
    gen = None if uniforms is not None else parse_prng(prng, dev)
    u_r, u_pos, u_speed, u_vel = (uniforms if uniforms is not None
                                  else (None,) * 4)
    short = {"dark_matter": "dm", "stellar": "star"}[ptype]
    mylog.info("We will be assigning %d %s particles.", num_particles, ptype)
    num_sub = num_particles // sub_sample

    tables = _collisionless_tables(virial, r_max)
    r_nodes, psi_sp = tables["r_q"], tables["psi"]
    mtot = tables["mtot"]
    radius_sub, kq, wq = _sample_radii_table(r_nodes, num_sub, gen, u_r)
    radius = _tile(radius_sub, sub_sample, num_particles)
    rhat = isotropic(num_particles, torch.float64, dev, gen, u_pos)
    pos = radius[:, None] * rhat
    psi_p = _node_value_lerp(tables["psi_q"], kq, wq)

    speed_sub = sample_speeds_joint(tables["joint"], kq, wq, generator=gen,
                                    uniforms=u_speed)
    # the joint table picks the speed row by a Bernoulli draw between the
    # two radius-quantile nodes while the radius is lerped, so a particle
    # near the outer node can draw from the inner node's (faster) table
    # and pass its LOCAL escape speed by up to the inter-node difference,
    # O(1/RQ).  The cap at v_esc(r) = sqrt(2 psi(r)) keeps it bound.
    speed_sub = torch.minimum(speed_sub,
                              torch.sqrt(2.0 * psi_p).to(speed_sub.dtype))
    speed = _tile(speed_sub, sub_sample, num_particles)
    u = isotropic(num_particles, torch.float64, dev, gen, u_vel)
    r_a = getattr(virial, "r_a", None)
    if r_a is None:
        vel = speed[:, None] * u
    else:
        # Osipkov-Merritt: with w = gamma v_t the DF f(Q) is isotropic in
        # (v_r, w) space, so the isotropic draw above is the (v_r, w)
        # draw; mapping back divides the tangential part by gamma(r).
        # rhat is the position draw's own unit vector (exact at r = 0).
        mu = torch.sum(u * rhat, dim=1, keepdim=True)
        gamma = torch.sqrt(1.0 + (radius / r_a) ** 2)[:, None]
        vel = speed[:, None] * (mu * rhat + (u - mu * rhat) / gamma)

    fields = OrderedDict()
    fields[short, "particle_position"] = pos
    fields[short, "particle_velocity"] = vel
    fields[short, "particle_mass"] = torch.full_like(radius,
                                                     mtot / num_particles)
    if compute_potential:
        # exact-radius evaluation for the OUTPUT potential (the lerped
        # psi_p above only bounds the escape-speed cap)
        psi_sub = _spline_at(rgrid, tables["loguniform"], psi_sp,
                             radius_sub)
        fields[short, "particle_potential"] = -_tile(psi_sub, sub_sample,
                                                     num_particles)
    return ClusterParticles(short, fields, device=dev)
