"""The fused binary-merger IC: cluster parameters to particle arrays.

Four stages, each a function of tensors on one device:

1. :func:`build_merger_models` — equilibrium fields and the DM and stellar
   DFs of every halo (float64, leading halo axis H);
2. :func:`build_speed_tables` — inverse speed-CDF tables per halo (float32;
   the inversion is kernel K1, one launch per species for all halos);
3. :func:`build_radius_tables` — inverse radius-CDF quantile tables;
4. :func:`sample_merger_ic` — the particle draws (float32) and the
   density-weighted gas mixing.

:func:`merger_ic_fused` runs all four; :func:`binary_merger_ic` adds the
mass-prorated particle counts.  Entry points run on the card unless called
with ``device="cpu"``.  Draws take a ``torch.Generator``; each draw
function also accepts pre-drawn uniforms (``uniforms``), the values a
caller wants at each random site, so that draws can be compared with
another generator's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .core.device import resolve_device
from .core.draws import isotropic, uniform
from .core.grid import linspace
from .core.interp import _gather, interp, interp_monotone
from .parallel.ensemble import build_one_cluster
from .virial import (_banded_row_lerp, compute_df, om_extended_df,
                     speed_inverse_cdf_table, speed_table_defaults)

__all__ = ["build_merger_models", "speed_table_inputs", "build_speed_tables",
           "build_radius_tables", "sample_merger_ic", "merger_ic_fused",
           "binary_merger_ic", "attach_field_to_particles"]

_RQ = 2048  # radius quantile-table resolution


def _f64(x, device):
    return torch.as_tensor(np.asarray(x, dtype=np.float64)
                           if not isinstance(x, torch.Tensor) else x,
                           dtype=torch.float64, device=device)


def build_merger_models(M200, conc, z=0.1, num_points=1000,
                        with_star_df=True, r_a=None, gravity="newtonian",
                        device="cuda"):
    """Equilibrium fields plus DM (``dm_df``) and stellar (``star_df``) DFs
    for each halo: every field is (H, num_points) float64.

    ``r_a``: Osipkov-Merritt anisotropy radius (kpc).  The DFs become f(Q)
    of the AUGMENTED density rho_Q = (1 + r^2/r_a^2) rho, inverted on the
    power-law-extended energy grid (:func:`~.virial.om_extended_df`); the
    extended grid and DFs come back as ``df_ee_ext``, ``dm_df_ext`` and
    ``star_df_ext`` (H, 192 + num_points), which
    :func:`build_speed_tables` uses.  ``None``: ergodic."""
    if r_a is not None and not float(r_a) > 0.0:
        raise ValueError(f"r_a must be positive (got {r_a!r}); None gives "
                         "the isotropic model")
    dev = resolve_device(device)
    M200 = _f64(M200, dev)
    conc = _f64(conc, dev)
    fields = build_one_cluster(M200, conc, z=z, num_points=num_points,
                               with_df=(r_a is None), gravity=gravity)
    ee = -torch.flip(fields["gravitational_potential"], (-1,))
    n = ee.shape[-1]
    aug = 1.0 if r_a is None else 1.0 + (fields["radius"] / r_a) ** 2
    if r_a is not None:
        ee_ext, dm_ext = om_extended_df(
            ee, torch.flip(fields["dark_matter_density"] * aug, (-1,)))
        fields["df_ee_ext"] = ee_ext
        fields["dm_df_ext"] = dm_ext
        fields["dm_df"] = torch.flip(dm_ext[..., -n:], (-1,))
    if with_star_df:
        sden = torch.flip(fields["stellar_density"] * aug, (-1,))
        if r_a is None:
            fields["star_df"] = torch.flip(compute_df(ee, sden), (-1,))
        else:
            _, st_ext = om_extended_df(ee, sden)
            fields["star_df_ext"] = st_ext
            fields["star_df"] = torch.flip(st_ext[..., -n:], (-1,))
    return fields


def speed_table_inputs(fields, n_rows=256, star_n_rows=64):
    """Arguments of :func:`speed_inverse_cdf_table` for each species:
    ``{"dm": kwargs, "star": kwargs}``.

    Rows sit on an ``n_rows``-point log-radius grid sharing the model
    grid's endpoints, ordered by ascending energy (``None``: one row per
    grid point).  Stars use n_s and n_q capped at 256 and ``star_n_rows``
    rows; ``star_n_rows=None`` gives stars the DM resolutions.
    """
    ee = -torch.flip(fields["gravitational_potential"], (-1,))
    rr = fields["radius"]
    kw = speed_table_defaults()
    kw_star = dict(kw, n_s=min(kw.get("n_s", 1024), 256),
                   n_q=min(kw.get("n_q", 512), 256))
    if star_n_rows is None:
        star_rows, kw_star = n_rows, kw
    else:
        star_rows = star_n_rows

    def row_energies(rows):
        if rows is None:
            return ee
        logr = torch.log(rr)
        r_rows = torch.exp(linspace(logr[..., 0], logr[..., -1], rows))
        psi = torch.flip(ee, (-1,))
        return torch.flip(interp(r_rows, rr, psi), (-1,))

    if "df_ee_ext" in fields:
        # OM: f(Q) is splined over the extended grid (rows near r_max
        # query E below the model grid's lowest energy)
        sp_ee = fields["df_ee_ext"]
        f_dm, f_star = fields["dm_df_ext"], fields["star_df_ext"]
    else:
        sp_ee = ee
        f_dm = torch.flip(fields["dm_df"], (-1,))
        f_star = torch.flip(fields["star_df"], (-1,))
    return {"dm": dict(kw, ee=sp_ee, f_vals=f_dm,
                       row_ee=row_energies(n_rows)),
            "star": dict(kw_star, ee=sp_ee, f_vals=f_star,
                         row_ee=row_energies(star_rows))}


def build_speed_tables(fields, n_rows=256, star_n_rows=64):
    """Per-halo inverse speed-CDF tables: ``{"dm": (H, n_rows, n_q),
    "star": (H, star_n_rows, n_q_star)}`` float32, one K1 launch per
    species (see :func:`speed_table_inputs`)."""
    return {kind: speed_inverse_cdf_table(**kw) for kind, kw in
            speed_table_inputs(fields, n_rows, star_n_rows).items()}


def build_radius_tables(fields, r_max, dtype=torch.float32):
    """Per-halo inverse radius-CDF tables for every species: ``tables[kind]``
    is (H, 2048) radii at uniform mass quantiles (clamped at ``r_max``),
    ``tables[kind + "_mtot"]`` the (H,) mass inside ``r_max``."""
    rr = fields["radius"]
    r_max = _f64(r_max, rr.device).expand(rr.shape[:-1])
    q = linspace(0.0, 1.0, _RQ, device=rr.device)
    zero = torch.zeros_like(rr[..., :1])
    rins = torch.cat([zero, rr], dim=-1)
    out = {}
    for kind, key in [("gas", "gas_mass"), ("dm", "dark_matter_mass"),
                      ("star", "stellar_mass")]:
        mm = fields[key]
        m_rmax = interp(r_max[..., None], rr, mm)[..., 0]
        P = torch.clamp(mm / m_rmax[..., None], 0.0, 1.0)
        P = torch.cat([zero, P], dim=-1)
        # clamp at r_max: beyond it P plateaus at 1, and the top quantile
        # bin would otherwise reach out along the plateau
        r_q = torch.minimum(interp_monotone(q.expand(P.shape[:-1] + q.shape),
                                            P, rins), r_max[..., None])
        out[kind] = r_q.to(dtype)
        out[kind + "_mtot"] = m_rmax
    return out


def _log_grid_locate(radius, rr, dtype, n=None):
    """Fractional index of ``radius`` (..., m) on the log-spaced grid ``rr``
    (..., N), computed, not searched.  ``n`` relocates onto an n-point log
    grid with ``rr``'s endpoints."""
    if n is None:
        n = rr.shape[-1]
    logr0 = torch.log(rr[..., :1]).to(dtype)
    dlog = ((torch.log(rr[..., -1:]) - torch.log(rr[..., :1]))
            / (n - 1)).to(dtype)
    x = (torch.log(radius) - logr0) / dlog
    x = torch.clamp(x, 0.0, n - 1 - 1e-6)
    # integer clamp too: in float32 the 1e-6 margin is below the ulp at
    # n - 1 for n >= ~32, so x can still round to exactly n - 1
    j = torch.clamp_max(x.to(torch.int64), n - 2)
    return j, x - j.to(dtype)


def _table_lerp(table, u):
    """Lerp of ``table`` (..., n) at fractional positions u in [0, 1]."""
    n = table.shape[-1]
    x = torch.clamp(u * (n - 1), 0.0, n - 1 - 1e-6)
    j = torch.clamp_max(x.to(torch.int64), n - 2)  # float32 ulp guard
    w = x - j.to(table.dtype)
    return (1.0 - w) * _gather(table, j) + w * _gather(table, j + 1)


def _build_joint_speed_pairs(fields_h, s_inv, r_q, dtype):
    """The per-psi speed-fraction table folded onto the radius-quantile
    nodes as ABSOLUTE speeds: (RQ, n_q), row k at radius r_q[k], times
    v_esc = sqrt(2 psi) there."""
    rr = fields_h["radius"]
    psi_r = (-fields_h["gravitational_potential"]).to(dtype)
    j, w = _log_grid_locate(r_q, rr, dtype)
    psi_q = (1.0 - w) * _gather(psi_r, j) + w * _gather(psi_r, j + 1)
    n_rows = s_inv.shape[-2]
    # s_inv rows ascend in energy = row radii DESCENDING on an n_rows-point
    # log grid: the bracketing rows are (n-2-jr, n-1-jr), weight (1 - wr)
    jr, wr = _log_grid_locate(r_q, rr, dtype, n=n_rows)
    k_row = torch.clamp(n_rows - 2 - jr, 0, n_rows - 2)
    srow = _banded_row_lerp(s_inv.to(dtype), k_row, (1.0 - wr))
    return srow * torch.sqrt(2.0 * psi_q)[..., None]


def _sample_collisionless(fields_h, s_inv, r_q, m_rmax, n, center, bulk_v,
                          dtype, gen=None, uniforms=None, r_a=None):
    """Positions, velocities and masses of one halo's DM or stars.

    Radius: lerp on the radius-quantile table.  Speed: lerp along the
    quantile axis of the joint absolute-speed table, in one of the two
    rows bracketing the radius, picked by a Bernoulli draw on the radius
    lerp weight.  ``r_a``: the speed tables are then those of the
    OM-augmented f(Q), isotropic in (v_r, gamma v_t), and the draw maps
    back by dividing the velocity's tangential components by
    gamma(r) = sqrt(1 + r^2/r_a^2).  ``uniforms``: ``(u_radius, u_speed,
    u_row, pos_dir, vel_dir)`` with each ``*_dir`` a pair for
    :func:`~.core.draws.isotropic`.  Every argument may carry leading
    batch axes (one scene each); the draws are then ``batch + (n,)``.
    """
    dev = r_q.device
    shape = r_q.shape[:-1] + (n,)
    if uniforms is None:
        u_r = uniform(gen, shape, dtype, dev)
        u_q = uniform(gen, shape, dtype, dev)
        u_b = uniform(gen, shape, dtype, dev)
        pos_dir = vel_dir = None
    else:
        u_r, u_q, u_b, pos_dir, vel_dir = uniforms
    rq = r_q.to(dtype)
    RQ = rq.shape[-1]
    n_q = s_inv.shape[-1]
    joint = _build_joint_speed_pairs(fields_h, s_inv, rq, dtype).flatten(-2)

    x = torch.clamp(u_r * (RQ - 1), 0.0, RQ - 1 - 1e-6)
    kq = torch.clamp_max(x.to(torch.int64), RQ - 2)  # float32 ulp guard
    wq = x - kq.to(dtype)
    radius = (1.0 - wq) * _gather(rq, kq) + wq * _gather(rq, kq + 1)

    qm = torch.clamp(u_q * (n_q - 1), 0.0, n_q - 1 - 1e-6)
    m = torch.clamp_max(qm.to(torch.int64), n_q - 2)  # float32 ulp guard
    wm = qm - m.to(dtype)
    k_row = kq + (u_b < wq).to(torch.int64)
    flat = k_row * n_q + m
    speed = (1.0 - wm) * _gather(joint, flat) + wm * _gather(joint, flat + 1)

    rhat = isotropic(shape, dtype, dev, gen, pos_dir)
    pos = radius[..., None] * rhat + center.to(dtype)[..., None, :]
    vdir = isotropic(shape, dtype, dev, gen, vel_dir)
    if r_a is not None:
        mu = torch.sum(vdir * rhat, dim=-1, keepdim=True)
        gamma = torch.sqrt(1.0 + (radius / r_a) ** 2)
        vdir = mu * rhat + (vdir - mu * rhat) / gamma[..., None]
    vel = speed[..., None] * vdir + bulk_v.to(dtype)[..., None, :]
    pmass = (m_rmax / n).to(dtype)[..., None].expand(shape).contiguous()
    return pos, vel, pmass


def _sample_gas_halo(fields_h, r_q, m_rmax, n, center, dtype, gen=None,
                     uniforms=None):
    """Gas positions (zero velocity before mixing) for one halo, with any
    leading batch axes.  ``uniforms``: ``(u_radius, dir)``."""
    dev = r_q.device
    shape = r_q.shape[:-1] + (n,)
    if uniforms is None:
        u = uniform(gen, shape, dtype, dev)
        direction = None
    else:
        u, direction = uniforms
    radius = _table_lerp(r_q.to(dtype), u)
    pos = (radius[..., None] * isotropic(shape, dtype, dev, gen, direction)
           + center.to(dtype)[..., None, :])
    pmass = (m_rmax / n).to(dtype)[..., None].expand(shape).contiguous()
    return pos, pmass


def _mix_gas(pos, fields, centers, velocities, dtype):
    """Density-weighted gas mixing over all halos: each particle's density,
    specific thermal energy and velocity are the density-weighted sums of
    every halo's lerped fields (radii beyond the grid clamp to its end).
    ``pos`` (..., n, 3), ``fields`` (..., H, N), ``centers`` and
    ``velocities`` (..., H, 3): the halos of each scene mix with each
    other only."""
    H = centers.shape[-2]
    dens_t = fields["density"].to(dtype)
    e_t = (1.5 * fields["pressure"] / fields["density"]).to(dtype)
    de_t = dens_t * e_t
    dens = eint = mom = None
    for i in range(H):
        r = torch.sqrt(((pos - centers[..., i, None, :].to(dtype)) ** 2)
                       .sum(dim=-1))
        j, w = _log_grid_locate(r, fields["radius"][..., i, :], dtype)
        d_i, de_i = dens_t[..., i, :], de_t[..., i, :]
        d = (1.0 - w) * _gather(d_i, j) + w * _gather(d_i, j + 1)
        e = (1.0 - w) * _gather(de_i, j) + w * _gather(de_i, j + 1)
        v = velocities[..., i, None, :].to(dtype) * d[..., None]
        if dens is None:
            dens, eint, mom = d, e, v
        else:
            dens, eint, mom = dens + d, eint + e, mom + v
    return dens, eint / dens, mom / dens[..., None]


def _potential_at(pos, fields, centers, dtype):
    """Total gravitational potential at particle positions: the sum of
    every halo's radial Phi(r), lerped on the log grid's computed index."""
    phi_t = fields["gravitational_potential"].to(dtype)
    total = None
    for i in range(centers.shape[-2]):
        r = torch.sqrt(((pos - centers[..., i, None, :].to(dtype)) ** 2)
                       .sum(dim=-1))
        j, w = _log_grid_locate(r, fields["radius"][..., i, :], dtype)
        phi_i = phi_t[..., i, :]
        p = (1.0 - w) * _gather(phi_i, j) + w * _gather(phi_i, j + 1)
        total = p if total is None else total + p
    return total


def sample_merger_ic(fields, tables, centers, velocities, r_max, n_gas, n_dm,
                     n_star, n_tracer=None, dtype=torch.float32,
                     compute_potential=False, r_a=None, generator=None,
                     uniforms=None):
    """Draw every particle of an H-halo merger.

    ``fields``/``tables`` carry the leading halo axis; ``tables`` holds the
    speed tables ("dm"/"star") and ``tables["radius"]`` from
    :func:`build_radius_tables`.  ``n_*``: per-halo counts; ``n_tracer``
    (optional) adds massless tracers at rest that follow the gas
    distribution.  ``compute_potential`` adds each gas, DM and star
    particle's total gravitational potential (``"particle_potential"``).
    ``r_a``: Osipkov-Merritt anisotropy radius; the speed tables must then
    come from ``build_merger_models(r_a=...)``.  ``generator`` is a
    ``torch.Generator`` on the tensors' device.  ``uniforms`` (optional)
    maps ``("gas" | "dm" | "star" | "tracer", halo)`` to that draw's
    pre-drawn uniforms (see :func:`_sample_gas_halo` and
    :func:`_sample_collisionless`).  Returns a dict keyed like the JAX
    package's, e.g. ``("gas", "particle_position")``.

    Leading batch axes (one scene each) before the halo axis of
    ``fields``, ``tables``, ``centers`` and ``velocities`` carry through:
    each output is then ``batch + (n, ...)`` and the uniforms are
    ``batch + (n,)``.
    """
    dev = fields["radius"].device
    centers = _f64(centers, dev)
    velocities = _f64(velocities, dev)
    H = centers.shape[-2]
    if generator is None and uniforms is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    uniforms = uniforms or {}
    rtab = tables["radius"]
    if n_tracer is None:
        n_tracer = (0,) * H
    out = {}
    tr_pos = []
    gas_pos, gas_mass = [], []
    dm = ([], [], [])
    st = ([], [], [])
    for i in range(H):
        f_h = {k: v[..., i, :] for k, v in fields.items()}
        gas_q, gas_m = rtab["gas"][..., i, :], rtab["gas_mtot"][..., i]
        ctr, bulk = centers[..., i, :], velocities[..., i, :]
        if n_gas[i] > 0:
            p, pm = _sample_gas_halo(f_h, gas_q, gas_m, n_gas[i], ctr, dtype,
                                     generator, uniforms.get(("gas", i)))
            gas_pos.append(p)
            gas_mass.append(pm)
        for kind, n_k, acc in (("dm", n_dm, dm), ("star", n_star, st)):
            if n_k[i] > 0:
                res = _sample_collisionless(
                    f_h, tables[kind][..., i, :, :], rtab[kind][..., i, :],
                    rtab[kind + "_mtot"][..., i], n_k[i], ctr, bulk, dtype,
                    generator, uniforms.get((kind, i)), r_a=r_a)
                for a, x in zip(acc, res):
                    a.append(x)
        if n_tracer[i] > 0:
            p, _ = _sample_gas_halo(f_h, gas_q, gas_m, n_tracer[i], ctr, dtype,
                                    generator, uniforms.get(("tracer", i)))
            tr_pos.append(p)

    if gas_pos:
        gp = torch.cat(gas_pos, dim=-2)
        dens, eint, gvel = _mix_gas(gp, fields, centers, velocities, dtype)
        out["gas", "particle_position"] = gp
        out["gas", "particle_velocity"] = gvel
        out["gas", "particle_mass"] = torch.cat(gas_mass, dim=-1)
        out["gas", "density"] = dens
        out["gas", "thermal_energy"] = eint
    for kind, acc in (("dm", dm), ("star", st)):
        if acc[0]:
            out[kind, "particle_position"] = torch.cat(acc[0], dim=-2)
            out[kind, "particle_velocity"] = torch.cat(acc[1], dim=-2)
            out[kind, "particle_mass"] = torch.cat(acc[2], dim=-1)
    if tr_pos:
        tp = torch.cat(tr_pos, dim=-2)
        out["tracer", "particle_position"] = tp
        out["tracer", "particle_velocity"] = torch.zeros_like(tp)
        out["tracer", "particle_mass"] = torch.zeros(tp.shape[:-1],
                                                     dtype=dtype, device=dev)
    if compute_potential:
        for sp in ("gas", "dm", "star"):
            if (sp, "particle_position") in out:
                out[sp, "particle_potential"] = _potential_at(
                    out[sp, "particle_position"], fields, centers, dtype)
    return out


def merger_ic_fused(M200, conc, centers, velocities, r_max, n_gas, n_dm,
                    n_star, n_tracer=None, z=0.1, num_points=1000,
                    dtype=torch.float32, compute_potential=False, r_a=None,
                    gravity="newtonian", generator=None, uniforms=None,
                    device="cuda"):
    """The whole merger IC: models, DFs, tables and every particle draw.

    Returns ``(particles, fields)``.  ``n_tracer``, ``compute_potential``
    and ``r_a`` as in :func:`sample_merger_ic` and
    :func:`build_merger_models`.  ``generator``: a ``torch.Generator`` on
    ``device`` (default: one seeded with 0).
    """
    fields = build_merger_models(M200, conc, z=z, num_points=num_points,
                                 r_a=r_a, gravity=gravity, device=device)
    tables = build_speed_tables(fields)
    tables["radius"] = build_radius_tables(fields, r_max)
    parts = sample_merger_ic(fields, tables, centers, velocities, r_max,
                             n_gas, n_dm, n_star, n_tracer=n_tracer,
                             dtype=dtype, compute_potential=compute_potential,
                             r_a=r_a, generator=generator, uniforms=uniforms)
    return parts, fields


def attach_field_to_particles(parts: dict, field, ptype: str = "gas"):
    """Trilinear sample of a 3D field (:class:`~.fields.ClusterField`) at
    the particle positions of ``ptype``, in the positions' dtype, on their
    device: adds ``(ptype, field._name)`` of shape (N, 3) to ``parts`` and
    returns it."""
    from .fields.grf import _trilinear

    pos = parts[ptype, "particle_position"]
    g = torch.stack([field.gx, field.gy, field.gz]).to(pos.dtype)
    vals = _trilinear(field.x.to(pos.dtype), field.y.to(pos.dtype),
                      field.z.to(pos.dtype), g, pos)
    parts[ptype, field._name] = vals.T
    return parts


def binary_merger_ic(M200s, concs, centers, velocities, num_particles,
                     r_max=5000.0, z=0.1, generator=None, num_points=1000,
                     dtype=torch.float32, r_a=None, device="cuda"):
    """End-to-end binary (or 1-3 halo) merger IC on one device.

    ``num_particles``: total counts such as ``{"gas": 5_000_000, "dm":
    4_000_000, "star": 1_000_000}`` (optionally ``"tracer"``, which
    follows the gas), pro-rated per halo by the mass inside ``r_max``.
    ``r_a``: Osipkov-Merritt anisotropy radius.  Returns ``(particles,
    fields, tables)``.
    """
    dev = resolve_device(device)
    M200s = _f64(M200s, dev)
    H = M200s.shape[0]
    centers = _f64(centers, dev).reshape(H, 3)
    velocities = _f64(velocities, dev).reshape(H, 3)
    if np.isscalar(r_max):
        r_max = torch.full((H,), float(r_max), dtype=torch.float64,
                           device=dev)
    else:
        r_max = _f64(r_max, dev)

    fields = build_merger_models(M200s, concs, z=z, num_points=num_points,
                                 r_a=r_a, device=dev)
    tables = build_speed_tables(fields)
    tables["radius"] = build_radius_tables(fields, r_max)

    # pro-rate counts by per-halo mass within r_max (host-side)
    rr = fields["radius"].cpu().numpy()
    rm = r_max.cpu().numpy()
    weights = {}
    for kind, mkey in [("gas", "gas_mass"), ("dm", "dark_matter_mass"),
                       ("star", "stellar_mass"), ("tracer", "gas_mass")]:
        mm = fields[mkey].cpu().numpy()
        m_at = np.array([np.interp(float(rm[i]), rr[i], mm[i])
                         for i in range(H)])
        weights[kind] = m_at / m_at.sum()

    def counts(kind):
        tot = num_particles.get(kind, 0)
        n = [int(round(tot * weights[kind][i])) for i in range(H)]
        if n and tot:
            n[-1] = tot - sum(n[:-1])
        return tuple(n)

    particles = sample_merger_ic(
        fields, tables, centers, velocities, r_max, counts("gas"),
        counts("dm"), counts("star"),
        n_tracer=counts("tracer") if num_particles.get("tracer") else None,
        dtype=dtype, r_a=r_a, generator=generator)
    return particles, fields, tables
