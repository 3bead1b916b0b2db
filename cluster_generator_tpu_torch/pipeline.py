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
from .core.grid import linspace
from .core.interp import interp, interp_monotone
from .parallel.ensemble import build_one_cluster
from .virial import (_banded_row_lerp, compute_df, speed_inverse_cdf_table,
                     speed_table_defaults)

__all__ = ["build_merger_models", "speed_table_inputs", "build_speed_tables",
           "build_radius_tables", "sample_merger_ic", "merger_ic_fused",
           "binary_merger_ic"]

_RQ = 2048  # radius quantile-table resolution


def _f64(x, device):
    return torch.as_tensor(np.asarray(x, dtype=np.float64)
                           if not isinstance(x, torch.Tensor) else x,
                           dtype=torch.float64, device=device)


def build_merger_models(M200, conc, z=0.1, num_points=1000,
                        with_star_df=True, r_a=None, gravity="newtonian",
                        device="cuda"):
    """Equilibrium fields plus DM (``dm_df``) and stellar (``star_df``) DFs
    for each halo: every field is (H, num_points) float64.  Ergodic only
    (``r_a=None``)."""
    if r_a is not None:
        raise NotImplementedError("Osipkov-Merritt anisotropy (r_a) is not "
                                  "ported yet")
    dev = resolve_device(device)
    M200 = _f64(M200, dev)
    conc = _f64(conc, dev)
    fields = build_one_cluster(M200, conc, z=z, num_points=num_points,
                               with_df=True, gravity=gravity)
    if with_star_df:
        ee = -torch.flip(fields["gravitational_potential"], (-1,))
        sden = torch.flip(fields["stellar_density"], (-1,))
        fields["star_df"] = torch.flip(compute_df(ee, sden), (-1,))
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

    return {"dm": dict(kw, ee=ee, f_vals=torch.flip(fields["dm_df"], (-1,)),
                       row_ee=row_energies(n_rows)),
            "star": dict(kw_star, ee=ee,
                         f_vals=torch.flip(fields["star_df"], (-1,)),
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
    """Fractional index of ``radius`` on the log-spaced grid ``rr``,
    computed, not searched.  ``n`` relocates onto an n-point log grid with
    ``rr``'s endpoints."""
    if n is None:
        n = rr.shape[-1]
    logr0 = torch.log(rr[0]).to(dtype)
    dlog = ((torch.log(rr[-1]) - torch.log(rr[0])) / (n - 1)).to(dtype)
    x = (torch.log(radius) - logr0) / dlog
    x = torch.clamp(x, 0.0, n - 1 - 1e-6)
    # integer clamp too: in float32 the 1e-6 margin is below the ulp at
    # n - 1 for n >= ~32, so x can still round to exactly n - 1
    j = torch.clamp_max(x.to(torch.int64), n - 2)
    return j, x - j.to(dtype)


def _table_lerp(table, u):
    """1D lerp of ``table`` at fractional positions u in [0, 1]."""
    n = table.shape[0]
    x = torch.clamp(u * (n - 1), 0.0, n - 1 - 1e-6)
    j = torch.clamp_max(x.to(torch.int64), n - 2)  # float32 ulp guard
    w = x - j.to(table.dtype)
    return (1.0 - w) * table[j] + w * table[j + 1]


def _uniform(gen, n, dtype, device, lo=0.0, hi=1.0):
    u = torch.rand(n, generator=gen, dtype=dtype, device=device)
    if (lo, hi) != (0.0, 1.0):
        u = u * (hi - lo) + lo
    return u


def _isotropic(n, dtype, device, gen=None, uniforms=None):
    """Unit vectors (n, 3) uniform on the sphere; ``uniforms`` is
    ``(cos_theta in [-1, 1), u_phi in [0, 1))``."""
    if uniforms is None:
        cos_t = _uniform(gen, n, dtype, device, -1.0, 1.0)
        u_phi = _uniform(gen, n, dtype, device)
    else:
        cos_t, u_phi = uniforms
    phi = (2.0 * math.pi) * u_phi
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    return torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi),
                        cos_t], dim=-1)


def _build_joint_speed_pairs(fields_h, s_inv, r_q, dtype):
    """The per-psi speed-fraction table folded onto the radius-quantile
    nodes as ABSOLUTE speeds: (RQ, n_q), row k at radius r_q[k], times
    v_esc = sqrt(2 psi) there."""
    rr = fields_h["radius"]
    psi_r = (-fields_h["gravitational_potential"]).to(dtype)
    j, w = _log_grid_locate(r_q, rr, dtype)
    psi_q = (1.0 - w) * psi_r[j] + w * psi_r[j + 1]
    n_rows = s_inv.shape[0]
    # s_inv rows ascend in energy = row radii DESCENDING on an n_rows-point
    # log grid: the bracketing rows are (n-2-jr, n-1-jr), weight (1 - wr)
    jr, wr = _log_grid_locate(r_q, rr, dtype, n=n_rows)
    k_row = torch.clamp(n_rows - 2 - jr, 0, n_rows - 2)
    srow = _banded_row_lerp(s_inv.to(dtype), k_row, (1.0 - wr))
    return srow * torch.sqrt(2.0 * psi_q)[:, None]


def _sample_collisionless(fields_h, s_inv, r_q, m_rmax, n, center, bulk_v,
                          dtype, gen=None, uniforms=None):
    """Positions, velocities and masses of one halo's DM or stars.

    Radius: lerp on the radius-quantile table.  Speed: lerp along the
    quantile axis of the joint absolute-speed table, in one of the two
    rows bracketing the radius, picked by a Bernoulli draw on the radius
    lerp weight.  ``uniforms``: ``(u_radius, u_speed, u_row,
    pos_dir, vel_dir)`` with each ``*_dir`` a pair for :func:`_isotropic`.
    """
    dev = r_q.device
    if uniforms is None:
        u_r = _uniform(gen, n, dtype, dev)
        u_q = _uniform(gen, n, dtype, dev)
        u_b = _uniform(gen, n, dtype, dev)
        pos_dir = vel_dir = None
    else:
        u_r, u_q, u_b, pos_dir, vel_dir = uniforms
    rq = r_q.to(dtype)
    RQ = rq.shape[0]
    n_q = s_inv.shape[1]
    joint = _build_joint_speed_pairs(fields_h, s_inv, rq, dtype).reshape(-1)

    x = torch.clamp(u_r * (RQ - 1), 0.0, RQ - 1 - 1e-6)
    kq = torch.clamp_max(x.to(torch.int64), RQ - 2)  # float32 ulp guard
    wq = x - kq.to(dtype)
    radius = (1.0 - wq) * rq[kq] + wq * rq[kq + 1]

    qm = torch.clamp(u_q * (n_q - 1), 0.0, n_q - 1 - 1e-6)
    m = torch.clamp_max(qm.to(torch.int64), n_q - 2)  # float32 ulp guard
    wm = qm - m.to(dtype)
    k_row = kq + (u_b < wq).to(torch.int64)
    flat = k_row * n_q + m
    speed = (1.0 - wm) * joint[flat] + wm * joint[flat + 1]

    rhat = _isotropic(n, dtype, dev, gen, pos_dir)
    pos = radius[:, None] * rhat + center.to(dtype)
    vdir = _isotropic(n, dtype, dev, gen, vel_dir)
    vel = speed[:, None] * vdir + bulk_v.to(dtype)
    pmass = (m_rmax / n).to(dtype).expand(n).contiguous()
    return pos, vel, pmass


def _sample_gas_halo(fields_h, r_q, m_rmax, n, center, dtype, gen=None,
                     uniforms=None):
    """Gas positions (zero velocity before mixing) for one halo.
    ``uniforms``: ``(u_radius, dir)``."""
    dev = r_q.device
    if uniforms is None:
        u = _uniform(gen, n, dtype, dev)
        direction = None
    else:
        u, direction = uniforms
    radius = _table_lerp(r_q.to(dtype), u)
    pos = (radius[:, None] * _isotropic(n, dtype, dev, gen, direction)
           + center.to(dtype))
    pmass = (m_rmax / n).to(dtype).expand(n).contiguous()
    return pos, pmass


def _mix_gas(pos, fields, centers, velocities, dtype):
    """Density-weighted gas mixing over all halos: each particle's density,
    specific thermal energy and velocity are the density-weighted sums of
    every halo's lerped fields (radii beyond the grid clamp to its end)."""
    H = centers.shape[0]
    dens_t = fields["density"].to(dtype)
    e_t = (1.5 * fields["pressure"] / fields["density"]).to(dtype)
    de_t = dens_t * e_t
    dens = eint = mom = None
    for i in range(H):
        r = torch.sqrt(((pos - centers[i].to(dtype)) ** 2).sum(dim=1))
        j, w = _log_grid_locate(r, fields["radius"][i], dtype)
        d = (1.0 - w) * dens_t[i][j] + w * dens_t[i][j + 1]
        e = (1.0 - w) * de_t[i][j] + w * de_t[i][j + 1]
        v = velocities[i].to(dtype)[None, :] * d[:, None]
        if dens is None:
            dens, eint, mom = d, e, v
        else:
            dens, eint, mom = dens + d, eint + e, mom + v
    return dens, eint / dens, mom / dens[:, None]


def sample_merger_ic(fields, tables, centers, velocities, r_max, n_gas, n_dm,
                     n_star, dtype=torch.float32, generator=None,
                     uniforms=None):
    """Draw every particle of an H-halo merger.

    ``fields``/``tables`` carry the leading halo axis; ``tables`` holds the
    speed tables ("dm"/"star") and ``tables["radius"]`` from
    :func:`build_radius_tables`.  ``n_*``: per-halo counts.  ``generator``
    is a ``torch.Generator`` on the tensors' device.  ``uniforms``
    (optional) maps ``("gas" | "dm" | "star", halo)`` to that draw's
    pre-drawn uniforms (see :func:`_sample_gas_halo` and
    :func:`_sample_collisionless`).  Returns a dict keyed like the JAX
    package's, e.g. ``("gas", "particle_position")``.
    """
    dev = fields["radius"].device
    centers = _f64(centers, dev)
    velocities = _f64(velocities, dev)
    H = centers.shape[0]
    if generator is None and uniforms is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    uniforms = uniforms or {}
    rtab = tables["radius"]
    out = {}
    gas_pos, gas_mass = [], []
    dm = ([], [], [])
    st = ([], [], [])
    for i in range(H):
        f_h = {k: v[i] for k, v in fields.items()}
        if n_gas[i] > 0:
            p, pm = _sample_gas_halo(f_h, rtab["gas"][i], rtab["gas_mtot"][i],
                                     n_gas[i], centers[i], dtype, generator,
                                     uniforms.get(("gas", i)))
            gas_pos.append(p)
            gas_mass.append(pm)
        for kind, n_k, acc in (("dm", n_dm, dm), ("star", n_star, st)):
            if n_k[i] > 0:
                res = _sample_collisionless(
                    f_h, tables[kind][i], rtab[kind][i],
                    rtab[kind + "_mtot"][i], n_k[i], centers[i],
                    velocities[i], dtype, generator,
                    uniforms.get((kind, i)))
                for a, x in zip(acc, res):
                    a.append(x)

    if gas_pos:
        gp = torch.cat(gas_pos)
        dens, eint, gvel = _mix_gas(gp, fields, centers, velocities, dtype)
        out["gas", "particle_position"] = gp
        out["gas", "particle_velocity"] = gvel
        out["gas", "particle_mass"] = torch.cat(gas_mass)
        out["gas", "density"] = dens
        out["gas", "thermal_energy"] = eint
    for kind, acc in (("dm", dm), ("star", st)):
        if acc[0]:
            out[kind, "particle_position"] = torch.cat(acc[0])
            out[kind, "particle_velocity"] = torch.cat(acc[1])
            out[kind, "particle_mass"] = torch.cat(acc[2])
    return out


def merger_ic_fused(M200, conc, centers, velocities, r_max, n_gas, n_dm,
                    n_star, z=0.1, num_points=1000, dtype=torch.float32,
                    generator=None, uniforms=None, device="cuda"):
    """The whole merger IC: models, DFs, tables and every particle draw.

    Returns ``(particles, fields)``.  ``generator``: a ``torch.Generator``
    on ``device`` (default: one seeded with 0).
    """
    fields = build_merger_models(M200, conc, z=z, num_points=num_points,
                                 device=device)
    tables = build_speed_tables(fields)
    tables["radius"] = build_radius_tables(fields, r_max)
    parts = sample_merger_ic(fields, tables, centers, velocities, r_max,
                             n_gas, n_dm, n_star, dtype=dtype,
                             generator=generator, uniforms=uniforms)
    return parts, fields


def binary_merger_ic(M200s, concs, centers, velocities, num_particles,
                     r_max=5000.0, z=0.1, generator=None, num_points=1000,
                     dtype=torch.float32, device="cuda"):
    """End-to-end binary (or 1-3 halo) merger IC on one device.

    ``num_particles``: total counts such as ``{"gas": 5_000_000, "dm":
    4_000_000, "star": 1_000_000}``, pro-rated per halo by the mass inside
    ``r_max``.  Returns ``(particles, fields, tables)``.
    """
    if num_particles.get("tracer"):
        raise NotImplementedError("tracer particles are not ported yet")
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
                                 device=dev)
    tables = build_speed_tables(fields)
    tables["radius"] = build_radius_tables(fields, r_max)

    # pro-rate counts by per-halo mass within r_max (host-side)
    rr = fields["radius"].cpu().numpy()
    rm = r_max.cpu().numpy()
    weights = {}
    for kind, mkey in [("gas", "gas_mass"), ("dm", "dark_matter_mass"),
                       ("star", "stellar_mass")]:
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

    particles = sample_merger_ic(fields, tables, centers, velocities, r_max,
                                 counts("gas"), counts("dm"), counts("star"),
                                 dtype=dtype, generator=generator)
    return particles, fields, tables
