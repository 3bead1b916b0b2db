"""The fused binary-merger IC: cluster parameters to particle arrays.

Four stages, each a function of tensors on one device:

1. :func:`build_merger_models` — equilibrium fields and the DM and stellar
   DFs of every halo (float64, leading halo axis H);
2. :func:`build_speed_tables` — inverse speed-CDF tables per halo (float32;
   the inversion is kernel K1, one launch per species for all halos);
3. :func:`build_radius_tables` — inverse radius-CDF quantile tables;
4. :func:`sample_merger_ic` — the particle draws (float32) and the
   density-weighted gas mixing.

:func:`merger_ic_fused` runs all four as one program: on the card a CUDA
graph, captured once per configuration and memoized
(:mod:`.core.compiled`), on the CPU its eager body.  Each stage called on
its own is a program too, as the JAX package jits each
(:func:`.core.compiled.function`).  :func:`binary_merger_ic` runs the
four stage programs and between them the mass-prorated particle counts
(on the host: its counts come from the models).  Entry points run on the
card unless called with ``device="cpu"``.  Draws take a
``torch.Generator``; each draw function also accepts pre-drawn uniforms
(``uniforms``), the values a caller wants at each random site, so that
draws can be compared with another generator's.
"""

from __future__ import annotations

import numpy as np
import torch

from .core import compiled
from .core.profiling import device_stage, span
from .core.device import f64_on, resolve_device
from .core.draws import (collisionless_uniforms, gas_uniforms, node_index,
                         radial_draw, velocity_draw)
from .core.grid import linspace
from .core.interp import _gather, interp, interp_monotone
from .parallel.ensemble import build_one_cluster
from .virial import (_banded_row_lerp, compute_df, om_extended_df,
                     sample_speeds_joint, speed_inverse_cdf_table,
                     speed_table_defaults)

__all__ = ["build_merger_models", "speed_table_inputs", "build_speed_tables",
           "build_radius_tables", "merger_uniforms", "sample_merger_ic",
           "sample_merger_ic_sharded", "merger_ic_fused",
           "binary_merger_ic", "attach_field_to_particles"]

_RQ = 2048  # radius quantile-table resolution


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
    :func:`build_speed_tables` uses.  ``None``: ergodic.

    One program (JAX ``build_merger_models``): ``num_points``,
    ``with_star_df``, ``r_a``, ``gravity`` and the gravity constants are
    its key; ``M200``, ``conc`` and ``z`` its inputs."""
    if r_a is not None and not float(r_a) > 0.0:
        raise ValueError(f"r_a must be positive (got {r_a!r}); None gives "
                         "the isotropic model")
    dev = resolve_device(device)
    return _build_merger_models(
        f64_on(M200, dev), f64_on(conc, dev), z, num_points=int(num_points),
        with_star_df=bool(with_star_df),
        r_a=None if r_a is None else float(r_a), gravity=str(gravity))


@compiled.function(static=("num_points", "with_star_df", "r_a", "gravity"),
                   name="build_merger_models")
def _build_merger_models(M200, conc, z, num_points, with_star_df, r_a,
                         gravity):
    fields = build_one_cluster(M200, conc, z=z, num_points=num_points,
                               with_df=(r_a is None), gravity=gravity)
    ee = -torch.flip(fields["gravitational_potential"], (-1,))
    n = ee.shape[-1]
    aug = 1.0 if r_a is None else 1.0 + (fields["radius"] / r_a) ** 2
    if r_a is not None:
        with device_stage("dfs", ee):
            ee_ext, dm_ext = om_extended_df(
                ee, torch.flip(fields["dark_matter_density"] * aug, (-1,)))
        fields["df_ee_ext"] = ee_ext
        fields["dm_df_ext"] = dm_ext
        fields["dm_df"] = torch.flip(dm_ext[..., -n:], (-1,))
    if with_star_df:
        sden = torch.flip(fields["stellar_density"] * aug, (-1,))
        if r_a is None:
            with device_stage("dfs", ee):
                star_df = compute_df(ee, sden)
            fields["star_df"] = torch.flip(star_df, (-1,))
        else:
            with device_stage("dfs", ee):
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


@compiled.function(static=("n_rows", "star_n_rows"))
def build_speed_tables(fields, n_rows=256, star_n_rows=64):
    """Per-halo inverse speed-CDF tables: ``{"dm": (H, n_rows, n_q),
    "star": (H, star_n_rows, n_q_star)}`` float32, one K1 launch per
    species (see :func:`speed_table_inputs`).  One program (JAX
    ``build_speed_tables``), the table knobs of ``cgparams['numerical']``
    in its key."""
    return {kind: speed_inverse_cdf_table(**kw) for kind, kw in
            speed_table_inputs(fields, n_rows, star_n_rows).items()}


def build_radius_tables(fields, r_max, dtype=torch.float32):
    """Per-halo inverse radius-CDF tables for every species: ``tables[kind]``
    is (H, 2048) radii at uniform mass quantiles (clamped at ``r_max``),
    ``tables[kind + "_mtot"]`` the (H,) mass inside ``r_max``.  One program
    (JAX ``build_radius_tables``, ``dtype`` static)."""
    if not isinstance(r_max, (float, torch.Tensor)):
        r_max = f64_on(r_max, fields["radius"].device)
    return _build_radius_tables(fields, r_max, dtype=dtype)


@compiled.function(static=("dtype",), name="build_radius_tables")
def _build_radius_tables(fields, r_max, dtype):
    rr = fields["radius"]
    r_max = f64_on(r_max, rr.device).expand(rr.shape[:-1])
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
    return node_index((torch.log(radius) - logr0) / dlog, n)


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
    shape = r_q.shape[:-1] + (n,)
    if uniforms is None:
        uniforms = collisionless_uniforms(gen, shape, dtype, r_q.device)
    u_r, u_q, u_b, pos_dir, vel_dir = uniforms
    rq = r_q.to(dtype)
    joint = _build_joint_speed_pairs(fields_h, s_inv, rq, dtype)
    kq, wq, radius, rhat = radial_draw(rq, u_r, pos_dir)
    speed = sample_speeds_joint(joint, kq, wq, uniforms=(u_q, u_b))
    pos = radius[..., None] * rhat + center.to(dtype)[..., None, :]
    vel = (velocity_draw(speed, vel_dir, rhat, radius, r_a)
           + bulk_v.to(dtype)[..., None, :])
    pmass = (m_rmax / n).to(dtype)[..., None].expand(shape).contiguous()
    return pos, vel, pmass


def _sample_gas_halo(fields_h, r_q, m_rmax, n, center, dtype, gen=None,
                     uniforms=None):
    """Gas positions (zero velocity before mixing) for one halo, with any
    leading batch axes.  ``uniforms``: ``(u_radius, dir)``."""
    shape = r_q.shape[:-1] + (n,)
    if uniforms is None:
        uniforms = gas_uniforms(gen, shape, dtype, r_q.device)
    _, _, radius, rhat = radial_draw(r_q.to(dtype), *uniforms)
    pos = radius[..., None] * rhat + center.to(dtype)[..., None, :]
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


def _merger_sites(n_gas, n_dm, n_star, n_tracer=None):
    """The random sites of :func:`sample_merger_ic` in its order (halo by
    halo: gas, dm, star, tracer): ``[((kind, halo), n, draw function)]``."""
    H = len(n_gas)
    sites = (("gas", n_gas, gas_uniforms),
             ("dm", n_dm, collisionless_uniforms),
             ("star", n_star, collisionless_uniforms),
             ("tracer", n_tracer or (0,) * H, gas_uniforms))
    return [((kind, i), n[i], draw) for i in range(H)
            for kind, n, draw in sites if n[i] > 0]


def merger_uniforms(generator, batch_shape, n_gas, n_dm, n_star,
                    n_tracer=None, dtype=torch.float32, device="cuda",
                    out=None):
    """Every uniform :func:`sample_merger_ic` takes from ``generator``,
    drawn in its order (halo by halo: gas, dm, star, tracer) and keyed as
    its ``uniforms`` argument, each ``batch_shape + (n,)``: the draws with
    these equal the draws with the generator, bit for bit.  ``out``: a
    dict of the same keys, filled in place and returned."""
    return {site: draw(generator, tuple(batch_shape) + (n,), dtype, device,
                       out=None if out is None else out[site])
            for site, n, draw in _merger_sites(n_gas, n_dm, n_star,
                                               n_tracer)}


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

    One program (JAX ``sample_merger_ic``): the counts, ``dtype``,
    ``compute_potential`` and ``r_a`` are its key.  Every uniform a site
    does not find in ``uniforms`` is drawn from ``generator`` before the
    program runs, in the body's order (:func:`merger_uniforms`), so the
    draws equal the eager body's bit for bit.
    """
    dev = fields["radius"].device
    centers = f64_on(centers, dev)
    velocities = f64_on(velocities, dev)
    if compiled.is_inline():
        return _sample_merger_ic(fields, tables, centers, velocities, r_max,
                                 n_gas, n_dm, n_star, n_tracer, dtype,
                                 compute_potential, r_a, generator, uniforms)
    counts = [None if n is None else tuple(map(int, n))
              for n in (n_gas, n_dm, n_star, n_tracer)]
    if generator is None and uniforms is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    given = uniforms or {}
    sites = _merger_sites(*counts)
    batch = tuple(centers.shape[:-2])

    def draw(out):
        res = {}
        for site, n, fn in sites:
            buf = None if out is None else out[site]
            if site in given:
                res[site] = compiled.drawer(given[site], None, dev, None)(buf)
            else:
                res[site] = fn(generator, batch + (n,), dtype, dev, out=buf)
        return res

    draw.generator = generator   # see compiled.drawer
    if not isinstance(r_max, (float, torch.Tensor)):
        r_max = f64_on(r_max, dev)
    return _sample_merger_ic_program(
        fields, tables, centers, velocities, r_max, draw, n_gas=counts[0],
        n_dm=counts[1], n_star=counts[2], n_tracer=counts[3], dtype=dtype,
        compute_potential=bool(compute_potential),
        r_a=None if r_a is None else float(r_a))


@compiled.function(static=("n_gas", "n_dm", "n_star", "n_tracer", "dtype",
                           "compute_potential", "r_a"),
                   random="uniforms", name="sample_merger_ic")
def _sample_merger_ic_program(fields, tables, centers, velocities, r_max,
                              uniforms, n_gas, n_dm, n_star, n_tracer, dtype,
                              compute_potential, r_a):
    return _sample_merger_ic(fields, tables, centers, velocities, r_max,
                             n_gas, n_dm, n_star, n_tracer, dtype,
                             compute_potential, r_a, None, uniforms)


def _sample_merger_ic(fields, tables, centers, velocities, r_max, n_gas,
                      n_dm, n_star, n_tracer, dtype, compute_potential, r_a,
                      generator, uniforms):
    """The body of :func:`sample_merger_ic` (tensors in)."""
    dev = fields["radius"].device
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


def sample_merger_ic_sharded(mesh, fields, tables, centers, velocities,
                             r_max, seed, n_gas, n_dm, n_star, n_tracer=None,
                             axis: str = "part", dtype=torch.float32,
                             compute_potential=False, uniforms=None):
    """Multi-device :func:`sample_merger_ic`: the particle draws shard
    over the mesh dim ``axis``.

    Fields and tables are replicated (every rank holds them whole).  The
    rank at coordinate i of ``axis`` draws ``n / size`` particles of every
    species from the generator seeded by ``(seed, i)``
    (:func:`~.parallel.mesh.fold_in`); ranks that differ only in the other
    mesh dim draw the same shard.  Every output is a DTensor sharded over
    ``axis``.  ``uniforms`` (optional): this rank's pre-drawn uniforms, as
    in :func:`sample_merger_ic`.  Counts must divide the axis size.  The
    rank's draw is :func:`sample_merger_ic`'s program at the shard's counts
    (no collective inside: the outputs become DTensors after it)."""
    from .parallel.mesh import fold_in, sharded

    n_dev = mesh.size(mesh.mesh_dim_names.index(axis))

    def div(tup):
        if tup is None:
            return None
        if any(n % n_dev for n in tup):
            raise ValueError(f"counts {tuple(tup)} must divide mesh axis "
                             f"{axis}={n_dev}")
        return tuple(n // n_dev for n in tup)

    gen = None
    if uniforms is None:
        gen = fold_in(seed, mesh.get_local_rank(axis),
                      fields["radius"].device)
    local = sample_merger_ic(fields, tables, centers, velocities, r_max,
                             div(n_gas), div(n_dm), div(n_star),
                             n_tracer=div(n_tracer), dtype=dtype,
                             compute_potential=compute_potential,
                             generator=gen, uniforms=uniforms)
    return {k: sharded(mesh, v, axis, v.shape[0] * n_dev)
            for k, v in local.items()}


def _merger_ic(M200, conc, centers, velocities, r_max, z, uniforms, *,
               n_gas, n_dm, n_star, n_tracer, num_points, dtype,
               compute_potential, r_a, gravity):
    """The body of :func:`merger_ic_fused`'s program: the four stages on
    float64 tensors of one device (``M200``/``conc``/``r_max`` (H,),
    ``centers``/``velocities`` (H, 3), ``z`` 0-d) with every uniform
    given, inline (the stages are part of this program).  Its stage marks
    (:func:`~.core.profiling.device_stage`), in order: models, dfs (the DM
    DF), models, dfs (the stellar DF), models, end; tables, end; draws
    (the gas mixing and the output assembly included), end."""
    with compiled.inline():
        with device_stage("models", M200):
            fields = build_merger_models(M200, conc, z=z,
                                         num_points=num_points, r_a=r_a,
                                         gravity=gravity, device=M200.device)
        with device_stage("tables", M200):
            tables = build_speed_tables(fields)
            tables["radius"] = build_radius_tables(fields, r_max)
        with device_stage("draws", M200):
            parts = sample_merger_ic(fields, tables, centers, velocities,
                                     r_max, n_gas, n_dm, n_star,
                                     n_tracer=n_tracer, dtype=dtype,
                                     compute_potential=compute_potential,
                                     r_a=r_a, uniforms=uniforms)
    return parts, fields


def merger_ic_fused(M200, conc, centers, velocities, r_max, n_gas, n_dm,
                    n_star, n_tracer=None, z=0.1, num_points=1000,
                    dtype=torch.float32, compute_potential=False, r_a=None,
                    gravity="newtonian", generator=None, uniforms=None,
                    device="cuda"):
    """The whole merger IC: models, DFs, tables and every particle draw.

    Returns ``(particles, fields)``.  ``n_tracer``, ``compute_potential``
    and ``r_a`` as in :func:`sample_merger_ic` and
    :func:`build_merger_models`.  ``generator``: a ``torch.Generator`` on
    ``device`` (default: one seeded with 0); ``uniforms``: every site's
    uniforms instead (see :func:`merger_uniforms`).

    One program, as the JAX package's jitted ``merger_ic_fused``: its key
    holds the counts, ``num_points``, ``dtype``, ``compute_potential``,
    ``r_a``, ``gravity``, the speed-table knobs of ``cgparams['numerical']``
    and the gravity constants of ``cgparams['gravity']``; masses,
    concentrations, centers, velocities, ``r_max``, ``z`` and the uniforms
    are its inputs (JAX traces ``z`` too), so a ``z`` sweep replays one
    program.  On the card the
    first call of a key runs eagerly and captures a CUDA graph, later calls
    replay it (:mod:`.core.compiled`); the uniforms are drawn from
    ``generator`` before the replay, with the draws of the eager body.
    """
    # the entry's own work before the program lookup
    with span("cg.host.inputs"):
        dev = resolve_device(device)
        H = len(n_gas)
        statics = dict(
            n_gas=tuple(map(int, n_gas)), n_dm=tuple(map(int, n_dm)),
            n_star=tuple(map(int, n_star)),
            n_tracer=(None if n_tracer is None
                      else tuple(map(int, n_tracer))),
            num_points=int(num_points), dtype=dtype,
            compute_potential=bool(compute_potential),
            r_a=None if r_a is None else float(r_a), gravity=str(gravity))
        inputs = (f64_on(M200, dev).reshape(H), f64_on(conc, dev).reshape(H),
                  f64_on(centers, dev).reshape(H, 3),
                  f64_on(velocities, dev).reshape(H, 3),
                  f64_on(r_max, dev).reshape(-1).expand(H),
                  f64_on(z, dev).reshape(()))
        sites = _merger_sites(statics["n_gas"], statics["n_dm"],
                              statics["n_star"], statics["n_tracer"])
        if uniforms is not None:
            missing = {s for s, _, _ in sites} - set(uniforms)
            if missing:
                raise ValueError(
                    f"uniforms lack the sites {sorted(missing)}")
            uniforms = {s: uniforms[s] for s, _, _ in sites}
        draw = compiled.drawer(uniforms, generator, dev, lambda gen, out: (
            merger_uniforms(gen, (), statics["n_gas"], statics["n_dm"],
                            statics["n_star"], statics["n_tracer"], dtype,
                            dev, out=out)))
        key = ("merger_ic_fused", tuple(statics.items()))
    return compiled.run(key, lambda *a: _merger_ic(*a, **statics), inputs,
                        draw)


def attach_field_to_particles(parts: dict, field, ptype: str = "gas"):
    """Trilinear sample of a 3D field (:class:`~.fields.ClusterField`) at
    the particle positions of ``ptype``, in the positions' dtype, on their
    device: adds ``(ptype, field._name)`` of shape (N, 3) to ``parts`` and
    returns it."""
    from .fields.grf import _trilinear

    pos = parts[ptype, "particle_position"]
    comps = (field.gx, field.gy, field.gz)
    # the stacked field, and its cast to the positions' dtype
    compiled.room_for(pos.device, *comps, *[
        (c.numel(), pos.dtype) for c in comps if c.dtype != pos.dtype])
    g = torch.stack(comps).to(pos.dtype)
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
    M200s = f64_on(M200s, dev)
    H = M200s.shape[0]
    centers = f64_on(centers, dev).reshape(H, 3)
    velocities = f64_on(velocities, dev).reshape(H, 3)
    if np.isscalar(r_max):
        r_max = torch.full((H,), float(r_max), dtype=torch.float64,
                           device=dev)
    else:
        r_max = f64_on(r_max, dev)

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
