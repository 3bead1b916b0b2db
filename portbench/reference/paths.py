"""Plain reference of the two timed paths: the binary-merger IC and the
full-species ensemble datagen batch.

Each takes the inputs the benchmark handed to the program (halo parameters,
counts, the seed of the call's ``torch.Generator``) and works out again, from
:mod:`.model`, the models, the DFs and the tables the configuration names,
then the particles.  The tables are built at the nodes the configuration
file states (``speed_tables``, ``radius_quantiles``) by the rules it states
(``tables``), from the reference's own model values; the draws follow the
rules of ``draws``.

Random numbers are the one thing shared with the program, as an input: the
call's generator, seeded as the program's was, read in the order the
package documents for its random sites (a merger: halo by halo, gas then DM
then stars; a datagen batch: DM, stars, gas, each for the whole batch).
A collisionless site takes ``(u_radius, u_speed, u_row, pos_dir,
vel_dir)``, a gas site ``(u_radius, dir)``, a direction ``(cos theta in
[-1, 1), u_phi in [0, 1))``, every one float32 from ``torch.rand``.

The model, the DFs and the tables are float64 NumPy (``dt``; the DFs
``df_dt``); the draws and the gas mixing run in PyTorch on the host in
``pdt`` (float64 unless a control asks for less), and come back as float32
as the configuration states.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import model as M

F32 = torch.float32


# ------------------------------------------------------------ uniforms
def generator(seed, device):
    return torch.Generator(device=device).manual_seed(int(seed))


def _u(gen, shape, lo=0.0, hi=1.0):
    u = torch.rand(shape, generator=gen, dtype=F32, device=gen.device)
    return u * (hi - lo) + lo if (lo, hi) != (0.0, 1.0) else u


def _direction(gen, shape):
    return (_u(gen, shape, -1.0, 1.0), _u(gen, shape))


def collisionless_uniforms(gen, shape):
    return (_u(gen, shape), _u(gen, shape), _u(gen, shape),
            _direction(gen, shape), _direction(gen, shape))


def gas_uniforms(gen, shape):
    return (_u(gen, shape), _direction(gen, shape))


def _host(tree, dtype):
    if isinstance(tree, tuple):
        return tuple(_host(t, dtype) for t in tree)
    return tree.cpu().to(dtype)


def isotropic(direction):
    cos_t, u_phi = direction
    phi = (2.0 * math.pi) * u_phi
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    return torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi),
                        cos_t], dim=-1)


# ------------------------------------------------------------ table rules
def _t(a, dtype):
    return torch.as_tensor(np.ascontiguousarray(a)).to(dtype)


def _node_lerp(table, u):
    """A quantity tabulated at the nodes i / (n - 1) of [0, 1], read at
    ``u`` linearly: ``(value, node below, weight)``."""
    n = table.shape[-1]
    x = torch.clamp(u * (n - 1), 0.0, n - 1 - 1e-6)
    k = torch.clamp_max(x.to(torch.int64), n - 2)
    w = x - k.to(u.dtype)
    lo = torch.gather(table, -1, k)
    hi = torch.gather(table, -1, k + 1)
    return (1.0 - w) * lo + w * hi, k, w


def _speed(joint, k, w, u_row, u_q):
    """The speed of the joint table (nodes, n_q) at the radius node ``k`` or
    ``k + 1`` (the upper with probability ``w``), read at ``u_q`` linearly
    along the quantiles."""
    n_q = joint.shape[-1]
    kk = k + (u_row < w).to(torch.int64)
    rows = joint.reshape(joint.shape[:-2] + (-1,))
    x = torch.clamp(u_q * (n_q - 1), 0.0, n_q - 1 - 1e-6)
    m = torch.clamp_max(x.to(torch.int64), n_q - 2)
    wm = x - m.to(u_q.dtype)
    flat = kk * n_q + m
    return ((1.0 - wm) * torch.gather(rows, -1, flat)
            + wm * torch.gather(rows, -1, flat + 1))


def _mass_nodes(r, m, total, n, with_origin):
    """Radii at the ``n`` uniform quantiles of the CDF ``min(m / total,
    1)`` as tabulated at the grid nodes, linear in r between them (from
    r = 0, CDF 0 when ``with_origin``)."""
    cdf = np.minimum(m / total, 1.0)
    if with_origin:
        r, cdf = np.concatenate([[0.0], r]), np.concatenate([[0.0], cdf])
    q = np.linspace(0.0, 1.0, n)
    # the first node at which the CDF reaches each quantile, and the one
    # below it
    j = np.clip(np.searchsorted(cdf, q, side="right") - 1, 0, len(r) - 2)
    c0, c1 = cdf[j], cdf[j + 1]
    w = np.where(c1 > c0, (q - c0) / np.where(c1 > c0, c1 - c0, 1.0), 0.0)
    return r[j] + np.clip(w, 0.0, 1.0) * (r[j + 1] - r[j])


def _lerp_in_log(r_grid, vals, r):
    """``vals`` linear in ln r between grid nodes, clamped at the ends."""
    lr = np.log(r_grid)
    with np.errstate(divide="ignore"):
        x = np.log(np.maximum(r, 0.0))
    return np.interp(x, lr, vals)


# ------------------------------------------------------------ merger
def merger_ic(M200, conc, centers, velocities, r_max, z, counts, seed,
              num_points, tables, device, quantiles=2048, dt=np.float64,
              df_dt=None, pdt=torch.float64):
    """The binary-merger IC: ``(particles, fields)``, particles keyed
    ``(species, field)``, for halos given as float sequences and per-halo
    ``counts = {"gas": (n0, n1), "dm": ..., "star": ...}``.  ``tables``:
    the configuration's ``speed_tables``; ``device``: the generator's;
    ``quantiles``: the radius nodes of every species."""
    df_dt = dt if df_dt is None else df_dt
    H = len(M200)
    clusters = [M.Cluster(M200[i], conc[i], z, num_points, dt)
                for i in range(H)]
    fields = [c.fields() for c in clusters]
    for f in fields:
        f["dm_df"] = M.df_in_radial_order(f, "dark_matter_density", df_dt)
        f["star_df"] = M.df_in_radial_order(f, "stellar_density", df_dt)
    gen = generator(seed, device)
    mass_keys = {"gas": "gas_mass", "dm": "dark_matter_mass",
                 "star": "stellar_mass"}
    df_keys = {"dm": "dm_df", "star": "star_df"}
    out = {}
    for i, f in enumerate(fields):
        r, psi = f["radius"], -f["gravitational_potential"]
        ctr = torch.as_tensor(centers[i], dtype=torch.float64).to(pdt)
        bulk = torch.as_tensor(velocities[i], dtype=torch.float64).to(pdt)
        for sp in ("gas", "dm", "star"):
            n = counts[sp][i]
            if n <= 0:
                continue
            uni = (gas_uniforms if sp == "gas" else collisionless_uniforms)(
                gen, (n,))
            uni = _host(uni, pdt)
            # radius nodes: uniform quantiles of M(<r) / M(<r_max)
            m_rmax = np.interp(r_max, r, f[mass_keys[sp]])
            r_q = np.minimum(_mass_nodes(r, f[mass_keys[sp]], m_rmax,
                                         quantiles, True), r_max)
            if sp == "gas":
                u_r, direction = uni
                radius = _node_lerp(_t(r_q, pdt), u_r)[0]
                pos, vel = radius[:, None] * isotropic(direction) + ctr, None
            else:
                tab = tables[sp]
                rows = tab["rows"]
                r_rows = np.exp(np.linspace(np.log(r[0]), np.log(r[-1]),
                                            rows))
                s_inv = M.speed_fractions(
                    psi[::-1], f[df_keys[sp]][::-1],
                    np.interp(r_rows, r, psi), tab["n_s"], tab["n_q"], dt)
                # each radius node's row of speed fractions: the rows
                # linear in ln r, times the node's escape speed (psi linear
                # in ln r on the grid)
                x = _lerp_in_log(r_rows, np.arange(rows, dtype=np.float64),
                                 r_q)
                j = np.minimum(x.astype(np.int64), rows - 2)
                w = (x - j)[:, None]
                v_esc = np.sqrt(2.0 * _lerp_in_log(r, psi, r_q))
                joint = ((1.0 - w) * s_inv[j] + w * s_inv[j + 1]) * v_esc[
                    :, None]
                u_r, u_q, u_b, pos_dir, vel_dir = uni
                radius, k, wq = _node_lerp(_t(r_q, pdt), u_r)
                speed = _speed(_t(joint, pdt), k, wq, u_b, u_q)
                pos = radius[:, None] * isotropic(pos_dir) + ctr
                vel = speed[:, None] * isotropic(vel_dir) + bulk
            mass = torch.full((n,), float(m_rmax / n), dtype=torch.float64)
            for key, v in (("particle_position", pos),
                           ("particle_velocity", vel),
                           ("particle_mass", mass.to(pdt))):
                if v is not None:
                    out.setdefault((sp, key), []).append(v)
    out = {k: torch.cat(v) for k, v in out.items()}
    dens, eint, gvel = _mix_gas(out["gas", "particle_position"], fields,
                                centers, velocities, pdt)
    out["gas", "particle_velocity"] = gvel
    out["gas", "density"] = dens
    out["gas", "thermal_energy"] = eint
    stacked = {k: np.stack([f[k] for f in fields]) for k in fields[0]}
    return {k: v.to(F32) for k, v in out.items()}, stacked


def _mix_gas(pos, fields, centers, velocities, pdt):
    """Each gas particle's density, specific thermal energy and velocity:
    the sum over the halos of their gas density, the density-weighted mean
    of 1.5 P / rho and of their bulk velocities; each halo's density and
    1.5 P linear in ln r on its grid, clamped at the grid's ends."""
    dens = energy = mom = 0.0
    for i, f in enumerate(fields):
        c = torch.as_tensor(centers[i], dtype=torch.float64).to(pdt)
        r = torch.sqrt(((pos - c) ** 2).sum(-1)).to(torch.float64).numpy()
        d = _t(_lerp_in_log(f["radius"], f["density"], r), pdt)
        e = _t(_lerp_in_log(f["radius"], 1.5 * f["pressure"], r), pdt)
        v = torch.as_tensor(velocities[i], dtype=torch.float64).to(pdt)
        dens, energy, mom = dens + d, energy + e, mom + v * d[:, None]
    return dens, energy / dens, mom / dens[:, None]


# ------------------------------------------------------------ datagen
def row_nodes(num_points, rows):
    """The grid nodes (in ascending psi) that carry a speed-table row."""
    return np.unique(np.round(np.linspace(0, num_points - 1,
                                          min(rows, num_points))).astype(int))


def datagen_batch(M200, conc, counts, seed, batch, num_points, tables,
                  quantiles, z, device, rows=None, dt=np.float64,
                  df_dt=None, pdt=torch.float64):
    """Clusters ``rows`` (indices into the batch; all by default) of one
    datagen batch of ``batch`` clusters with parameters ``M200[b], conc[b]``:
    ``{species: (pos, vel or energy, pmass)}`` with a leading cluster axis.
    The batch's uniforms are drawn whole, as the program draws them;
    ``tables``, ``quantiles``: the configuration's ``speed_tables`` and
    ``radius_quantiles``."""
    df_dt = dt if df_dt is None else df_dt
    rows = np.arange(batch) if rows is None else np.asarray(rows)
    gen = generator(seed, device)
    uni = {}
    for sp in ("dm", "star"):
        if counts[sp]:
            uni[sp] = collisionless_uniforms(gen, (batch, counts[sp]))
    if counts["gas"]:
        uni["gas"] = gas_uniforms(gen, (batch, counts["gas"]))
    idx = torch.as_tensor(rows, device=device)

    def take(t):
        return tuple(take(x) for x in t) if isinstance(t, tuple) else t[idx]

    uni = {sp: _host(take(u), pdt) for sp, u in uni.items()}
    out = {sp: ([], [], []) for sp in uni}
    keys = {"dm": ("dark_matter_density", "dark_matter_mass"),
            "star": ("stellar_density", "stellar_mass")}
    for b, cl in enumerate(rows):
        f = M.Cluster(M200[cl], conc[cl], z, num_points, dt).fields()
        r = f["radius"]
        psi = -f["gravitational_potential"]
        for sp in ("dm", "star"):
            if not counts[sp]:
                continue
            dkey, mkey = keys[sp]
            tab = tables[sp]
            e_psi = psi[::-1]
            f_e = M.eddington(e_psi, f[dkey][::-1], df_dt)
            row_psi = e_psi[row_nodes(num_points, tab["rows"])]
            s_inv = M.speed_fractions(e_psi, f_e, row_psi, tab["n_s"],
                                      tab["n_q"], dt)
            # radius nodes: uniform quantiles of M(<r) / M(<10000 kpc);
            # each node's psi linear in r; its row of speed fractions
            # linear in psi between the rows around it, times its escape
            # speed
            r_q = _mass_nodes(r, f[mkey], f[mkey][-1], quantiles[sp], False)
            psi_q = np.interp(r_q, r, psi)
            j = np.clip(np.searchsorted(row_psi, psi_q, side="right") - 1, 0,
                        len(row_psi) - 2)
            w = np.clip((psi_q - row_psi[j]) / (row_psi[j + 1] - row_psi[j]),
                        0.0, 1.0)[:, None]
            v_esc = np.sqrt(2.0 * psi_q)
            joint = ((1.0 - w) * s_inv[j] + w * s_inv[j + 1]) * v_esc[:, None]
            u_r, u_q, u_b, pos_dir, vel_dir = (
                x[b] if not isinstance(x, tuple) else (x[0][b], x[1][b])
                for x in uni[sp])
            radius, k, wq = _node_lerp(_t(r_q, pdt), u_r)
            v_cap = _node_lerp(_t(v_esc, pdt), u_r)[0]
            # a speed read from the upper node may pass the escape speed
            # at the particle's radius: it is capped there
            speed = torch.minimum(_speed(_t(joint, pdt), k, wq, u_b, u_q),
                                  v_cap)
            out[sp][0].append(radius[:, None] * isotropic(pos_dir))
            out[sp][1].append(speed[:, None] * isotropic(vel_dir))
            out[sp][2].append(torch.tensor(float(f[mkey][-1] / counts[sp]),
                                           dtype=torch.float64).to(pdt))
        if counts["gas"]:
            u_r, direction = (x[b] if not isinstance(x, tuple)
                              else (x[0][b], x[1][b]) for x in uni["gas"])
            r_q = _mass_nodes(r, f["gas_mass"], f["gas_mass"][-1],
                              quantiles["gas"], False)
            radius = _node_lerp(_t(r_q, pdt), u_r)[0]
            energy = np.interp(radius.to(torch.float64).numpy(), r,
                               1.5 * f["pressure"] / f["density"])
            out["gas"][0].append(radius[:, None] * isotropic(direction))
            out["gas"][1].append(_t(energy, pdt))
            out["gas"][2].append(torch.tensor(
                float(f["gas_mass"][-1] / counts["gas"]),
                dtype=torch.float64).to(pdt))
    return {sp: tuple(torch.stack(a).to(F32) for a in v)
            for sp, v in out.items()}
