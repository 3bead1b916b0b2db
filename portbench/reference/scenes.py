"""Plain reference of the merger-scene batch: binary-merger ICs built many
to a batch, each scene's two halos with their models, DFs and tables, the
particles drawn and each scene's gas mixed over its own two halos.

It works the checked scenes of a batch out again from the inputs the
benchmark handed to the program (each scene's M200, c, centres and bulk
velocities, the per-halo counts, the seed of the batch's
``torch.Generator``) and the configuration file (``configs/scenes-cfg6.json``):
the models and the DFs from :mod:`.model`, the tables by the rules
``tables`` states at ``num_points`` grid points (the merger's rules), the
draws by ``draws``, the gas mixed by :func:`.paths._mix_gas` over the
scene's own halos, and each halo's particle mass m(<r_max) / n.  It shares
no code with the package under test; the table and draw helpers are those
of :mod:`.paths`.

Random numbers are the one thing shared with the program, as an input: the
batch's generator, seeded as the program's was, read in the order the
package documents for a merger's random sites (halo by halo: gas, then DM,
then stars), each site drawn whole at ``(B, n)`` for the batch's ``B``
scenes; scene b takes row b.

Where it departs from the one-IC merger reference
(:func:`.paths.merger_ic`): the uniforms are drawn at ``(B, n)`` a site and
a row taken, not at ``(n,)``; the particle masses come as one value a halo
(``<species>/particle_mass``, ``(H,)`` a scene), as the batch hands them
over, not one a particle; no model field is handed over, so none is
compared; the model is built at ``z`` of the configuration (0.1, the batch
program's only redshift).

The models, the DFs and the tables are float64 NumPy (``dt``; the DFs
``df_dt``); the draws and the gas mixing run in PyTorch on the host in
``pdt`` (float64 unless a control asks for less), and come back as
float32 as the configuration states.
"""

from __future__ import annotations

import numpy as np
import torch

from . import model as M
from . import paths as P

SPECIES = ("gas", "dm", "star")
MASS = {"gas": "gas_mass", "dm": "dark_matter_mass", "star": "stellar_mass"}
DF = {"dm": "dm_df", "star": "star_df"}


# ------------------------------------------------------------ uniforms
def sites(counts):
    """The random sites of a scene in the documented order: ``[(kind,
    halo, n)]``, halo by halo, gas, DM, stars, each with particles."""
    H = len(counts["gas"])
    return [(sp, i, counts[sp][i]) for i in range(H) for sp in SPECIES
            if counts[sp][i] > 0]


def uniforms(gen, B, counts):
    """Every site's uniforms for a batch of ``B`` scenes, each drawn whole
    at ``(B, n)``: ``{(kind, halo): tuple}`` (a gas site ``(u_radius,
    (cos theta, u_phi))``, a collisionless one ``(u_radius, u_speed, u_row,
    pos_dir, vel_dir)``)."""
    out = {}
    for sp, i, n in sites(counts):
        draw = P.gas_uniforms if sp == "gas" else P.collisionless_uniforms
        out[sp, i] = draw(gen, (B, n))
    return out


def _row(tree, b):
    if isinstance(tree, tuple):
        return tuple(_row(t, b) for t in tree)
    return tree[b]


# ------------------------------------------------------------ one scene
def halo(m200, conc, z, num_points, dt=np.float64, df_dt=None):
    """One halo's model fields with its DM and stellar DFs."""
    f = M.Cluster(m200, conc, z, num_points, dt).fields()
    for sp, key in (("dm", "dark_matter_density"),
                    ("star", "stellar_density")):
        f[DF[sp]] = M.df_in_radial_order(f, key, dt if df_dt is None
                                         else df_dt)
    return f


def _tables(f, sp, r_max, quantiles, tab, dt):
    """A halo's species tables: ``(radius nodes, joint speed table or
    None, m(<r_max))``, by the merger's rules."""
    r, psi = f["radius"], -f["gravitational_potential"]
    m_rmax = np.interp(r_max, r, f[MASS[sp]])
    r_q = np.minimum(P._mass_nodes(r, f[MASS[sp]], m_rmax, quantiles, True),
                     r_max)
    if sp == "gas":
        return r_q, None, m_rmax
    rows = tab["rows"]
    r_rows = np.exp(np.linspace(np.log(r[0]), np.log(r[-1]), rows))
    s_inv = M.speed_fractions(psi[::-1], f[DF[sp]][::-1],
                              np.interp(r_rows, r, psi), tab["n_s"],
                              tab["n_q"], dt)
    # each radius node's row: the rows linear in ln r, times the node's
    # escape speed (psi linear in ln r on the grid)
    x = P._lerp_in_log(r_rows, np.arange(rows, dtype=np.float64), r_q)
    j = np.minimum(x.astype(np.int64), rows - 2)
    w = (x - j)[:, None]
    v_esc = np.sqrt(2.0 * P._lerp_in_log(r, psi, r_q))
    joint = ((1.0 - w) * s_inv[j] + w * s_inv[j + 1]) * v_esc[:, None]
    return r_q, joint, m_rmax


def scene(fields, centers, velocities, r_max, counts, uni, tables,
          quantiles, dt=np.float64, pdt=torch.float64):
    """One scene from its halos' ``fields`` and its uniforms ``uni`` (as
    :func:`uniforms` gives them, one row, on the host in ``pdt``):
    ``{name: float32 array}`` with the batch's names."""
    out = {}
    for i, f in enumerate(fields):
        ctr = torch.as_tensor(centers[i], dtype=torch.float64).to(pdt)
        bulk = torch.as_tensor(velocities[i], dtype=torch.float64).to(pdt)
        for sp in SPECIES:
            n = counts[sp][i]
            if n <= 0:
                continue
            r_q, joint, m_rmax = _tables(f, sp, r_max, quantiles,
                                         tables.get(sp), dt)
            if sp == "gas":
                u_r, direction = uni[sp, i]
                radius = P._node_lerp(P._t(r_q, pdt), u_r)[0]
                pos, vel = radius[:, None] * P.isotropic(direction) + ctr, None
            else:
                u_r, u_q, u_b, pos_dir, vel_dir = uni[sp, i]
                radius, k, wq = P._node_lerp(P._t(r_q, pdt), u_r)
                speed = P._speed(P._t(joint, pdt), k, wq, u_b, u_q)
                pos = radius[:, None] * P.isotropic(pos_dir) + ctr
                vel = speed[:, None] * P.isotropic(vel_dir) + bulk
            out.setdefault((sp, "particle_position"), []).append(pos)
            if vel is not None:
                out.setdefault((sp, "particle_velocity"), []).append(vel)
            out.setdefault((sp, "particle_mass"), []).append(
                torch.tensor([m_rmax / n], dtype=torch.float64).to(pdt))
    out = {k: torch.cat(v) for k, v in out.items()}
    dens, eint, gvel = P._mix_gas(out["gas", "particle_position"], fields,
                                  centers, velocities, pdt)
    out["gas", "particle_velocity"] = gvel
    out["gas", "density"] = dens
    out["gas", "thermal_energy"] = eint
    return {f"{sp}/{key}": v.to(P.F32).numpy() for (sp, key), v in out.items()}


# ------------------------------------------------------------ a batch
def batch(M200, conc, centers, velocities, r_max, z, counts, seed, B, rows,
          num_points, tables, quantiles, device, dt=np.float64, df_dt=None,
          pdt=torch.float64):
    """Scenes ``rows`` (indices into the batch) of one batch of ``B``
    scenes with host float64 parameters ``M200[b], conc[b]`` (B, 2) and
    ``centers[b], velocities[b]`` (B, 2, 3): ``{name: array}`` with a
    leading axis over ``rows``.  ``seed``: the batch generator's, on
    ``device``; ``tables``, ``quantiles``: the configuration's
    ``speed_tables`` and ``radius_quantiles``."""
    gen = P.generator(seed, device)
    uni = uniforms(gen, B, counts)
    idx = torch.as_tensor(np.asarray(rows), device=device)
    uni = {site: P._host(_row(u, idx), pdt) for site, u in uni.items()}
    done = []
    for j, b in enumerate(rows):
        fields = [halo(M200[b][i], conc[b][i], z, num_points, dt, df_dt)
                  for i in range(M200.shape[1])]
        done.append(scene(fields, centers[b], velocities[b], r_max, counts,
                          {s: _row(u, j) for s, u in uni.items()}, tables,
                          quantiles, dt, pdt))
    return {name: np.stack([d[name] for d in done]) for name in done[0]}
