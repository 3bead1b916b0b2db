"""Plain reference of the binary-merger IC scene through the class path:
two halo models with their DFs, each halo's particles drawn from its own
tables, the gas of both halos mixed, and the Gadget blocks of the scene.

It follows the rules ``configs/icscene2h.json`` states (``tables``,
``draws``, ``mixing``, ``gadget``) on the reference's own models and DFs
(:mod:`.model`), sharing no code with the package under test.  Shared with
the program, as inputs: the call's halos, its seed and the particle count
of each halo and species the program split the totals into (checked here
against the reference's own split: a count that is not a rounding of the
reference's share is replaced by the reference's, and the shapes then
differ).  Random numbers are read as the configuration documents them:
the scene's generator on the program's device seeded with the call's
seed, four seeds a halo from ``torch.randint``, one generator a species.

The models, the DFs and the tables are NumPy in ``dt`` (the DFs in
``df_dt``); the draws and the gas mixing run in PyTorch on the host in
``pdt`` (float64 unless a control asks for less); the blocks are float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy.interpolate import CubicSpline

from . import model as M

F64 = torch.float64
F32 = torch.float32
SPECIES = ("dm", "star", "gas")
MASS = {"dm": "dark_matter_mass", "star": "stellar_mass", "gas": "gas_mass"}
DENSITY = {"dm": "dark_matter_density", "star": "stellar_density"}
DF = {"dm": "dm_df", "star": "star_df"}
# Gadget file units: a galactic value (kpc, Myr, Msun) over its unit
KM_S = 1.0e3 * M.MYR_S / M.KPC_M                 # km/s in kpc/Myr
UNITS = {"Coordinates": 1.0, "Velocities": KM_S, "Masses": 1.0e10,
         "InternalEnergy": KM_S**2, "Density": 1.0e10}
NAMES = {"Coordinates": "particle_position",
         "Velocities": "particle_velocity", "Masses": "particle_mass",
         "InternalEnergy": "thermal_energy", "Density": "density"}
# the model fields handed over, one row per halo
FIELDS = ("radius", "density", "total_density", "total_mass", "gas_mass",
          "gravitational_field", "pressure", "temperature",
          "gravitational_potential", "stellar_density", "stellar_mass",
          "dark_matter_density", "dark_matter_mass", "gas_fraction",
          "electron_number_density", "entropy")


# ------------------------------------------------------------ the counts
def inside(f, key, r_max):
    """``f[key]`` at the last grid point below ``r_max``."""
    return f[key][f["radius"] < r_max][-1]


def split(fields, r_max, totals, given):
    """Each species' count per halo: ``given`` (the program's) where it is
    a rounding of the reference's share of the total, by the masses inside
    ``r_max``, else the reference's own rounding."""
    out = {}
    for sp in SPECIES:
        m = np.array([inside(f, MASS[sp], r_max) for f in fields], np.float64)
        share = totals[sp] * m / m.sum()
        out[sp] = [int(g) if abs(g - s) <= 0.5 + 1e-6 else int(np.rint(s))
                   for g, s in zip(given[sp], share)]
    return out


# ------------------------------------------------------------ uniforms
def _rand(gen, n, dtype, lo=0.0, hi=1.0):
    u = torch.rand(n, generator=gen, dtype=dtype, device=gen.device)
    return u * (hi - lo) + lo if (lo, hi) != (0.0, 1.0) else u


def _direction(gen, n):
    return (_rand(gen, n, F64, -1.0, 1.0), _rand(gen, n, F64))


def halo_generators(base):
    """The four generators of a halo, in the documented order."""
    seeds = torch.randint(0, 2**62, (4,), generator=base,
                          device=base.device).tolist()
    return dict(zip(("dm", "star", "gas", "tracer"), (
        torch.Generator(device=base.device).manual_seed(s) for s in seeds)))


def uniforms(gen, sp, n):
    """A species' uniforms on the host, in the order it draws them."""
    if sp == "gas":
        out = (_rand(gen, n, F64), _direction(gen, n))
    else:
        out = (_rand(gen, n, F64), _direction(gen, n), _rand(gen, n, F32),
               _rand(gen, n, F32), _direction(gen, n))

    def host(t):
        return tuple(map(host, t)) if isinstance(t, tuple) else t.cpu()
    return host(out)


def isotropic(direction, pdt):
    cos_t, u_phi = (d.to(pdt) for d in direction)
    phi = (2.0 * math.pi) * u_phi
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    return torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi),
                        cos_t], dim=-1)


# ------------------------------------------------------------ the tables
def _interp_right(q, x, y):
    """np.interp's rule: the interval of ``searchsorted(x, q, 'right')``,
    linear in it, an interval of zero width taking its left value."""
    i = np.clip(np.searchsorted(x, q, side="right"), 1, len(x) - 1)
    x0, x1, y0, y1 = x[i - 1], x[i], y[i - 1], y[i]
    dx = x1 - x0
    w = np.where(dx > 0, (q - x0) / np.where(dx > 0, dx, 1.0), 0.0)
    out = y0 + w * (y1 - y0)
    out = np.where(q < x[0], y[0], out)
    return np.where(q > x[-1], y[-1], out)


def radius_nodes(f, sp, r_max, n):
    """The species' radius nodes inside ``r_max`` and its mass there."""
    r, m = f["radius"], f[MASS[sp]]
    if sp in DENSITY:
        m = np.where(f[DENSITY[sp]] > 0.0, m, -np.inf)
        m = np.maximum.accumulate(m)
        m = np.where(np.isfinite(m), m, 0.0)
    ridx = int(np.searchsorted(r, r_max))
    mtot = m[ridx - 1]
    P = np.maximum.accumulate(np.clip(m / mtot, 0.0, 1.0))
    P, rr = np.concatenate([[0.0], P]), np.concatenate([[0.0], r])
    full = P >= 1.0
    cap = rr[int(np.argmax(full))] if full.any() else rr[-1]
    q = np.linspace(0.0, 1.0, n)
    return np.minimum(_interp_right(q, P, rr), cap), mtot


def joint_table(f, sp, r_q, tab, dt):
    """``(joint (nodes, n_q), psi at the nodes)``: each radius node's row
    of speeds."""
    r = f["radius"]
    psi = -f["gravitational_potential"]
    psi_q = CubicSpline(r, psi, bc_type="not-a-knot")(r_q)
    e_asc, f_asc = psi[::-1], f[DF[sp]][::-1]
    n = len(e_asc)
    rows = np.unique(np.round(np.linspace(0, n - 1, min(tab["rows"], n)))
                     .astype(int))
    row_e = e_asc[rows]
    s_inv = M.speed_fractions(e_asc, f_asc, row_e, tab["n_s"], tab["n_q"],
                              dt)
    j = np.clip(np.searchsorted(row_e, psi_q, side="right") - 1, 0,
                len(row_e) - 2)
    w = np.clip((psi_q - row_e[j]) / (row_e[j + 1] - row_e[j]), 0.0,
                1.0)[:, None]
    joint = ((1.0 - w) * s_inv[j] + w * s_inv[j + 1]) * np.sqrt(
        2.0 * psi_q)[:, None]
    return joint, psi_q


# ------------------------------------------------------------ the draws
def _t(a, pdt):
    return torch.as_tensor(np.ascontiguousarray(a)).to(pdt)


def _nodes_at(u, n):
    """``(node below, weight)`` of the radius draws."""
    x = torch.clamp(u * (n - 1), 0.0, n - 1 - 1e-9)
    k = torch.clamp_max(x.to(torch.int64), n - 2)
    return k, x - k.to(u.dtype)


def _lerp(table, k, w):
    return (1.0 - w) * table[k] + w * table[k + 1]


def _speed(joint, k, w, u_row, u_q):
    n_q = joint.shape[-1]
    kk = k + (u_row < w).to(torch.int64)
    x = torch.clamp(u_q * (n_q - 1), 0.0, n_q - 1 - 1e-6)
    m = torch.clamp_max(x.to(torch.int64), n_q - 2)
    wm = x - m.to(u_q.dtype)
    return (1.0 - wm) * joint[kk, m] + wm * joint[kk, m + 1]


def draw(f, sp, n, uni, center, bulk, cfg, dt, pdt):
    """One halo's species: ``{field: tensor}`` in ``pdt``."""
    r_q, mtot = radius_nodes(f, sp, cfg["r_max_kpc"],
                             cfg["radius_quantiles"])
    u_r = uni[0].to(pdt)
    k, w = _nodes_at(u_r, len(r_q))
    radius = _lerp(_t(r_q, pdt), k, w)
    ctr = torch.as_tensor(center, dtype=F64).to(pdt)
    out = {"particle_position": radius[:, None] * isotropic(uni[1], pdt)
           + ctr,
           "particle_mass": torch.full((n,), float(mtot / n),
                                       dtype=F64).to(pdt)}
    if sp == "gas":
        out["particle_velocity"] = torch.zeros((n, 3), dtype=pdt)
        return out
    joint, psi_q = joint_table(f, sp, r_q, cfg["speed_tables"][sp], dt)
    speed = _speed(_t(joint, pdt), k, w, uni[3].to(pdt), uni[2].to(pdt))
    speed = torch.minimum(speed, torch.sqrt(2.0 * _lerp(_t(psi_q, pdt), k,
                                                        w)))
    v = torch.as_tensor(bulk, dtype=F64).to(pdt)
    out["particle_velocity"] = speed[:, None] * isotropic(uni[4], pdt) + v
    return out


def mix(pos, fields, centers, velocities, pdt):
    """Each gas particle's density, specific thermal energy and velocity,
    mixed over the halos by the configuration's ``mixing`` rule."""
    dens = energy = mom = 0.0
    for f, c, v in zip(fields, centers, velocities):
        r = f["radius"]
        d = torch.sqrt(((pos - torch.as_tensor(c, dtype=F64).to(pdt)) ** 2)
                       .sum(-1)).to(F64).numpy()
        d = np.clip(d, r[0], r[-1])
        rho = _t(CubicSpline(r, f["density"], bc_type="not-a-knot")(d), pdt)
        e = _t(CubicSpline(r, 1.5 * f["pressure"] / f["density"],
                           bc_type="not-a-knot")(d), pdt)
        vv = torch.as_tensor(v, dtype=F64).to(pdt)
        dens, energy, mom = dens + rho, energy + e * rho, mom + vv * rho[
            :, None]
    return dens, energy / dens, mom / dens[:, None]


# ------------------------------------------------------------ the scene
def scene(M200, conc, centers, velocities, totals, counts, seed, cfg,
          device, dt=np.float64, df_dt=None, pdt=F64):
    """The IC's Gadget blocks and the halos' fields: ``{name: array}``,
    named as :mod:`.compare` reads them (``<type>/<field>`` from the blocks,
    in the types' file order; ``field/<name>`` a row per halo).
    ``centers`` in the box's frame; ``counts``: the program's split
    ``{species: [per halo]}``; ``device``: where the program's generators
    live."""
    df_dt = dt if df_dt is None else df_dt
    fields = []
    for m, c in zip(M200, conc):
        f = M.Cluster(m, c, cfg["z"], cfg["num_points"], dt).fields()
        for sp in DF:
            f[DF[sp]] = M.df_in_radial_order(f, DENSITY[sp], df_dt)
        fields.append(f)
    counts = split(fields, cfg["r_max_kpc"], totals, counts)
    base = torch.Generator(device=device).manual_seed(int(seed))
    parts = {sp: [] for sp in SPECIES}
    for i, f in enumerate(fields):
        gens = halo_generators(base)
        for sp in SPECIES:
            n = counts[sp][i]
            parts[sp].append(draw(f, sp, n, uniforms(gens[sp], sp, n),
                                  centers[i], velocities[i], cfg, dt, pdt))
    parts = {sp: {k: torch.cat([p[k] for p in v]) for k in v[0]}
             for sp, v in parts.items()}
    gas = parts["gas"]
    gas["density"], gas["thermal_energy"], gas["particle_velocity"] = mix(
        gas["particle_position"], fields, centers, velocities, pdt)
    box = cfg["box_kpc"]
    out = {}
    for sp in SPECIES:
        p = parts[sp]
        pos = p["particle_position"]
        keep = ~((pos < 0.0).any(-1) | (pos > box).any(-1))
        for block, name in NAMES.items():
            if name in p:
                out[f"{sp}/{name}"] = (p[name][keep].to(F64)
                                       / UNITS[block]).to(F32).numpy()
    for key in FIELDS + tuple(DF.values()):
        out[f"field/{key}"] = np.stack([f[key] for f in fields]).astype(
            np.float64)
    return out
