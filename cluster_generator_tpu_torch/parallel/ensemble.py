"""Cluster models from (M200, c), and the ensemble datagen batch program.

* :func:`build_one_cluster` / :func:`build_ensemble`: the canonical cluster
  for a whole batch of (M200, c) at once (the batch axis takes the place of
  the JAX package's ``vmap``).
* :func:`datagen_batches`: phase-space draws for an ensemble, batch by
  batch, as tensors on the device.  One batch is one call of the program
  :func:`_datagen_full_batch_fn` returns: models, DFs, speed tables (kernel
  K1, one launch per species and batch), joint tables and draws, each a
  function of whole-batch tensors.

The HDF5 catalog side of the product (writer, resume, readers,
``verify_catalog``) is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.draws import isotropic, uniform
from ..core.grid import linspace, log_radius_grid
from ..core.interp import _gather, interp_monotone, loguniform_lerp
from ..model.builders import build_from_dens_and_tden
from ..model.gravity import get_gravity
from ..profiles.library import (snfw_density_profile, snfw_mass_profile,
                                snfw_total_mass, vikhlinin_density_profile)
from ..profiles.relations import f_gas
from ..profiles.solvers import (find_overdensity_radius, find_radius_mass,
                                mass_within)
from ..virial import (build_joint_speed_pairs, compute_df, om_extended_df,
                      sample_speeds_joint, speed_inverse_cdf_table,
                      speed_table_defaults)

__all__ = ["build_one_cluster", "build_ensemble", "sample_ensemble_params",
           "datagen_batches", "prorate_species_counts", "nonfinite_counts"]


def _f64(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float64)
    return torch.as_tensor(np.asarray(x, dtype=np.float64), device=device)


def build_one_cluster(M200, conc, z=0.1, f_g=None, rmin=0.1, rmax=10000.0,
                      num_points=1000, with_df: bool = True,
                      gravity: str = "newtonian"):
    """The canonical cluster from (M200, c): sNFW total profile,
    Vikhlinin gas rescaled to f_gas(M500) M500, 2% stars.

    ``M200``/``conc``: float64 tensors of one batch shape (H,) — every halo
    is built at once and every field comes back as (H, num_points).
    ``with_df`` adds the dark-matter DF ``dm_df`` (radial ordering).
    """
    r200 = find_overdensity_radius(M200, 200.0, z=z)
    a = r200 / conc
    M = snfw_total_mass(M200, r200, a)
    rhot = snfw_density_profile(M, a)
    Mt = snfw_mass_profile(M, a)
    r500, M500 = find_radius_mass(Mt, z=z, delta=500.0, like=M200)
    if f_g is None:
        f_g = f_gas(M500)
    rhog = vikhlinin_density_profile(1.0, 100.0, r200, 1.0, 0.67, 3)
    rhog = (f_g * M500 / mass_within(rhog, r500)) * rhog
    rhos = 0.02 * rhot

    rr = log_radius_grid(rmin, rmax, num_points, device=M200.device)
    rr = rr.expand(M200.shape + rr.shape).contiguous()
    fields = build_from_dens_and_tden(rr, rhog, rhot, stellar_density=rhos,
                                      gravity=gravity)
    if with_df:
        ee = -torch.flip(fields["gravitational_potential"], (-1,))
        pden = torch.flip(fields["dark_matter_density"], (-1,))
        fields["dm_df"] = torch.flip(compute_df(ee, pden), (-1,))
    return fields


def build_ensemble(M200, conc, z=0.1, num_points=1000, with_df: bool = True,
                   device="cuda"):
    """A batch of clusters: (B,) M200 and conc -> fields of (B, num_points)."""
    dev = resolve_device(device)
    return build_one_cluster(_f64(M200, dev), _f64(conc, dev), z=z,
                             num_points=num_points, with_df=with_df)


def sample_ensemble_params(generator, n, logM_range=(14.0, 15.3),
                           conc_range=(3.0, 8.0), device="cuda"):
    """Draw an (M200, conc) ensemble, float64 on ``device``: log-uniform
    masses; conc falls with mass as a power law with log-normal scatter (a
    stand-in c(M) relation).  ``generator``: a ``torch.Generator`` on
    ``device`` (``None``: one seeded with 0)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    logM = uniform(generator, n, torch.float64, dev, logM_range[0],
                   logM_range[1])
    M200 = 10.0 ** logM
    c_mean = 5.0 * (M200 / 1.0e15) ** (-0.1)
    scatter = torch.randn(n, generator=generator, dtype=torch.float64,
                          device=dev) * 0.3
    conc = torch.clamp(c_mean * torch.exp(scatter), conc_range[0],
                       conc_range[1])
    return M200, conc


# Bump whenever the MEANING of the draws changes for a fixed configuration
# (a new table scheme, a different field-evaluation rule): 2 = gas energies
# evaluated AT the drawn radius (core/interp.loguniform_lerp).
_DRAWS_VERSION = 2
# OM (r_a set) draws version separately: 3 = the extended-grid f(Q)
# (virial.om_extended_df).
_OM_DRAWS_VERSION = 3


class _DatagenProgram:
    """The full-species datagen program for one configuration: ``(M200,
    conc)`` of a batch -> per-cluster draws with a leading batch axis,

        {"dm": (pos, vel, pmass), "star": (pos, vel, pmass),
         "gas": (pos, energy, pmass)}

    (a species with a zero count is absent).  ``pos``/``vel`` are
    (B, n, 3) float32, ``energy`` (B, n), ``pmass`` (B,).

    * dm / star: radius from the species' mass CDF at ``rq`` uniform
      quantile nodes, speed from the joint absolute-speed table (the star
      species gets its own Eddington DF in the shared potential), capped
      at the local escape speed;
    * gas: radius from the gas-mass CDF, thermal energy e = 1.5 P / rho
      evaluated at the DRAWN radius on the model's log grid.  Gas is at
      rest in hydrostatic equilibrium; no velocity is made.

    The stages are methods so that each can be timed alone; calling the
    object runs them all.  The ``star_*`` resolutions are coarser than the
    DM ones: the tables are per-cluster work and stars draw ~10x fewer
    particles.
    """

    def __init__(self, num_points, n_dm, n_gas, n_star, n_rows=128, rq=2048,
                 star_n_rows=64, star_rq=512, star_n_s=256, star_n_q=256,
                 r_a=None, gravity="newtonian"):
        self.num_points = int(num_points)
        self.counts = {"dm": int(n_dm), "star": int(n_star),
                       "gas": int(n_gas)}
        self.r_a = None if r_a is None else float(r_a)
        self.gravity = str(gravity)
        kw = speed_table_defaults()
        # per collisionless species: density and mass fields, table rows,
        # radius-quantile nodes, speed-table arguments
        self.species = {
            "dm": ("dark_matter_density", "dark_matter_mass",
                   self._row_idx(n_rows), rq, kw),
            "star": ("stellar_density", "stellar_mass",
                     self._row_idx(star_n_rows), star_rq,
                     dict(kw, n_s=star_n_s, n_q=star_n_q)),
        }
        self.gas_rq = rq

    def _row_idx(self, n):
        """Grid indices of the speed-table rows: ``n`` evenly spaced."""
        n_pts = self.num_points
        return np.unique(np.round(
            np.linspace(0, n_pts - 1, min(n, n_pts))).astype(int))

    def _active(self):
        return [sp for sp in ("dm", "star") if self.counts[sp]]

    # ------------------------------------------------------------ stages
    def models(self, M200, conc):
        """Equilibrium fields of the batch, (B, num_points) float64."""
        return build_one_cluster(M200, conc, num_points=self.num_points,
                                 with_df=False, gravity=self.gravity)

    def dfs(self, f):
        """``{species: (ee_spline, f_spline)}``: the grid each f(E) is
        splined over.  Ergodic: the model grid.  OM: f(Q) of the augmented
        density rho_Q = (1 + r^2/r_a^2) rho on
        :func:`~..virial.om_extended_df`'s extended grid (rows near r_max
        query E below the model's lowest energy)."""
        ee = -torch.flip(f["gravitational_potential"], (-1,))
        aug = (1.0 if self.r_a is None
               else 1.0 + (f["radius"] / self.r_a) ** 2)
        out = {}
        for sp in self._active():
            pden = torch.flip(f[self.species[sp][0]] * aug, (-1,))
            if self.r_a is None:
                out[sp] = (ee, compute_df(ee, pden))
            else:
                out[sp] = om_extended_df(ee, pden)
        return out

    def speed_table_inputs(self, f, dfs):
        """Arguments of :func:`~..virial.speed_inverse_cdf_table` for each
        species; the rows are ``ee[row_idx]``."""
        ee = -torch.flip(f["gravitational_potential"], (-1,))
        out = {}
        for sp in self._active():
            _, _, row_idx, _, kw = self.species[sp]
            idx = torch.as_tensor(row_idx, device=ee.device)
            out[sp] = dict(kw, ee=dfs[sp][0], f_vals=dfs[sp][1],
                           row_ee=ee[..., idx])
        return out

    def speed_tables(self, f, dfs):
        """``{species: (B, rows, n_q)}`` inverse speed-CDF tables: one K1
        launch per species for every cluster's rows."""
        return {sp: speed_inverse_cdf_table(**kw)
                for sp, kw in self.speed_table_inputs(f, dfs).items()}

    @staticmethod
    def _quantile_nodes(rr, mm, rq):
        """(B, rq) radius nodes at uniform mass quantiles."""
        qq = linspace(0.0, 1.0, rq, device=rr.device)
        return interp_monotone(qq * mm[..., -1:], mm, rr)

    def draw_tables(self, f, tabs):
        """What the draws gather from, per species: the radius nodes and
        (collisionless) the escape speed there and the joint
        absolute-speed table."""
        rr = f["radius"]
        psi = -f["gravitational_potential"]
        out = {}
        for sp in self._active():
            _, mass_field, row_idx, rq, _ = self.species[sp]
            tab = tabs[sp]
            idx = torch.as_tensor(row_idx, device=rr.device)
            row_ee = torch.flip(psi, (-1,))[..., idx]
            r_q = self._quantile_nodes(rr, f[mass_field], rq)
            psi_q = interp_monotone(r_q, rr, psi)
            joint = build_joint_speed_pairs(rr, psi, row_ee, tab, r_q,
                                            dtype=tab.dtype, psi_q=psi_q)
            out[sp] = {"r_q": r_q.to(torch.float32),
                       "v_esc": torch.sqrt(2.0 * psi_q).to(torch.float32),
                       "joint": joint, "mtot": f[mass_field][..., -1]}
        if self.counts["gas"]:
            r_q = self._quantile_nodes(rr, f["gas_mass"], self.gas_rq)
            out["gas"] = {"r_q": r_q.to(torch.float32),
                          "mtot": f["gas_mass"][..., -1]}
        return out

    @staticmethod
    def _draw_quantiles(u, rq):
        x = torch.clamp(u * (rq - 1), 0.0, rq - 1 - 1e-6)
        kq = torch.clamp_max(x.to(torch.int64), rq - 2)  # float32 ulp guard
        return kq, x - kq.to(torch.float32)

    def _collisionless(self, t, n, gen, uniforms):
        dev = t["r_q"].device
        f32 = torch.float32
        B = t["r_q"].shape[0]
        shape = (B, n)
        if uniforms is None:
            u_r = uniform(gen, shape, f32, dev)
            u_speed = pos_dir = vel_dir = None
        else:
            u_r, u_q, u_b, pos_dir, vel_dir = uniforms
            u_speed = (u_q, u_b)
        kq, wq = self._draw_quantiles(u_r, t["r_q"].shape[-1])
        radius = ((1.0 - wq) * _gather(t["r_q"], kq)
                  + wq * _gather(t["r_q"], kq + 1))
        v_esc = ((1.0 - wq) * _gather(t["v_esc"], kq)
                 + wq * _gather(t["v_esc"], kq + 1))
        speed = sample_speeds_joint(t["joint"], kq, wq, gen, u_speed)
        # the Bernoulli row pick can exceed the LOCAL escape speed by the
        # inter-node v_esc difference
        speed = torch.minimum(speed, v_esc.to(speed.dtype))
        rhat = isotropic(shape, f32, dev, gen, pos_dir)
        pos = radius[..., None] * rhat
        u = isotropic(shape, f32, dev, gen, vel_dir)
        speed = speed[..., None].to(f32)
        if self.r_a is None:
            vel = speed * u
        else:
            # Osipkov-Merritt: the table holds the AUGMENTED density's
            # f(Q), isotropic in (v_r, gamma v_t); map back by dividing
            # the tangential components by gamma(r)
            mu = torch.sum(u * rhat, dim=-1, keepdim=True)
            gamma = torch.sqrt(1.0 + (radius / self.r_a) ** 2)[..., None]
            vel = speed * (mu * rhat + (u - mu * rhat) / gamma)
        return pos, vel, (t["mtot"] / n).to(f32)

    def _gas(self, f, t, n, gen, uniforms):
        dev = t["r_q"].device
        f32 = torch.float32
        shape = (t["r_q"].shape[0], n)
        if uniforms is None:
            u_r = uniform(gen, shape, f32, dev)
            direction = None
        else:
            u_r, direction = uniforms
        kq, wq = self._draw_quantiles(u_r, t["r_q"].shape[-1])
        radius = ((1.0 - wq) * _gather(t["r_q"], kq)
                  + wq * _gather(t["r_q"], kq + 1))
        # thermal energy at the DRAWN radius on the log-uniform model
        # grid: a lerp of e between radius-quantile nodes is off by up to
        # ~60% across the wide innermost mass bin
        e_grid = (1.5 * f["pressure"] / f["density"]).to(f32)
        energy = loguniform_lerp(radius, f["radius"], e_grid)
        pos = radius[..., None] * isotropic(shape, f32, dev, gen, direction)
        return pos, energy, (t["mtot"] / n).to(f32)

    def draws(self, f, dtabs, generator=None, uniforms=None):
        """Every species' particles.  ``uniforms`` (optional) maps a
        species to its pre-drawn uniforms, each (B, n): ``(u_radius,
        u_speed, u_row, pos_dir, vel_dir)`` for dm and star, ``(u_radius,
        dir)`` for gas, with each ``*dir`` a pair for
        :func:`~..core.draws.isotropic`.  The generator is consumed in the
        order dm, star, gas."""
        uniforms = uniforms or {}
        out = {}
        for sp in self._active():
            out[sp] = self._collisionless(dtabs[sp], self.counts[sp],
                                          generator, uniforms.get(sp))
        if self.counts["gas"]:
            out["gas"] = self._gas(f, dtabs["gas"], self.counts["gas"],
                                   generator, uniforms.get("gas"))
        return out

    def __call__(self, M200, conc, generator=None, uniforms=None):
        if generator is None and uniforms is None:
            generator = torch.Generator(device=M200.device).manual_seed(0)
        f = self.models(M200, conc)
        tabs = self.speed_tables(f, self.dfs(f))
        return self.draws(f, self.draw_tables(f, tabs), generator, uniforms)


def _datagen_full_batch_fn(num_points, n_dm, n_gas, n_star, n_rows=128,
                           rq=2048, star_n_rows=64, star_rq=512,
                           star_n_s=256, star_n_q=256, r_a=None,
                           gravity="newtonian"):
    """The full-species datagen program, the ONE datagen core:
    ``batch(M200, conc, generator=None, uniforms=None)`` on float64 (B,)
    tensors (see :class:`_DatagenProgram`)."""
    return _DatagenProgram(num_points, n_dm, n_gas, n_star, n_rows, rq,
                           star_n_rows, star_rq, star_n_s, star_n_q, r_a,
                           gravity)


def _datagen_batch_fn(num_points, n_part, n_rows=128, rq=2048, r_a=None,
                      gravity="newtonian"):
    """The DM-only program: the full-species core with gas = star = 0,
    returning the bare ``(pos, vel, pmass)``."""
    full = _datagen_full_batch_fn(num_points, n_part, 0, 0, n_rows, rq,
                                  r_a=r_a, gravity=gravity)

    def batch(M200, conc, generator=None, uniforms=None):
        return full(M200, conc, generator, uniforms)["dm"]

    return batch


def prorate_species_counts(n_total, M200=1.5e15, conc=4.0, num_points=512,
                           device="cuda"):
    """Split a per-cluster particle budget across species by mass fraction,
    from one representative cluster (ensemble batches need fixed
    per-species counts).  Returns ``{"dm": n, "gas": n, "star": n}``
    summing to ``n_total``."""
    dev = resolve_device(device)
    f = build_one_cluster(_f64([M200], dev), _f64([conc], dev),
                          num_points=num_points, with_df=False)
    m_dm = float(f["dark_matter_mass"][0, -1])
    m_gas = float(f["gas_mass"][0, -1])
    m_star = float(f["stellar_mass"][0, -1])
    tot = m_dm + m_gas + m_star
    n_dm = int(round(n_total * m_dm / tot))
    n_gas = int(round(n_total * m_gas / tot))
    n_star = max(n_total - n_dm - n_gas, 0)
    return {"dm": n_dm, "gas": n_gas, "star": n_star}


def _check_r_a(r_a):
    if r_a is not None and not float(r_a) > 0.0:
        # r_a = 0 would make every velocity NaN (the augmented density
        # hits inf); negatives only enter as r_a**2
        raise ValueError(f"anisotropy_radius must be positive (got "
                         f"{r_a!r}); omit it (None) for the isotropic "
                         "product")


def _resolve_batch_fn(n_particles_per_cluster, num_points, r_a=None,
                      gravity="newtonian"):
    """``(full?, per-species counts, batch program)`` for a product
    selector: an int is the DM phase-space product, a dict the
    full-species one."""
    _check_r_a(r_a)
    get_gravity(gravity)  # unknown law names fail before any work
    full = isinstance(n_particles_per_cluster, dict)
    if full:
        unknown = set(n_particles_per_cluster) - {"dm", "gas", "star"}
        if unknown:
            raise ValueError(
                f"unknown species {sorted(unknown)} in "
                "n_particles_per_cluster; expected keys from "
                "{'dm', 'gas', 'star'} (a typo here would otherwise "
                "silently drop the species)")
        counts = {s: int(n_particles_per_cluster.get(s, 0))
                  for s in ("dm", "gas", "star")}
        batch_fn = _datagen_full_batch_fn(num_points, counts["dm"],
                                          counts["gas"], counts["star"],
                                          r_a=r_a, gravity=gravity)
    else:
        counts = None
        batch_fn = _datagen_batch_fn(num_points,
                                     int(n_particles_per_cluster),
                                     r_a=r_a, gravity=gravity)
    return full, counts, batch_fn


def _batch_generator(seed, b0, device):
    """The generator of the batch at offset ``b0``: seeded from
    ``(seed, b0)`` alone."""
    mixed = (int(seed) * 0x9E3779B97F4A7C15 + int(b0) + 1) % (2**63)
    return torch.Generator(device=device).manual_seed(mixed)


def datagen_batches(M200, conc, n_particles_per_cluster, batch_size=256,
                    num_points=512, seed=0, anisotropy_radius=None,
                    gravity="newtonian", device="cuda"):
    """Yield ``(b0, batch_out)``: an ensemble's draws, batch by batch, as
    tensors on ``device``.

    ``batch_out`` is the batch program's output: for an int count
    ``(positions, velocities, particle_masses)`` with a leading batch
    axis; for a species dict ``{"dm": (pos, vel, pmass), "star": (pos,
    vel, pmass), "gas": (pos, energy, pmass)}``.  Batch k+1 is enqueued on
    the device before batch k is yielded, so the consumer's work overlaps
    the next batch's.

    Random numbers: ``seed`` is an int, or a callable ``b0 ->
    torch.Generator`` on ``device``.  Each batch draws from its own
    generator, seeded from ``(seed, b0)``: a batch is reproducible and
    does not depend on which batches ran before it.  It does depend on
    ``batch_size`` (a cluster's draws change when it lands in another
    batch or at another position in it).
    """
    dev = resolve_device(device)
    M200 = _f64(M200, dev)
    conc = _f64(conc, dev)
    _, _, batch_fn = _resolve_batch_fn(n_particles_per_cluster, num_points,
                                       r_a=anisotropy_radius,
                                       gravity=gravity)
    make_gen = seed if callable(seed) else (
        lambda b0: _batch_generator(seed, b0, dev))
    pending = None
    for b0 in range(0, int(M200.shape[0]), batch_size):
        nxt = (b0, batch_fn(M200[b0:b0 + batch_size],
                            conc[b0:b0 + batch_size], make_gen(b0)))
        if pending is not None:
            yield pending
        pending = nxt
    if pending is not None:
        yield pending


def nonfinite_counts(batch_out):
    """Number of non-finite values per species and output of one batch:
    ``{"dm/pos": 0, "dm/vel": 0, "dm/pmass": 0, ..., "gas/energy": 0}``
    (a bare DM tuple counts as ``"dm"``).  Reads the device."""
    if not isinstance(batch_out, dict):
        batch_out = {"dm": batch_out}
    out = {}
    for sp, arrays in batch_out.items():
        names = ("pos", "energy" if sp == "gas" else "vel", "pmass")
        for name, a in zip(names, arrays):
            out[f"{sp}/{name}"] = int((~torch.isfinite(a)).sum())
    return out
