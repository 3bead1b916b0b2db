"""Cluster models from (M200, c), the ensemble datagen batch program, and
its HDF5 catalogs.

* :func:`build_one_cluster` / :func:`build_ensemble`: the canonical cluster
  for a whole batch of (M200, c) at once (the batch axis takes the place of
  the JAX package's ``vmap``).
* :func:`datagen_batches`: phase-space draws for an ensemble, batch by
  batch, as tensors on the device.  One batch is one call of the program
  :func:`_datagen_full_batch_fn` returns: models, DFs, speed tables (kernel
  K1, one launch per species and batch), joint tables and draws, each a
  function of whole-batch tensors.  The factories are memoized by
  configuration, and on the card each batch size is one CUDA graph,
  captured at its first call and replayed (:mod:`..core.compiled`).
* The catalogs: :func:`ensemble_datagen` (and its multi-process form)
  streams the same batches to one HDF5 file, crash-resumable; its device
  stage (:func:`_catalog_batches`: the batch program, then the copy to
  pinned host memory on a side stream) and its layout
  (:func:`_cluster_records`) are functions of their own, which need no
  ``h5py``.  :func:`read_catalog`, :func:`catalog_batches`,
  :func:`verify_catalog` (physics QA against models rebuilt in batches on
  the device; the per-cluster checks are :func:`_check_cluster`) and
  :func:`catalog_to_particles` read them back.  ``h5py`` is imported
  inside the functions that open files.
* ``mesh=`` (an ``(ens, part)`` mesh, :func:`~.mesh.make_mesh`): each rank
  computes its ``ens`` rows of every batch the ``ens`` size divides, from
  the batch's uniforms drawn whole and sliced, so that the draws do not
  depend on the world size; a short batch is computed whole.  The writers
  gather each batch onto the writing rank.  The mesh forms run the batch
  program's eager body (no graph).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core import compiled
from ..core.device import f64_on, host_to_device, resolve_device
from ..core.draws import collisionless_uniforms, gas_uniforms, uniform
from ..core.grid import linspace, log_radius_grid
from ..core.interp import interp_monotone
from ..core.profiling import device_stage, span
from ..core.staging import stream_to_host, to_host
from ..model.builders import build_from_dens_and_tden
from ..ops.draw_particles import draw_collisionless, draw_gas
from ..model.gravity import get_gravity
from ..profiles.library import (snfw_density_profile, snfw_mass_profile,
                                snfw_total_mass, vikhlinin_density_profile)
from ..profiles.relations import f_gas
from ..profiles.solvers import (find_overdensity_radius, find_radius_mass,
                                mass_within)
from ..virial import (build_joint_speed_pairs, compute_df, om_extended_df,
                      speed_inverse_cdf_table, speed_table_defaults)
from .mesh import (all_gather_rows, ens_rows, mesh_device, replicated,
                   sharded)
from .qa import QA_TOLERANCES as _QA

__all__ = ["build_one_cluster", "build_ensemble", "sample_ensemble_params",
           "datagen_batches", "prorate_species_counts", "nonfinite_counts",
           "ensemble_datagen", "ensemble_datagen_multihost", "read_catalog",
           "catalog_batches", "verify_catalog", "catalog_to_particles"]


def build_one_cluster(M200, conc, z=0.1, f_g=None, rmin=0.1, rmax=10000.0,
                      num_points=1000, with_df: bool = True,
                      gravity: str = "newtonian"):
    """The canonical cluster from (M200, c): sNFW total profile,
    Vikhlinin gas rescaled to f_gas(M500) M500, 2% stars.

    ``M200``/``conc``: float64 tensors of one batch shape (H,) — every halo
    is built at once and every field comes back as (H, num_points).
    ``z``: a float or a 0-d float64 tensor (an input of a program that
    calls this).  ``with_df`` adds the dark-matter DF ``dm_df`` (radial
    ordering).
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
        with device_stage("dfs", ee):
            dm_df = compute_df(ee, pden)
        fields["dm_df"] = torch.flip(dm_df, (-1,))
    return fields


def build_ensemble(M200, conc, z=0.1, num_points=1000, with_df: bool = True,
                   device="cuda"):
    """A batch of clusters: (B,) M200 and conc -> fields of (B, num_points)."""
    dev = resolve_device(device)
    return build_one_cluster(f64_on(M200, dev), f64_on(conc, dev), z=z,
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
# A catalog records its draws' version plus this offset: the port draws
# from torch's generators, whose draws never equal the JAX package's
# threefry draws for the same scheme, so a catalog of one package must
# never be resumed by the other (a resume refuses another version).  2000
# since the cumulative sums of the model build are row-invariant
# (``core.quadrature.cumsum``), which moved the tables by float32 rounding:
# a catalog of the earlier port (1000) is not resumed either.
_PORT_DRAWS = 2000


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

    The stages are methods so that each can be timed alone; :meth:`run`
    runs them all eagerly.  Calling the object runs the batch as the
    memoized program of this configuration and the batch's size
    (:mod:`..core.compiled`: a CUDA graph on the card, :meth:`run` on the
    CPU), its uniforms drawn from the generator before the graph replays.
    The ``star_*`` resolutions are coarser than the DM ones: the tables
    are per-cluster work and stars draw ~10x fewer particles.
    """

    def __init__(self, num_points, n_dm, n_gas, n_star, n_rows=128, rq=2048,
                 star_n_rows=64, star_rq=512, star_n_s=256, star_n_q=256,
                 r_a=None, gravity="newtonian"):
        self.num_points = int(num_points)
        self.counts = {"dm": int(n_dm), "star": int(n_star),
                       "gas": int(n_gas)}
        self.r_a = None if r_a is None else float(r_a)
        self.gravity = str(gravity)
        # every argument the program bakes in: its key (the configuration
        # joins it in compiled.program)
        self.key = ("datagen", self.num_points, int(n_dm), int(n_gas),
                    int(n_star), int(n_rows), int(rq), int(star_n_rows),
                    int(star_rq), int(star_n_s), int(star_n_q), self.r_a,
                    self.gravity)
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
        self._row_tensors = {}

    def _row_idx(self, n):
        """Grid indices of the speed-table rows: ``n`` evenly spaced."""
        n_pts = self.num_points
        return np.unique(np.round(
            np.linspace(0, n_pts - 1, min(n, n_pts))).astype(int))

    def _rows(self, sp, device):
        """The speed-table rows' grid indices of ``sp`` on ``device``,
        copied there once per program."""
        key = (sp, device)
        if key not in self._row_tensors:
            self._row_tensors[key] = host_to_device(self.species[sp][2],
                                                    device)
        return self._row_tensors[key]

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
            with device_stage("dfs", ee):
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
            kw = self.species[sp][4]
            idx = self._rows(sp, ee.device)
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
            _, mass_field, _, rq, _ = self.species[sp]
            tab = tabs[sp]
            idx = self._rows(sp, rr.device)
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

    def _collisionless(self, t, n, gen, uniforms):
        shape = (t["r_q"].shape[0], n)
        if uniforms is None:
            uniforms = collisionless_uniforms(gen, shape, torch.float32,
                                              t["r_q"].device)
        pos, vel = draw_collisionless(uniforms, t["r_q"], t["v_esc"],
                                      t["joint"], self.r_a)
        return pos, vel, (t["mtot"] / n).to(torch.float32)

    def _gas(self, f, t, n, gen, uniforms):
        f32 = torch.float32
        shape = (t["r_q"].shape[0], n)
        if uniforms is None:
            uniforms = gas_uniforms(gen, shape, f32, t["r_q"].device)
        e_grid = (1.5 * f["pressure"] / f["density"]).to(f32)
        pos, energy = draw_gas(uniforms, t["r_q"], f["radius"].to(f32),
                               e_grid)
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

    def uniforms(self, B, generator, device, out=None):
        """Every uniform a batch of ``B`` takes from ``generator``, drawn
        in the order :meth:`draws` draws them, each (B, n): ``draws`` with
        these equals ``draws`` with the generator, bit for bit, and a slice
        of rows gives those clusters' draws.  ``out``: the same dict, filled
        in place and returned."""
        f32 = torch.float32
        out = out or {}
        res = {sp: collisionless_uniforms(generator, (B, self.counts[sp]),
                                          f32, device, out=out.get(sp))
               for sp in self._active()}
        if self.counts["gas"]:
            res["gas"] = gas_uniforms(generator, (B, self.counts["gas"]),
                                      f32, device, out=out.get("gas"))
        return res

    def run(self, M200, conc, generator=None, uniforms=None):
        """The batch, eagerly: the program's body (the functions it calls
        run inline, as in the program).  Its stage marks
        (:func:`~..core.profiling.device_stage`), in order: models, dfs,
        models, dfs, models (a DF per species), end; tables, end; draws,
        end."""
        if generator is None and uniforms is None:
            generator = torch.Generator(device=M200.device).manual_seed(0)
        with compiled.inline():
            with device_stage("models", M200):
                f = self.models(M200, conc)
                dfs = self.dfs(f)
            with device_stage("tables", M200):
                dtabs = self.draw_tables(f, self.speed_tables(f, dfs))
            with device_stage("draws", M200):
                return self.draws(f, dtabs, generator, uniforms)

    def _body(self, M200, conc, uniforms):
        return self.run(M200, conc, None, uniforms)

    def __call__(self, M200, conc, generator=None, uniforms=None):
        dev, B = M200.device, int(M200.shape[0])
        draw = compiled.drawer(uniforms, generator, dev, lambda gen, out: (
            self.uniforms(B, gen, dev, out=out)))
        return compiled.run(self.key, self._body, (M200, conc), draw)


def _datagen_full_batch_fn(num_points, n_dm, n_gas, n_star, n_rows=128,
                           rq=2048, star_n_rows=64, star_rq=512,
                           star_n_s=256, star_n_q=256, r_a=None,
                           gravity="newtonian"):
    """The full-species datagen program, the ONE datagen core:
    ``batch(M200, conc, generator=None, uniforms=None)`` on float64 (B,)
    tensors (see :class:`_DatagenProgram`).  Memoized on every value it
    bakes in, the ``cgparams['numerical']`` table knobs and the
    ``cgparams['gravity']`` constants included (the JAX package's factory
    holds the knobs)."""
    return _datagen_full_batch_cached(
        int(num_points), int(n_dm), int(n_gas), int(n_star), int(n_rows),
        int(rq), int(star_n_rows), int(star_rq), int(star_n_s),
        int(star_n_q), None if r_a is None else float(r_a), str(gravity),
        compiled.config_key())


@functools.lru_cache(maxsize=32)
def _datagen_full_batch_cached(num_points, n_dm, n_gas, n_star, n_rows, rq,
                               star_n_rows, star_rq, star_n_s, star_n_q, r_a,
                               gravity, config):
    del config  # in the memo key only: __init__ reads the knobs
    return _DatagenProgram(num_points, n_dm, n_gas, n_star, n_rows, rq,
                           star_n_rows, star_rq, star_n_s, star_n_q, r_a,
                           gravity)


def _datagen_batch_fn(num_points, n_part, n_rows=128, rq=2048, r_a=None,
                      gravity="newtonian"):
    """The DM-only program: the full-species core with gas = star = 0,
    returning the bare ``(pos, vel, pmass)``; memoized like
    :func:`_datagen_full_batch_fn`."""
    return _datagen_batch_cached(int(num_points), int(n_part), int(n_rows),
                                 int(rq), None if r_a is None else float(r_a),
                                 str(gravity), compiled.config_key())


@functools.lru_cache(maxsize=32)
def _datagen_batch_cached(num_points, n_part, n_rows, rq, r_a, gravity,
                          config):
    del config  # in the memo key only
    full = _datagen_full_batch_fn(num_points, n_part, 0, 0, n_rows, rq,
                                  r_a=r_a, gravity=gravity)

    def batch(M200, conc, generator=None, uniforms=None):
        return full(M200, conc, generator, uniforms)["dm"]

    batch.uniforms = full.uniforms
    return batch


def prorate_species_counts(n_total, M200=1.5e15, conc=4.0, num_points=512,
                           device="cuda"):
    """Split a per-cluster particle budget across species by mass fraction,
    from one representative cluster (ensemble batches need fixed
    per-species counts).  Returns ``{"dm": n, "gas": n, "star": n}``
    summing to ``n_total``."""
    dev = resolve_device(device)
    f = build_one_cluster(f64_on([M200], dev), f64_on([conc], dev),
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


def _mesh_call(batch_fn, mesh, row_args, rest, generator):
    """A batch program on this rank's ``ens`` rows of one batch:
    ``(out, rows)``.  ``row_args`` are the per-row inputs, ``rest`` the
    others.  The rank draws the whole batch's uniforms from ``generator``
    (``batch_fn.uniforms``) and keeps its rows, so every rank's draws are
    those of the whole batch.  ``rows`` is ``(lo, hi)``, or ``None`` when
    the batch ran whole: no mesh, or a batch the ``ens`` size does not
    divide.  The batch runs as the memoized program at the rows it runs
    on (the rank's, given its slice of the uniforms), as the JAX
    package's jitted batch runs under the mesh: no collective sits inside
    it, so every backend's ranks replay their own programs."""
    B = int(row_args[0].shape[0])
    rows = None if mesh is None else ens_rows(mesh, B)
    if rows is None:
        return batch_fn(*row_args, *rest, generator), None
    lo, hi = rows
    u = compiled.tree_map(lambda t: t[lo:hi],
                          batch_fn.uniforms(B, generator, row_args[0].device))
    return batch_fn(*(a[lo:hi] for a in row_args), *rest, None, u), rows


def _as_dtensors(mesh, out, rows, B):
    """A batch output as DTensors: sharded over ``ens`` when each rank ran
    its rows, replicated when the batch ran whole."""
    if rows is None:
        return compiled.tree_map(lambda t: replicated(mesh, t), out)
    return compiled.tree_map(lambda t: sharded(mesh, t, "ens", B), out)


def _gathered(mesh, out, rows):
    """A batch output whole on every rank of the ``ens`` group."""
    if rows is None:
        return out
    return compiled.tree_map(lambda t: all_gather_rows(mesh, t), out)


def datagen_batches(M200, conc, n_particles_per_cluster, batch_size=256,
                    num_points=512, seed=0, mesh=None,
                    anisotropy_radius=None, gravity="newtonian",
                    device="cuda"):
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

    ``mesh``: an ``(ens, part)`` mesh; the tensors then live on the mesh's
    device.  Each rank computes its ``ens`` rows of the batch, and the
    outputs are DTensors sharded over ``ens`` (replicated for a batch the
    ``ens`` size does not divide, which every rank computes whole).  The
    draws are those without a mesh: the program's arithmetic on a row does
    not depend on how many rows it runs on.
    """
    dev = resolve_device(device) if mesh is None else mesh_device(mesh)
    M200 = f64_on(M200, dev)
    conc = f64_on(conc, dev)
    _, _, batch_fn = _resolve_batch_fn(n_particles_per_cluster, num_points,
                                       r_a=anisotropy_radius,
                                       gravity=gravity)
    make_gen = seed if callable(seed) else (
        lambda b0: _batch_generator(seed, b0, dev))

    def one(b0):
        with span("cg.host.inputs"):
            sl = slice(b0, b0 + batch_size)
            rows_in, gen = (M200[sl], conc[sl]), make_gen(b0)
        out, rows = _mesh_call(batch_fn, mesh, rows_in, (), gen)
        if mesh is None:
            return out
        return _as_dtensors(mesh, out, rows, int(rows_in[0].shape[0]))

    pending = None
    for b0 in range(0, int(M200.shape[0]), batch_size):
        nxt = (b0, one(b0))
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


# ------------------------------------------------------------------ catalogs
def _flat_outputs(out):
    """A batch program's output as ``(names, tensors)``: ``"dm/0"`` ... in
    species order (a bare DM tuple counts as ``"dm"``)."""
    if not isinstance(out, dict):
        out = {"dm": out}
    names, tensors = [], []
    for sp, arrays in out.items():
        for j, a in enumerate(arrays):
            names.append((sp, j))
            tensors.append(a)
    return names, tensors


def _catalog_batches(M200, conc, batch_fn, batch_size, seed, b0s,
                     mesh=None, stage=True):
    """The device stage of :func:`ensemble_datagen`: for each batch offset
    in ``b0s`` the batch program with the generator of ``(seed, b0)``, its
    draws staged to pinned host memory while the next batch computes
    (:func:`~..core.staging.stream_to_host`).  Yields ``(b0, host)`` with
    ``host`` shaped as the program's output (``{species: (pos, vel or
    energy, pmass)}``, numpy).  A batch's arrays are valid until the next
    one is asked for.  ``mesh``: each rank computes its ``ens`` rows and
    the batch is gathered whole (:func:`_mesh_call`); ``stage=False`` (a
    rank that writes nothing) joins the collectives and yields
    ``(b0, None)``."""
    dev = M200.device

    def programs():
        for b0 in b0s:
            sl = slice(b0, b0 + batch_size)
            out, rows = _mesh_call(batch_fn, mesh, (M200[sl], conc[sl]), (),
                                   _batch_generator(seed, b0, dev))
            names, tensors = _flat_outputs(_gathered(mesh, out, rows))
            yield (b0, names), tensors

    if not stage:
        for (b0, _), _ in programs():
            yield b0, None
        return
    for (b0, names), arrays in stream_to_host(programs()):
        host = {}
        for (sp, j), a in zip(names, arrays):
            host.setdefault(sp, []).append(a)
        yield b0, {sp: tuple(v) for sp, v in host.items()}


def _cluster_records(full, b0, Mb, cb, out):
    """One batch in the catalog's layout: per cluster ``(group name,
    attrs, [(dataset name, array), ...])``.  ``Mb``/``cb`` host float64,
    ``out`` a host batch of :func:`_catalog_batches`."""
    for i in range(Mb.shape[0]):
        attrs = {"M200": float(Mb[i]), "conc": float(cb[i])}
        data = []
        if not full:
            pos, vel, pmass = out["dm"]
            attrs["particle_mass"] = float(pmass[i])
            data = [("particle_position", pos[i]),
                    ("particle_velocity", vel[i])]
        else:
            for sp in ("dm", "star"):
                if sp in out:
                    pos, vel, pmass = out[sp]
                    attrs[f"particle_mass_{sp}"] = float(pmass[i])
                    data += [(f"{sp}_position", pos[i]),
                             (f"{sp}_velocity", vel[i])]
            if "gas" in out:
                pos, energy, pmass = out["gas"]
                attrs["particle_mass_gas"] = float(pmass[i])
                data += [("gas_position", pos[i]),
                         ("gas_thermal_energy", energy[i])]
        yield f"cluster_{b0 + i:06d}", attrs, data


def _record_dict(record):
    """A record of :func:`_cluster_records` as :func:`read_catalog` yields
    the cluster: datasets and attrs in one dict."""
    _, attrs, data = record
    out = dict(data)
    out.update(attrs)
    return out


def _write_records(f, records):
    """Create each record's group with its attrs and datasets; the data
    goes through the raw pwrite path (``core/h5raw.RawWriter``)."""
    from ..core.h5raw import RawWriter

    raw = RawWriter(f)
    for name, attrs, data in records:
        g = f.create_group(name)
        for k, v in attrs.items():
            g.attrs[k] = v
        for k, arr in data:
            raw.add(g, k, arr)
    raw.flush()


def _check_path(filename, overwrite, resume):
    """``(path, resuming)`` of a catalog call; refuses to overwrite an
    existing file unless asked."""
    import pathlib

    path = pathlib.Path(filename)
    if resume and overwrite:
        raise ValueError("resume=True and overwrite=True are mutually "
                         "exclusive (resume keeps completed batches; "
                         "overwrite discards the file)")
    resuming = resume and path.exists()
    if path.exists() and not overwrite and not resuming:
        raise IOError(f"{path} exists (pass overwrite=True, or "
                      "resume=True to continue an interrupted run)")
    return path, resuming


def ensemble_datagen(M200, conc, filename, n_particles_per_cluster,
                     batch_size=256, num_points=512, seed=0,
                     overwrite=False, resume=False, mesh=None,
                     anisotropy_radius=None, gravity="newtonian",
                     device="cuda", _only_batches=None, _extra_attrs=None,
                     _group=None):
    """Stream an ensemble's particle draws to ONE HDF5 file.

    ``n_particles_per_cluster`` selects the product:

    * **int**: DM phase space only; each cluster lands as
      ``cluster_%06d/{particle_position, particle_velocity}`` (kpc,
      kpc/Myr) with ``M200 / conc / particle_mass`` attrs;
    * **dict** ``{"dm": n, "gas": n, "star": n}``: the full per-cluster
      product, ``dm_position / dm_velocity / star_position /
      star_velocity / gas_position / gas_thermal_energy`` datasets and
      per-species ``particle_mass_*`` attrs (gas is at rest in HSE and has
      no velocity dataset).

    A catalog holds exactly what :func:`datagen_batches` yields for the same
    ``(seed, batch_size, num_points)``: batch ``b0`` draws from the
    generator seeded from ``(seed, b0)``.  The host writes batch k while
    the device computes batch k+1; the copy runs on its own stream into
    pinned memory (:func:`_catalog_batches`).

    ``anisotropy_radius``: Osipkov-Merritt r_a in kpc for every cluster
    (``None``: isotropic).  ``resume=True`` restarts an interrupted run:
    completed batches are kept verbatim, the partially written batch is
    dropped and recomputed, the rest run.  A batch counts as complete only
    when the ``_batches_done`` marker, written after its bytes land, lists
    it; files without the marker fall back to the presence check.  The run
    configuration must match the file's (counts, batch size, grid, seed,
    shard identity, gravity, r_a and the draws' version), or the call
    raises: the port's draws come from torch's generators, so a catalog of
    the JAX package (another ``draws_version``) is never resumed here.

    ``mesh``: an ``(ens, part)`` mesh (:func:`~.mesh.make_mesh`), whose
    device the tensors then live on.  Each rank computes its ``ens`` rows
    of every batch the ``ens`` size divides (a short batch whole), the
    batch is gathered, and only rank 0 opens the file; every rank of the
    world must call, and every rank returns the filename.  The ``ens``
    size is part of the resume config (``mesh_ens``, 0 without a mesh), as
    in the JAX package, whose partitioned programs round differently.
    Returns the filename.
    """
    from ..core.logging import mylog

    dev = resolve_device(device) if mesh is None else mesh_device(mesh)
    M200 = f64_on(M200, dev)
    conc = f64_on(conc, dev)
    n_cl = int(M200.shape[0])
    full, counts, batch_fn = _resolve_batch_fn(n_particles_per_cluster,
                                               num_points,
                                               r_a=anisotropy_radius,
                                               gravity=gravity)
    mylog.info("Ensemble datagen: %d clusters x %s particles%s -> %s",
               n_cl, n_particles_per_cluster,
               "" if anisotropy_radius is None
               else f" (OM r_a={anisotropy_radius:g} kpc)", filename)
    if full:
        expected = []
        for sp in ("dm", "star"):
            if counts[sp]:
                expected += [f"{sp}_position", f"{sp}_velocity"]
        if counts["gas"]:
            expected += ["gas_position", "gas_thermal_energy"]
    else:
        expected = ["particle_position", "particle_velocity"]
    extra = _extra_attrs or {}
    # everything that shapes the draws, so that a resume splices only
    # batches the interrupted run would have written
    config = {"draws_version": _PORT_DRAWS + (
                  _DRAWS_VERSION if anisotropy_radius is None
                  else _OM_DRAWS_VERSION),
              "n_clusters": n_cl, "batch_size": int(batch_size),
              "num_points": int(num_points),
              "r_a": (0.0 if anisotropy_radius is None
                      else float(anisotropy_radius)),
              "mesh_ens": _mesh_ens(mesh),
              "gravity": str(gravity),
              "shard_rank": int(extra.get("shard_rank", 0)),
              "shard_count": int(extra.get("shard_count", 1)),
              "key_data": np.asarray([int(seed)], np.int64)}
    if full:
        for s, n in counts.items():
            config[f"n_{s}_per_cluster"] = n
    else:
        config["n_particles_per_cluster"] = int(n_particles_per_cluster)
    M_host = M200.cpu().numpy()
    c_host = conc.cpu().numpy()

    def produce(todo, write=True):
        for b0, out in _catalog_batches(M200, conc, batch_fn, batch_size,
                                        seed, todo, mesh=mesh, stage=write):
            sl = slice(b0, b0 + batch_size)
            yield b0, (out if out is None else _cluster_records(
                full, b0, M_host[sl], c_host[sl], out))

    _stream_batched_catalog(filename, overwrite, resume, config,
                            _extra_attrs, expected, "cluster", n_cl,
                            batch_size, _only_batches, produce, mesh, _group)
    return str(filename)


def _mesh_ens(mesh):
    """The resume config's ``mesh_ens``: the mesh's ``ens`` size, 0 without
    a mesh."""
    return 0 if mesh is None else int(mesh.size(
        mesh.mesh_dim_names.index("ens")))


def _from_writer(obj, group):
    """``obj`` of the group's first rank on every rank of ``group`` (None:
    the world); an exception there is raised everywhere."""
    import torch.distributed as dist

    box = [obj]
    src = 0 if group is None else dist.get_global_rank(group, 0)
    dist.broadcast_object_list(box, src=src, group=group)
    if isinstance(box[0], Exception):
        raise box[0]
    return box[0]


def _stream_batched_catalog(path, overwrite, resume, config, extra_attrs,
                            expected, group_prefix, n_items, batch_size,
                            only_batches, produce, mesh=None, group=None):
    """The streaming loop of both catalog products: the path checked, the
    config recorded (or, on resume, validated key by key), the batches
    still to do found, and each batch written, then marked done.

    ``produce(todo, write)`` yields ``(b0, records)`` for the batch offsets
    ``todo`` in order (:func:`_cluster_records`' layout; ``None`` when not
    ``write``); groups are named ``{group_prefix}_{index:06d}``.  With a
    mesh only the first rank of ``group`` (None: the world) opens the file;
    it sends the others the batches to do, or its error, and the others
    join the batches' collectives without writing; all meet at a barrier
    at the end."""
    import torch.distributed as dist

    if mesh is not None and dist.get_rank(group) != 0:
        todo = _from_writer(None, group)
        for _ in produce(todo or [], False):
            pass
        dist.barrier(group)
        return
    import h5py

    f = None
    try:
        path, resuming = _check_path(path, overwrite, resume)
        f = h5py.File(path, "a" if resuming else "w")
        todo, done = _catalog_todo(f, path, resuming, config, extra_attrs,
                                   expected, group_prefix, n_items,
                                   batch_size, only_batches)
    except (OSError, ValueError) as e:
        if f is not None:
            f.close()
        if mesh is not None:
            _from_writer(e, group)
        raise
    if mesh is not None:
        _from_writer(todo, group)
    with f:
        if todo is not None:
            for b0, records in produce(todo):
                _write_records(f, records)
                # after the batch's bytes are in the file: the marker is
                # what makes it count on resume
                if done is not None:
                    done.add(int(b0))
                    f.attrs["_batches_done"] = np.asarray(sorted(done),
                                                          np.int64)
            f.attrs["complete"] = True
    if mesh is not None:
        dist.barrier(group)


def _catalog_todo(f, path, resuming, config, extra_attrs, expected,
                  group_prefix, n_items, batch_size, only_batches):
    """``(todo, done)`` of an open catalog: the batch offsets still to
    write (``None`` when the catalog is complete) and the set of batches
    marked done (``None`` for a file that predates the marker).  A new file
    gets the config; a resumed one must match it."""
    from ..core.logging import mylog

    if resuming:
        if bool(f.attrs.get("complete", False)):
            mylog.info("Catalog %s is already complete.", path)
            return None, None
        # the values of a plain run, for files that predate a key
        defaults = {"shard_rank": 0, "shard_count": 1, "r_a": 0.0,
                    "mesh_ens": 0, "gravity": "newtonian"}
        for k, v in config.items():
            have = f.attrs.get(k, defaults.get(k))
            if have is None or not np.array_equal(have, v):
                raise ValueError(
                    f"resume config mismatch on {k!r}: file has "
                    f"{have!r}, this run asks {v!r}; resuming "
                    "would splice incompatible draws")
    else:
        for k, v in config.items():
            f.attrs[k] = v
        for k, v in (extra_attrs or {}).items():
            f.attrs[k] = v
        f.attrs["units"] = "kpc, kpc/Myr, Msun (galactic)"
        f.attrs["_batches_done"] = np.zeros((0,), np.int64)
    if resuming and "_batches_done" in f.attrs:
        done = set(np.asarray(f.attrs["_batches_done"]).tolist())
    elif resuming:
        mylog.warning(
            "%s predates the _batches_done marker; falling back to "
            "dataset-presence completion checks (cannot detect a "
            "crash inside a batch's raw write window)", path)
        done = None
    else:
        done = set()

    todo = []
    mine = (range(0, n_items, batch_size) if only_batches is None
            else sorted(only_batches))
    for b0 in mine:
        names = [f"{group_prefix}_{i:06d}"
                 for i in range(b0, min(b0 + batch_size, n_items))]
        have_all = all(nm in f and all(ds in f[nm] for ds in expected)
                       for nm in names)
        if resuming and have_all and (done is None or b0 in done):
            continue
        if resuming:
            for nm in names:  # drop the partial batch, recompute it
                if nm in f:
                    del f[nm]
        todo.append(b0)
    if resuming:
        mylog.info("Resuming %s: %d/%d batches already complete.",
                   path, len(mine) - len(todo), len(mine))
    return todo, done


def _rank_and_count(rank, nproc):
    """This process's rank and the process count: ``torch.distributed``'s
    when it is initialized, else 0 and 1, unless given."""
    import torch.distributed as dist

    live = dist.is_available() and dist.is_initialized()
    if rank is None:
        rank = dist.get_rank() if live else 0
    if nproc is None:
        nproc = dist.get_world_size() if live else 1
    if not 0 <= rank < nproc:
        raise ValueError(f"rank {rank} outside [0, {nproc})")
    return int(rank), int(nproc)


def _shard_plan(filename, n_items, batch_size, rank, nproc):
    """``(shard filename, this rank's batch offsets)``: batches ``rank,
    rank + nproc, ...`` into ``<stem>.<rank>of<nproc><suffix>``."""
    import pathlib

    path = pathlib.Path(filename)
    shard = path.with_name(f"{path.stem}.{rank}of{nproc}{path.suffix}")
    mine = [b0 for i, b0 in enumerate(range(0, n_items, batch_size))
            if i % nproc == rank]
    return str(shard), mine


def _mesh_shard(mesh, rank, nproc):
    """``(rank, nproc, group)`` of a multi-process catalog: without a mesh
    :func:`_rank_and_count`'s and no group; with one, the rank's ``part``
    coordinate and the ``part`` size (unless given) and the ``ens`` group,
    whose ranks compute the shard's batches together."""
    if mesh is None:
        return _rank_and_count(rank, nproc) + (None,)
    if rank is None:
        rank = mesh.get_local_rank("part")
    if nproc is None:
        nproc = mesh.size(mesh.mesh_dim_names.index("part"))
    return _rank_and_count(rank, nproc) + (mesh.get_group("ens"),)


def ensemble_datagen_multihost(M200, conc, filename, n_particles_per_cluster,
                               batch_size=256, num_points=512, seed=0,
                               overwrite=False, resume=False, mesh=None,
                               anisotropy_radius=None, gravity="newtonian",
                               rank=None, nproc=None, device="cuda"):
    """Multi-process :func:`ensemble_datagen`: process ``rank`` of
    ``nproc`` computes batches ``rank, rank+nproc, ...`` and writes their
    cluster groups (global indices) to ``<stem>.<rank>of<nproc><suffix>``.

    Each batch's generator is seeded from ``(seed, b0)`` with the global
    offset, so the shard set is bit-identical to a one-process catalog,
    with no collectives.  ``rank``/``nproc`` default to
    ``torch.distributed``'s rank and world size when it is initialized,
    else 0 and 1.  Feed the shard list to :func:`read_catalog` or
    :func:`catalog_batches`.  ``resume=True`` resumes this shard alone.

    ``mesh``: the mesh's ``part`` dim splits the batches and its ``ens``
    dim each batch.  The ranks at ``part`` coordinate j form one ``ens``
    group that writes shard j (``rank``/``nproc`` default to the ``part``
    coordinate and size): each computes its ``ens`` rows of the shard's
    batches, as in :func:`ensemble_datagen` with a mesh, and the group's
    first rank writes the file.  Every rank of the world must call.
    Returns this process's shard filename."""
    rank, nproc, group = _mesh_shard(mesh, rank, nproc)
    n_cl = len(M200)
    shard, mine = _shard_plan(filename, n_cl, batch_size, rank, nproc)
    return ensemble_datagen(
        M200, conc, shard, n_particles_per_cluster, batch_size=batch_size,
        num_points=num_points, seed=seed, overwrite=overwrite, resume=resume,
        mesh=mesh, anisotropy_radius=anisotropy_radius, gravity=gravity,
        device=device, _only_batches=mine,
        _extra_attrs={"shard_rank": rank, "shard_count": nproc},
        _group=group)


def _catalog_filenames(filename):
    """The filename-or-shard-sequence argument as a list, taken ONCE (a
    one-shot iterable such as ``glob.iglob`` consumed twice would leave the
    second consumer nothing)."""
    import os

    if isinstance(filename, (str, os.PathLike)):
        return [str(filename)]
    return [str(fn) for fn in filename]


def _open_catalog(stack, filenames, prefix="cluster"):
    """Open a catalog's shard files and raw readers on ``stack`` and map
    each group to its shard (once per consumer call)."""
    import h5py

    from ..core.h5raw import RawReader

    files = [stack.enter_context(h5py.File(fn, "r")) for fn in filenames]
    readers = [stack.enter_context(RawReader(f)) for f in files]
    n_cl = int(files[0].attrs["n_clusters"])
    where = {name: j for j, f in enumerate(files) for name in f
             if name.startswith(prefix + "_")}
    return files, readers, n_cl, where


def _read_cluster(files, readers, where, i, fields, filenames,
                  prefix="cluster"):
    name = f"{prefix}_{int(i):06d}"
    j = where.get(name)
    if j is None:
        raise KeyError(
            f"{name} missing from {filenames}: incomplete catalog "
            "(interrupted run?); finish it with the datagen's resume=True")
    g = files[j][name]
    if fields is not None:
        missing = [k for k in fields if k not in g]
        if missing:
            raise KeyError(f"fields {missing} not in cluster group "
                           f"(has {sorted(g)})")
    out = {k: readers[j].read(g[k])
           for k in (g if fields is None else fields)}
    out.update(g.attrs)
    return out


def read_catalog(filename, indices=None, fields=None):
    """Iterate ``(index, cluster_dict)`` over an :func:`ensemble_datagen`
    catalog (host numpy).

    ``cluster_dict`` maps every dataset of the cluster's group to its array
    (read by pread at the dataset's offset, ``core/h5raw.RawReader``) plus
    the group attrs.  ``indices``: cluster indices (default all, in order);
    ``fields``: dataset names to read (default all; attrs always come;
    an unknown name raises).  ``filename`` may be a shard list of
    :func:`ensemble_datagen_multihost`: indices are global."""
    import contextlib

    filenames = _catalog_filenames(filename)
    with contextlib.ExitStack() as stack:
        files, readers, n_cl, where = _open_catalog(stack, filenames)
        if indices is None:
            indices = range(n_cl)
        if fields is not None:
            fields = list(fields)
        for i in indices:
            yield int(i), _read_cluster(files, readers, where, int(i),
                                        fields, filenames)


def catalog_batches(filename, batch_size, generator=None, drop_remainder=True,
                    prefetch=True, fields=None):
    """Iterate a catalog in stacked batches, the training-loop form: each
    yield is a dict of host numpy arrays, every dataset stacked on a leading
    batch axis (``dm_position`` -> ``(B, n_dm, 3)``) and every attr to
    ``(B,)``.

    ``generator``: a ``torch.Generator`` or an int seed; shuffles the
    cluster order with ``torch.randperm`` (``None``: catalog order).
    ``drop_remainder`` drops a final short batch.  ``prefetch`` reads batch
    k+1 on one worker thread while batch k is consumed.  ``fields`` and
    shard lists as in :func:`read_catalog`."""
    import contextlib

    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    filenames = _catalog_filenames(filename)
    with contextlib.ExitStack() as stack:
        files, readers, n_cl, where = _open_catalog(stack, filenames)
        fieldlist = None if fields is None else list(fields)
        order = np.arange(n_cl)
        if generator is not None:
            if not isinstance(generator, torch.Generator):
                generator = torch.Generator().manual_seed(int(generator))
            order = torch.randperm(n_cl, generator=generator,
                                   device=generator.device).cpu().numpy()
        limit = n_cl - (n_cl % batch_size) if drop_remainder else n_cl
        batches = [order[i:i + batch_size]
                   for i in range(0, limit, batch_size)]

        def _read(idx):
            clusters = [_read_cluster(files, readers, where, int(i),
                                      fieldlist, filenames) for i in idx]
            return {k: np.stack([cl[k] for cl in clusters])
                    for k in clusters[0]}

        if not prefetch:
            for b in batches:
                yield _read(b)
            return
        from concurrent.futures import ThreadPoolExecutor

        # one worker: h5py objects are used by one thread at a time
        with ThreadPoolExecutor(max_workers=1) as ex:
            fut = None
            for b in batches:
                nxt = ex.submit(_read, b)
                if fut is not None:
                    yield fut.result()
                fut = nxt
            if fut is not None:
                yield fut.result()


_SPECIES_MASS = {"dm": "dark_matter_mass", "star": "stellar_mass",
                 "gas": "gas_mass"}
# the rebuilt fields the physics QA reads
_QA_FIELDS = ("radius", "gravitational_potential", "pressure", "density",
              "dark_matter_mass", "stellar_mass", "gas_mass")


def _rebuild_fields(M200, conc, num_points, gravity, device):
    """The models of a batch of clusters, rebuilt at once on ``device``
    and brought to the host in one copy: ``{name: (B, num_points)}``
    float64 numpy for the fields of ``_QA_FIELDS``."""
    dev = resolve_device(device)
    f = build_one_cluster(f64_on(M200, dev), f64_on(conc, dev),
                          num_points=num_points, with_df=False,
                          gravity=gravity)
    return dict(zip(_QA_FIELDS, to_host([f[k] for k in _QA_FIELDS])))


def _new_report():
    return {"n_clusters_checked": 0, "n_particles_checked": 0,
            "max_speed_frac": 0.0, "max_energy_rel_err": 0.0,
            "max_radius_frac": 0.0, "min_radius_frac": np.inf,
            "max_mass_rel_err": 0.0, "violations": []}


def _check_cluster(i, cl, f, report, r_a=0.0, speed_tol=_QA["speed_tol"],
                   energy_rtol=_QA["cluster"]["energy_rtol"],
                   radius_tol=_QA["cluster"]["radius_tol"],
                   mass_rtol=_QA["cluster"]["mass_rtol"],
                   zero_row_tol=_QA["zero_row_tol"]):
    """The physics QA of one catalog cluster on the host: ``cl`` the
    cluster's dict (datasets and attrs, as :func:`read_catalog` yields it),
    ``f`` its rebuilt model (float64 numpy of ``_QA_FIELDS``).  Adds to
    ``report`` (see :func:`verify_catalog`)."""
    def _check(cond, msg):
        if not cond:
            report["violations"].append(msg)

    rr = f["radius"]
    psi = -f["gravitational_potential"]
    e_grid = 1.5 * f["pressure"] / f["density"]
    if "particle_position" in cl:  # DM-only product
        triples = [("dm", cl["particle_position"], cl["particle_velocity"],
                    cl["particle_mass"])]
        gas = None
    else:
        triples = [(sp, cl[f"{sp}_position"], cl[f"{sp}_velocity"],
                    cl[f"particle_mass_{sp}"])
                   for sp in ("dm", "star") if f"{sp}_position" in cl]
        gas = ((cl["gas_position"], cl["gas_thermal_energy"],
                cl["particle_mass_gas"]) if "gas_position" in cl else None)
    for sp, pos, vel, pmass in triples:
        _check(np.isfinite(pos).all() and np.isfinite(vel).all(),
               f"cluster {i} {sp}: non-finite values")
        r = np.sqrt((np.asarray(pos, np.float64) ** 2).sum(axis=1))
        zfrac = float((r == 0.0).mean())
        _check(zfrac <= zero_row_tol,
               f"cluster {i} {sp}: {zfrac:.2%} zero-radius rows "
               "(unwritten file extents?)")
        _check(np.count_nonzero(vel) > 0,
               f"cluster {i} {sp}: all-zero velocities "
               "(unwritten file extents?)")
        report["min_radius_frac"] = min(report["min_radius_frac"],
                                        float(r.min() / rr[-1]))
        rfrac = float(r.max() / rr[-1])
        report["max_radius_frac"] = max(report["max_radius_frac"], rfrac)
        _check(rfrac <= 1.0 + radius_tol,
               f"cluster {i} {sp}: radius {rfrac:.6f} of r_max")
        v = np.sqrt((np.asarray(vel, np.float64) ** 2).sum(axis=1))
        v_esc = np.sqrt(2.0 * np.interp(r, rr, psi))
        frac = float((v / v_esc).max())
        report["max_speed_frac"] = max(report["max_speed_frac"], frac)
        _check(frac <= 1.0 + speed_tol,
               f"cluster {i} {sp}: speed {frac:.6f} of local v_esc")
        if r_a > 0.0:
            # drawn beta in a shell outside r_a against beta_OM =
            # r^2 / (r^2 + r_a^2): isotropic draws in an OM catalog fail
            nh = np.asarray(pos, np.float64) / np.maximum(r, 1e-30)[:, None]
            v_r = (np.asarray(vel, np.float64) * nh).sum(axis=1)
            shell = (r >= 1.2 * r_a) & (r <= min(2.0 * r_a, rr[-1]))
            if shell.sum() >= 1000:
                v_t2 = v[shell] ** 2 - v_r[shell] ** 2
                beta = 1.0 - v_t2.mean() / (2.0 * (v_r[shell] ** 2).mean())
                rmid = float(r[shell].mean())
                b_om = rmid ** 2 / (rmid ** 2 + r_a ** 2)
                _check(abs(beta - b_om) < 0.15,
                       f"cluster {i} {sp}: anisotropy beta {beta:.3f} vs "
                       f"OM {b_om:.3f} at r~{rmid:.0f} (isotropic draws in "
                       "an OM catalog?)")
        m_tot = float(f[_SPECIES_MASS[sp]][-1])
        merr = abs(float(pmass) * len(r) - m_tot) / m_tot
        report["max_mass_rel_err"] = max(report["max_mass_rel_err"], merr)
        _check(merr <= mass_rtol,
               f"cluster {i} {sp}: mass budget off by {merr:.2e}")
        report["n_particles_checked"] += len(r)
    if gas is not None:
        pos, energy, pmass = gas
        _check(np.isfinite(pos).all() and np.isfinite(energy).all(),
               f"cluster {i} gas: non-finite values")
        r = np.sqrt((np.asarray(pos, np.float64) ** 2).sum(axis=1))
        zfrac = float((r == 0.0).mean())
        _check(zfrac <= zero_row_tol,
               f"cluster {i} gas: {zfrac:.2%} zero-radius rows "
               "(unwritten file extents?)")
        report["min_radius_frac"] = min(report["min_radius_frac"],
                                        float(r.min() / rr[-1]))
        e_ref = np.interp(r, rr, e_grid)
        rel = float((np.abs(np.asarray(energy, np.float64) - e_ref)
                     / e_ref).max())
        report["max_energy_rel_err"] = max(report["max_energy_rel_err"], rel)
        _check(rel <= energy_rtol,
               f"cluster {i} gas: thermal energy off by {rel:.3e}")
        _check((np.asarray(energy) > 0).all(),
               f"cluster {i} gas: non-positive thermal energy")
        m_tot = float(f["gas_mass"][-1])
        merr = abs(float(pmass) * len(r) - m_tot) / m_tot
        report["max_mass_rel_err"] = max(report["max_mass_rel_err"], merr)
        _check(merr <= mass_rtol,
               f"cluster {i} gas: mass budget off by {merr:.2e}")
        report["n_particles_checked"] += len(r)
    report["n_clusters_checked"] += 1


def _check_clusters(items, fields, report, **tol):
    """:func:`_check_cluster` for each ``(index, cluster dict)`` of one
    rebuilt batch (``fields`` as :func:`_rebuild_fields` returns them)."""
    for j, (i, cl) in enumerate(items):
        _check_cluster(i, cl, {k: v[j] for k, v in fields.items()}, report,
                       **tol)


def verify_catalog(filename, indices=None, strict=True,
                   speed_tol=_QA["speed_tol"],
                   energy_rtol=_QA["cluster"]["energy_rtol"],
                   radius_tol=_QA["cluster"]["radius_tol"],
                   mass_rtol=_QA["cluster"]["mass_rtol"],
                   zero_row_tol=_QA["zero_row_tol"], batch_size=256,
                   device="cuda"):
    """Physics QA gate of a datagen catalog: the models are REBUILT from
    the recorded ``(M200, conc, num_points, gravity)``, ``batch_size``
    clusters at once on ``device``, and the stored draws checked against
    them (tolerances: :mod:`~.qa`):

    * every dataset finite;
    * no zero-filled extents: at most ``zero_row_tol`` of a species' radii
      exactly zero, no all-zero collisionless velocity block;
    * radii inside the model grid (``radius_tol``);
    * collisionless speeds under the local escape speed sqrt(2 psi(r))
      (``speed_tol``); for an OM catalog (``r_a`` > 0) the anisotropy
      in a shell outside r_a;
    * gas thermal energies against 1.5 P / rho at the particle radius
      (``energy_rtol``), and positive;
    * ``n_part * pmass`` against the species' grid mass (``mass_rtol``).

    A merger-scene catalog goes to :func:`~.mergers.verify_merger_catalog`
    with the tolerances clamped to its floors.  Returns a report (worst
    values and ``violations``); ``strict`` raises ``ValueError`` on any
    violation.  ``filename`` may be a shard list."""
    import h5py

    filenames = _catalog_filenames(filename)
    with h5py.File(filenames[0], "r") as f:
        product = f.attrs.get("product")
        num_points = int(f.attrs["num_points"])
        n_cl = int(f.attrs["n_clusters"])
        r_a = float(f.attrs.get("r_a", 0.0))  # 0 = isotropic
        gravity = str(f.attrs.get("gravity", "newtonian"))
    if product == "merger_scenes":
        from .mergers import verify_merger_catalog

        mt = _QA["merger"]
        return verify_merger_catalog(
            filenames, indices=indices, speed_tol=speed_tol,
            energy_rtol=max(energy_rtol, mt["energy_rtol"]),
            mass_rtol=max(mass_rtol, mt["mass_rtol"]),
            radius_tol=max(radius_tol, mt["radius_tol"]),
            zero_row_tol=zero_row_tol, strict=strict,
            batch_size=batch_size, device=device)
    if indices is None:
        indices = range(n_cl)
    report = _new_report()
    tol = dict(r_a=r_a, speed_tol=speed_tol, energy_rtol=energy_rtol,
               radius_tol=radius_tol, mass_rtol=mass_rtol,
               zero_row_tol=zero_row_tol)
    items = []

    def flush():
        fields = _rebuild_fields([cl["M200"] for _, cl in items],
                                 [cl["conc"] for _, cl in items],
                                 num_points, gravity, device)
        _check_clusters(items, fields, report, **tol)
        items.clear()

    for i, cl in read_catalog(filenames, indices=list(indices)):
        items.append((i, cl))
        if len(items) == batch_size:
            flush()
    if items:
        flush()
    if strict and report["violations"]:
        raise ValueError("catalog failed physics QA:\n  "
                         + "\n  ".join(report["violations"][:20]))
    return report


def _cluster_particle_fields(cl):
    """A catalog cluster's dict as ``ClusterParticles`` fields (numpy):
    the full product's ``dm/gas/star`` datasets per type (gas with its
    thermal energy and zero velocities: the catalogs hold HSE clusters),
    the DM-only product as one ``dm`` type."""
    fields = {}
    if "particle_position" in cl:  # DM-only product
        n = cl["particle_position"].shape[0]
        fields["dm", "particle_position"] = cl["particle_position"]
        fields["dm", "particle_velocity"] = cl["particle_velocity"]
        fields["dm", "particle_mass"] = np.full(n, cl["particle_mass"],
                                                dtype=np.float32)
        return fields
    for sp in ("dm", "gas", "star"):
        pos = cl.get(f"{sp}_position")
        if pos is None:
            continue
        n = pos.shape[0]
        fields[sp, "particle_position"] = pos
        vel = cl.get(f"{sp}_velocity")
        fields[sp, "particle_velocity"] = (vel if vel is not None
                                           else np.zeros_like(pos))
        fields[sp, "particle_mass"] = np.full(
            n, cl[f"particle_mass_{sp}"], dtype=np.float32)
        if sp == "gas":
            fields[sp, "thermal_energy"] = cl["gas_thermal_energy"]
    return fields


def catalog_to_particles(filename, index, device="cuda"):
    """One catalog cluster as a :class:`~..particles.ClusterParticles` on
    ``device``: the bridge from the catalogs to the exporters.  Every form
    is handled (full-species, DM-only; merger-scene catalogs go to
    :func:`~.mergers.scene_to_particles`).  Positions are centred on the
    origin: place the cluster in a Gadget box first, e.g.
    ``p.add_offsets([box / 2] * 3, [0] * 3)``."""
    import h5py

    from ..particles import ClusterParticles

    filenames = _catalog_filenames(filename)
    with h5py.File(filenames[0], "r") as f:
        merger = f.attrs.get("product") == "merger_scenes"
    if merger:
        from .mergers import scene_to_particles

        return scene_to_particles(filenames, index, device=device)
    (_, cl), = read_catalog(filenames, indices=[index])
    return ClusterParticles.from_fields(_cluster_particle_fields(cl),
                                        device=device)
