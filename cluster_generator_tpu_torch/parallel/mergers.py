"""Merger-scene batches: many binary (or 1-3 halo) merger ICs at once,
training data for merger emulators.

One batch of B scenes with H halos each is one call of the program
:func:`_merger_batch_fn` returns.  The models, DFs, speed tables (kernel
K1, one launch per species for all B*H halos), and radius tables are built
for every halo of the batch at once; the draws of
:func:`~..pipeline.sample_merger_ic` run with a leading scene axis, and each
scene's gas mixes its own halos only.  The batch axis takes the place of
the JAX package's ``vmap``: each scene's result is what
:func:`~..pipeline.merger_ic_fused` gives for that scene with the same
uniforms.  The factory is memoized by configuration, and on the card each
batch size is one CUDA graph, captured at its first call and replayed
(:mod:`..core.compiled`); the mesh forms run the eager body.
:func:`merger_scene_batches` streams an ensemble batch by batch as tensors
on the device; :func:`verify_scene_batch` holds a batch to the physics QA
of the merger catalog.

The catalogs: :func:`merger_datagen` (and its multi-process form) streams
the scene batches to one HDF5 file on the loop of
:func:`~.ensemble.ensemble_datagen`; its device stage
(:func:`_scene_batches`) and layout (:func:`_scene_records`) need no
``h5py``.  :func:`read_merger_catalog`, :func:`verify_merger_catalog` (the
per-scene checks are :func:`_check_scene`) and :func:`scene_to_particles`
read them back.
"""

from __future__ import annotations

import functools
import hashlib

import numpy as np
import torch

from ..core import compiled
from ..core.device import f64_on, resolve_device
from ..core.draws import uniform
from ..core.interp import interp
from ..core.profiling import device_stage, span
from ..core.staging import stream_to_host
from ..model.gravity import get_gravity
from ..pipeline import (build_merger_models, build_radius_tables,
                        build_speed_tables, merger_uniforms, sample_merger_ic)
from .ensemble import (_PORT_DRAWS, _SPECIES_MASS, _batch_generator,
                       _catalog_filenames, _check_r_a,
                       _gathered, _mesh_call, _mesh_ens, _mesh_shard,
                       _open_catalog, _read_cluster, _rebuild_fields,
                       _shard_plan, _stream_batched_catalog,
                       build_one_cluster)
from .mesh import mesh_device
from .qa import QA_TOLERANCES as _QA

__all__ = ["sample_merger_scene_params", "binary_scene_geometry",
           "triple_scene_geometry", "sample_triple_scene_params",
           "halo_mass_weights", "merger_scene_batches", "verify_scene_batch",
           "merger_datagen", "merger_datagen_multihost", "read_merger_catalog",
           "verify_merger_catalog", "scene_to_particles"]

# Bump whenever the MEANING of the merger draws changes for a fixed
# configuration.  1 = the pipeline.sample_merger_ic draw scheme (paired
# radius/speed lerps, Bernoulli joint-row pick, at-radius gas mixing);
# 2 = star speed tables at the coarse resolutions (64 rows, n_s and n_q
# capped at 256).
_MERGER_DRAWS_VERSION = 2


def _draws(generator, n, k, device, given=None):
    """``k`` float64 uniform vectors of length ``n`` in [0, 1): ``given``
    or drawn from ``generator`` in order."""
    if given is not None:
        return [f64_on(u, device) for u in given]
    return [uniform(generator, n, torch.float64, device) for _ in range(k)]


def _scale(u, lo_hi):
    lo, hi = lo_hi
    return u * (hi - lo) + lo


def _concentrations(M200, conc_range, generator, device, normals):
    """c(M) with log-normal scatter, the stand-in relation of the ensemble
    product."""
    if normals is None:
        normals = torch.randn(M200.shape, generator=generator,
                              dtype=torch.float64, device=device)
    c_mean = 5.0 * (M200 / 1.0e15) ** (-0.1)
    return torch.clamp(c_mean * torch.exp(f64_on(normals, device) * 0.3),
                       *conc_range)


def sample_merger_scene_params(generator, n, logM_range=(14.2, 15.3),
                               mass_ratio_range=(0.2, 1.0),
                               conc_range=(3.0, 8.0),
                               d_range=(2000.0, 4000.0),
                               b_frac_range=(0.0, 0.5),
                               v_rel_range=(0.5, 1.5), device="cuda",
                               uniforms=None, normals=None):
    """Draw ``n`` binary-merger scene parameters, float64 on ``device``.

    Primary mass log-uniform in ``logM_range``; secondary by a uniform mass
    ratio; concentrations from c(M) with log-normal scatter; separation
    ``d`` (kpc) uniform; impact parameter ``b = frac * d``; relative speed
    ``v_rel`` (kpc/Myr) uniform.  ``generator``: a ``torch.Generator`` on
    ``device`` (None: one seeded with 0).  ``uniforms`` (optional): five
    [0, 1) vectors for logM, ratio, d, b_frac and v_rel; ``normals`` the
    (n, 2) standard normals of the scatter.

    Returns ``{"M200": (n, 2), "conc": (n, 2), "d": (n,), "b": (n,),
    "v_rel": (n,)}``: feed to :func:`binary_scene_geometry`.
    """
    dev = resolve_device(device)
    if generator is None and uniforms is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if uniforms is None:
        # the JAX package's order of draws: logM, ratio, scatter, d, b, v
        u_logm, u_ratio = _draws(generator, n, 2, dev)
        if normals is None:
            normals = torch.randn((n, 2), generator=generator,
                                  dtype=torch.float64, device=dev)
        u_d, u_b, u_v = _draws(generator, n, 3, dev)
    else:
        u_logm, u_ratio, u_d, u_b, u_v = _draws(None, n, 5, dev, uniforms)
    M1 = 10.0 ** _scale(u_logm, logM_range)
    M200 = torch.stack([M1, _scale(u_ratio, mass_ratio_range) * M1], dim=1)
    conc = _concentrations(M200, conc_range, generator, dev, normals)
    d = _scale(u_d, d_range)
    return {"M200": M200, "conc": conc, "d": d,
            "b": d * _scale(u_b, b_frac_range),
            "v_rel": _scale(u_v, v_rel_range)}


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().astype(np.float64)
    return np.asarray(x, np.float64)


def binary_scene_geometry(M200, d, b, v_rel, center=(0.0, 0.0, 0.0)):
    """Binary scene geometry on the host: centres separated by ``d`` with
    impact parameter ``b`` (the along-axis part is sqrt(d^2 - b^2)),
    approach velocities along +-x with relative speed ``v_rel`` split by
    M200 so that the scene is in its zero-momentum frame.

    Returns ``(centers (n, 2, 3), velocities (n, 2, 3))`` float64 numpy.
    """
    M200 = _host(M200).reshape(-1, 2)
    d, b, v_rel = _host(d), _host(b), _host(v_rel)
    if np.any(b > d):
        raise ValueError("impact parameter b exceeds separation d")
    n = M200.shape[0]
    dx = np.sqrt(d * d - b * b)
    diff = np.stack([dx, b, np.zeros_like(d)], axis=1)        # (n, 3)
    center = np.asarray(center, np.float64)
    centers = np.stack([center - 0.5 * diff, center + 0.5 * diff], axis=1)
    # zero total momentum: m1 v1 + m2 v2 = 0 with v1 - v2 = v_rel x_hat
    w1 = M200[:, 1] / M200.sum(axis=1)                        # m2 / (m1+m2)
    vel = np.zeros((n, 2, 3))
    vel[:, 0, 0] = +v_rel * w1
    vel[:, 1, 0] = -v_rel * (1.0 - w1)
    return centers, vel


def triple_scene_geometry(M200, d12, b12, v12, d3, b3, v3,
                          center=(0.0, 0.0, 0.0)):
    """Three-halo scene geometry on the host: halos 1 and 2 as
    :func:`binary_scene_geometry`; halo 3 at distance ``d3`` from the
    pair's centre of mass along +y with impact parameter ``b3`` along z,
    falling in with speed ``v3``; the scene then shifted to its
    zero-momentum frame.

    Returns ``(centers (n, 3, 3), velocities (n, 3, 3))`` float64 numpy.
    """
    M200 = _host(M200).reshape(-1, 3)
    c12, v12v = binary_scene_geometry(M200[:, :2], d12, b12, v12)
    d3, b3, v3 = _host(d3), _host(b3), _host(v3)
    if np.any(b3 > d3):
        raise ValueError("impact parameter b3 exceeds separation d3")
    n = M200.shape[0]
    w = M200[:, :2] / M200[:, :2].sum(axis=1, keepdims=True)  # (n, 2)
    com12 = (w[:, :, None] * c12).sum(axis=1)                 # (n, 3)
    dy = np.sqrt(d3 * d3 - b3 * b3)
    c3 = com12 + np.stack([np.zeros_like(d3), dy, b3], axis=1)
    vel3 = np.zeros((n, 3))
    vel3[:, 1] = -v3                                          # infall (-y)
    centers = np.concatenate([c12, c3[:, None, :]], axis=1)   # (n, 3, 3)
    vel = np.concatenate([v12v, vel3[:, None, :]], axis=1)
    wall = M200 / M200.sum(axis=1, keepdims=True)             # (n, 3)
    vel = vel - (wall[:, :, None] * vel).sum(axis=1, keepdims=True)
    return centers + np.asarray(center, np.float64), vel


def sample_triple_scene_params(generator, n, logM_range=(14.2, 15.3),
                               mass_ratio_range=(0.2, 1.0),
                               conc_range=(3.0, 8.0),
                               d_range=(2000.0, 4000.0),
                               b_frac_range=(0.0, 0.5),
                               v_rel_range=(0.5, 1.5),
                               d3_range=(3000.0, 5000.0),
                               v3_range=(0.3, 1.0), device="cuda",
                               uniforms=None, normals=None):
    """Draw ``n`` three-halo scene parameters, float64 on ``device``:
    primary mass log-uniform, halos 2 and 3 by independent uniform mass
    ratios, c(M) with scatter, the binary geometry from the ``d``, ``b``
    and ``v_rel`` ranges and the third halo's infall from the ``d3``,
    ``b_frac`` and ``v3`` ranges.  ``uniforms`` (optional): nine [0, 1)
    vectors (logM, ratio 2, ratio 3, d12, b12 frac, v12, d3, b3 frac, v3);
    ``normals`` the (n, 3) scatter.  Returns ``M200``, ``conc``,
    ``centers`` and ``velocities`` ((n, 3, 3)) as tensors on ``device``.
    """
    dev = resolve_device(device)
    if generator is None and uniforms is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if uniforms is None:
        u = _draws(generator, n, 3, dev)
        if normals is None:
            normals = torch.randn((n, 3), generator=generator,
                                  dtype=torch.float64, device=dev)
        u += _draws(generator, n, 6, dev)
    else:
        u = _draws(None, n, 9, dev, uniforms)
    M1 = 10.0 ** _scale(u[0], logM_range)
    M200 = torch.stack([M1, _scale(u[1], mass_ratio_range) * M1,
                        _scale(u[2], mass_ratio_range) * M1], dim=1)
    conc = _concentrations(M200, conc_range, generator, dev, normals)
    d12 = _scale(u[3], d_range)
    d3 = _scale(u[6], d3_range)
    centers, velocities = triple_scene_geometry(
        M200, d12, d12 * _scale(u[4], b_frac_range), _scale(u[5], v_rel_range),
        d3, d3 * _scale(u[7], b_frac_range), _scale(u[8], v3_range))
    return {"M200": M200, "conc": conc, "centers": f64_on(centers, dev),
            "velocities": f64_on(velocities, dev)}


def _split_by_weights(total, weights):
    """Split ``total`` into per-halo ints proportional to ``weights``
    (largest-remainder rounding, so the parts sum exactly)."""
    w = np.asarray(weights, np.float64)
    exact = total * w / w.sum()
    parts = np.floor(exact).astype(int)
    rem = int(total - parts.sum())
    order = np.argsort(-(exact - parts))
    parts[order[:rem]] += 1
    return tuple(int(x) for x in parts)


def halo_mass_weights(M200):
    """Ensemble-mean per-halo mass fractions of ``M200 (n_scenes, H)``:
    one count layout for every scene of a batched product, split by the
    mean fraction."""
    M200 = _host(M200)
    M200 = M200.reshape(-1, M200.shape[-1])
    frac = M200 / M200.sum(axis=1, keepdims=True)
    return frac.mean(axis=0)


def _normalize_counts(counts, H, weights=None):
    """Per-species per-halo counts.  A value may be an int, split across
    halos by ``weights`` (even when None), or a length-H tuple.  Unknown
    species raise (a typo would silently drop the species)."""
    unknown = set(counts) - {"dm", "gas", "star"}
    if unknown:
        raise ValueError(f"unknown species {sorted(unknown)} in counts; "
                         "expected keys from {'dm', 'gas', 'star'}")
    out = {}
    for sp in ("gas", "dm", "star"):
        c = counts.get(sp, 0)
        if isinstance(c, (int, np.integer)):
            out[sp] = _split_by_weights(
                int(c), np.ones(H) if weights is None else weights)
        else:
            c = tuple(int(x) for x in c)
            if len(c) != H:
                raise ValueError(f"counts[{sp!r}] has {len(c)} entries "
                                 f"for {H} halos")
            out[sp] = c
    if not any(sum(v) for v in out.values()):
        raise ValueError("all species counts are zero")
    return out


def _segment_offsets(ns):
    """Start offset of each halo's segment in the concatenated per-species
    arrays (``None`` for a halo with no particles)."""
    offs, tot = [], 0
    for n in ns:
        offs.append(tot if n > 0 else None)
        tot += n
    return offs


class _SceneBatch:
    """One scene batch of fused merger ICs: ``(M200 (B, H), conc (B, H),
    centers (B, H, 3), velocities (B, H, 3), r_max (H,), generator,
    uniforms=None)`` -> a dict of (B, ...) tensors,

        gas_position / gas_velocity (B, n_gas, 3), gas_thermal_energy /
        gas_density (B, n_gas), dm_position / dm_velocity,
        star_position / star_velocity (B, n, 3) float32, and
        mass_<species> (B, H): each halo's particle mass

    (a species with no particles is absent).  ``uniforms`` as in
    :func:`~..pipeline.sample_merger_ic`, each (B, n).  The stages are
    methods so that each can be timed alone; :meth:`run` runs them all
    eagerly.  Calling the object runs the batch as the memoized program of
    this configuration and the batch's size (:mod:`..core.compiled`: a
    CUDA graph on the card, :meth:`run` on the CPU), its uniforms drawn
    from the generator before the graph replays."""

    def __init__(self, num_points, n_gas, n_dm, n_star, r_a=None,
                 gravity="newtonian", device="cuda"):
        _check_r_a(r_a)
        get_gravity(gravity)  # unknown law names fail before any work
        self.num_points = int(num_points)
        self.counts = {"gas": tuple(n_gas), "dm": tuple(n_dm),
                       "star": tuple(n_star)}
        self.r_a = None if r_a is None else float(r_a)
        self.gravity = str(gravity)
        self.device = resolve_device(device)
        self.seg = {sp: _segment_offsets(ns) for sp, ns in self.counts.items()}
        # every argument the program bakes in: its key (the configuration
        # joins it in compiled.program)
        self.key = ("scene_batch", self.num_points, self.counts["gas"],
                    self.counts["dm"], self.counts["star"], self.r_a,
                    self.gravity)

    def models(self, M200, conc):
        """Fields and DFs of all B*H halos, flattened to (B*H, ...)."""
        return build_merger_models(M200.reshape(-1), conc.reshape(-1),
                                   num_points=self.num_points, r_a=self.r_a,
                                   gravity=self.gravity, device=self.device)

    def tables(self, fields, r_max):
        """Speed tables (one K1 launch per species) and radius tables of
        all B*H halos."""
        tables = build_speed_tables(fields)
        H = r_max.shape[0]
        tables["radius"] = build_radius_tables(
            fields, r_max.repeat(fields["radius"].shape[0] // H))
        return tables

    def draws(self, fields, tables, M200, centers, velocities, r_max,
              generator=None, uniforms=None):
        """Every scene's particles: the halo axis restored, then
        :func:`~..pipeline.sample_merger_ic` with the scene axis first."""
        B, H = M200.shape

        def unflat(t):
            return t.reshape((B, H) + t.shape[1:])

        fields = {k: unflat(v) for k, v in fields.items()}
        rtab = {k: unflat(v) for k, v in tables["radius"].items()}
        tabs = {k: unflat(v) for k, v in tables.items() if k != "radius"}
        tabs["radius"] = rtab
        parts = sample_merger_ic(fields, tabs, centers, velocities, r_max,
                                 self.counts["gas"], self.counts["dm"],
                                 self.counts["star"], r_a=self.r_a,
                                 generator=generator, uniforms=uniforms)
        out = {}
        for sp in ("gas", "dm", "star"):
            if not sum(self.counts[sp]):
                continue
            out[f"{sp}_position"] = parts[sp, "particle_position"]
            out[f"{sp}_velocity"] = parts[sp, "particle_velocity"]
            if sp == "gas":
                out["gas_thermal_energy"] = parts["gas", "thermal_energy"]
                out["gas_density"] = parts["gas", "density"]
            pm = parts[sp, "particle_mass"]
            zero = torch.zeros_like(pm[..., 0])
            out[f"mass_{sp}"] = torch.stack(
                [pm[..., o] if o is not None else zero
                 for o in self.seg[sp]], dim=-1)
        return out

    def uniforms(self, B, generator, device, out=None):
        """Every uniform a batch of ``B`` scenes takes from ``generator``,
        in the draws' order (:func:`~..pipeline.merger_uniforms`; ``out``
        filled in place)."""
        return merger_uniforms(generator, (B,), self.counts["gas"],
                               self.counts["dm"], self.counts["star"],
                               device=device, out=out)

    def _inputs(self, M200, conc, centers, velocities, r_max):
        dev = self.device
        return (f64_on(M200, dev), f64_on(conc, dev), f64_on(centers, dev),
                f64_on(velocities, dev), f64_on(r_max, dev).reshape(-1))

    def run(self, M200, conc, centers, velocities, r_max, generator=None,
            uniforms=None):
        """The batch, eagerly: the program's body.  Its stage marks
        (:func:`~..core.profiling.device_stage`) are the merger's, in
        order: models, dfs, models, dfs, models (a DF per species), end;
        tables, end; draws (the gas mixing and the output assembly
        included), end."""
        M200, conc, centers, velocities, r_max = self._inputs(
            M200, conc, centers, velocities, r_max)
        if generator is None and uniforms is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        with compiled.inline():   # the stages run inline, as in the program
            with device_stage("models", M200):
                fields = self.models(M200, conc)
            with device_stage("tables", M200):
                tables = self.tables(fields, r_max)
            with device_stage("draws", M200):
                return self.draws(fields, tables, M200, centers, velocities,
                                  r_max, generator, uniforms)

    def _body(self, M200, conc, centers, velocities, r_max, uniforms):
        return self.run(M200, conc, centers, velocities, r_max, None,
                        uniforms)

    def __call__(self, M200, conc, centers, velocities, r_max,
                 generator=None, uniforms=None):
        inputs = self._inputs(M200, conc, centers, velocities, r_max)
        B = int(inputs[0].shape[0])
        draw = compiled.drawer(uniforms, generator, self.device,
                               lambda gen, out: self.uniforms(
                                   B, gen, self.device, out=out))
        return compiled.run(self.key, self._body, inputs, draw)


def _merger_batch_fn(num_points, n_gas, n_dm, n_star, r_a=None,
                     gravity="newtonian", device="cuda"):
    """The scene-batch program for one configuration (see
    :class:`_SceneBatch`); ``n_*`` are per-halo counts.  Memoized on every
    value it bakes in, the ``cgparams['numerical']`` table knobs and the
    ``cgparams['gravity']`` constants included (the JAX package's factory
    holds the knobs)."""
    _check_r_a(r_a)
    return _merger_batch_cached(
        int(num_points), tuple(map(int, n_gas)), tuple(map(int, n_dm)),
        tuple(map(int, n_star)), None if r_a is None else float(r_a),
        str(gravity), resolve_device(device), compiled.config_key())


@functools.lru_cache(maxsize=16)
def _merger_batch_cached(num_points, n_gas, n_dm, n_star, r_a, gravity,
                         device, config):
    del config  # in the memo key only: the body reads it
    return _SceneBatch(num_points, n_gas, n_dm, n_star, r_a=r_a,
                       gravity=gravity, device=device)


def _scene_inputs(params, device):
    """``(M200, conc, centers, velocities)`` float64 tensors on ``device``
    from a params dict with explicit ``centers``/``velocities`` or the
    binary geometry inputs ``d``, ``b``, ``v_rel``."""
    M200 = f64_on(params["M200"], device)
    conc = f64_on(params["conc"], device)
    if M200.ndim != 2 or M200.shape != conc.shape:
        raise ValueError("params['M200'] and params['conc'] must both be "
                         f"(n_scenes, n_halos); got {tuple(M200.shape)} and "
                         f"{tuple(conc.shape)}")
    n_sc, H = M200.shape
    if "centers" in params:
        centers, velocities = params["centers"], params["velocities"]
    else:
        if H != 2:
            raise ValueError("d/b/v_rel geometry is binary-only; pass "
                             "explicit centers/velocities for H != 2 "
                             "(triple_scene_geometry builds 3-halo scenes)")
        centers, velocities = binary_scene_geometry(
            M200, params["d"], params["b"], params["v_rel"])
    centers, velocities = f64_on(centers, device), f64_on(velocities, device)
    if (tuple(centers.shape) != (n_sc, H, 3)
            or tuple(velocities.shape) != (n_sc, H, 3)):
        raise ValueError("centers/velocities must be (n_scenes, n_halos, "
                         f"3); got {tuple(centers.shape)} / "
                         f"{tuple(velocities.shape)}")
    return M200, conc, centers, velocities


def merger_scene_batches(params, counts, batch_size=64, num_points=512,
                         r_max=5000.0, seed=0, anisotropy_radius=None,
                         gravity="newtonian", prorate=True, device="cuda"):
    """Yield ``(b0, batch_out)``: an ensemble of merger scenes, batch by
    batch, as tensors on ``device`` (``batch_out`` as :class:`_SceneBatch`
    returns it).  Batch k+1 is enqueued before batch k is yielded.

    ``params``: ``M200`` and ``conc`` (n_scenes, H) and either
    ``centers``/``velocities`` (n_scenes, H, 3) or the binary geometry
    inputs ``d``/``b``/``v_rel`` (the output of
    :func:`sample_merger_scene_params` works as it is).  ``counts``:
    ``{"gas": n, "dm": n, "star": n}``, each an int (split across halos by
    the ensemble-mean mass fraction, or evenly with ``prorate=False``) or a
    per-halo tuple.  ``r_max``: sampling radius (kpc), scalar or per halo.
    ``seed``: an int (each batch's generator is seeded from (seed, b0)) or
    a callable ``b0 -> torch.Generator``.
    """
    dev = resolve_device(device)
    M200, conc, centers, velocities = _scene_inputs(params, dev)
    H = M200.shape[1]
    counts = _normalize_counts(
        counts, H, weights=halo_mass_weights(M200) if prorate else None)
    r_max = f64_on(r_max, dev).reshape(-1).expand(H).contiguous()
    batch_fn = _merger_batch_fn(num_points, counts["gas"], counts["dm"],
                                counts["star"], r_a=anisotropy_radius,
                                gravity=gravity, device=dev)
    make_gen = seed if callable(seed) else (
        lambda b0: _batch_generator(seed, b0, dev))
    pending = None
    for b0 in range(0, int(M200.shape[0]), batch_size):
        with span("cg.host.inputs"):
            sl = slice(b0, b0 + batch_size)
            rows_in = (M200[sl], conc[sl], centers[sl], velocities[sl])
            gen = make_gen(b0)
        nxt = (b0, batch_fn(*rows_in, r_max, gen))
        if pending is not None:
            yield pending
        pending = nxt
    if pending is not None:
        yield pending


def _loglerp(r, rr, vals):
    """The draws' lerp on the log-spaced grid (log-space weights, clamped
    at both ends), batched over the leading axes."""
    return interp(torch.log(torch.maximum(r, rr[..., :1])), torch.log(rr),
                  vals)


def verify_scene_batch(out, M200, conc, centers, velocities, r_max, counts,
                       num_points=512, r_a=None, gravity="newtonian",
                       speed_tol=_QA["speed_tol"],
                       energy_rtol=_QA["merger"]["energy_rtol"],
                       mass_rtol=_QA["merger"]["mass_rtol"],
                       radius_tol=_QA["merger"]["radius_tol"],
                       zero_row_tol=_QA["zero_row_tol"], strict=True):
    """Physics QA of one scene batch, as tensors on its device: the checks
    of the JAX package's merger-catalog verifier, against every halo's
    model rebuilt from its (M200, c) in float64.

    * every value finite; no zero-radius rows past ``zero_row_tol`` and no
      all-zero velocity block per halo;
    * each halo's particles within its ``r_max`` of ITS centre
      (``radius_tol``);
    * collisionless peculiar speeds (velocity less the halo's bulk
      velocity) below the halo's local escape speed (``speed_tol``); for
      ``r_a`` the anisotropy in a shell outside r_a;
    * gas thermal energy, density and velocity against the
      density-weighted mix of all halos, recomputed from the rebuilt
      fields (``energy_rtol``);
    * each halo's particle mass against the species' grid mass at r_max
      (``mass_rtol``);
    * zero total momentum: the M200-weighted sum of each halo's mean
      drawn velocity vanishes within 5 standard errors of the draw.

    ``counts``: per-species per-halo tuples.  Returns a report with the
    worst value of each check, the non-finite counts and the violations;
    ``strict`` raises ``ValueError`` on any violation.
    """
    dev = out[next(iter(out))].device
    M200, conc = f64_on(M200, dev), f64_on(conc, dev)
    centers, velocities = f64_on(centers, dev), f64_on(velocities, dev)
    B, H = M200.shape
    r_max = f64_on(r_max, dev).reshape(-1).expand(H)
    f = build_one_cluster(M200.reshape(-1), conc.reshape(-1),
                          num_points=num_points, with_df=False,
                          gravity=gravity)
    f = {k: v.reshape(B, H, -1) for k, v in f.items()}
    rr = f["radius"]
    psi = -f["gravitational_potential"]
    rho = f["density"]
    e_grid = 1.5 * f["pressure"] / rho
    report = {"nonfinite": {}, "max_speed_frac": 0.0,
              "max_energy_rel_err": 0.0, "max_density_rel_err": 0.0,
              "max_velocity_err": 0.0, "max_radius_frac": 0.0,
              "max_mass_rel_err": 0.0, "max_zero_row_frac": 0.0,
              "max_momentum_sigmas": 0.0, "violations": []}

    def _check(cond, msg):
        if not cond:
            report["violations"].append(msg)

    def worst(key, value):
        report[key] = max(report[key], value)
        return value

    for name, a in out.items():
        report["nonfinite"][name] = int((~torch.isfinite(a)).sum())
        _check(report["nonfinite"][name] == 0,
               f"{name}: {report['nonfinite'][name]} non-finite values")

    for sp in ("dm", "star", "gas"):
        if f"{sp}_position" not in out:
            continue
        pos = out[f"{sp}_position"].double()
        vel = out[f"{sp}_velocity"].double()
        pmass = out[f"mass_{sp}"].double()
        momentum = torch.zeros((B, 3), dtype=torch.float64, device=dev)
        var = torch.zeros((B, 3), dtype=torch.float64, device=dev)
        o = 0
        for h, n_h in enumerate(counts[sp]):
            if n_h == 0:
                continue
            seg = slice(o, o + n_h)
            o += n_h
            d = pos[:, seg] - centers[:, h, None, :]
            r = d.norm(dim=-1)                                   # (B, n_h)
            zfrac = worst("max_zero_row_frac",
                          float((r == 0.0).double().mean(dim=1).max()))
            _check(zfrac <= zero_row_tol,
                   f"{sp} halo {h}: {zfrac:.2%} zero-radius rows")
            rfrac = worst("max_radius_frac", float((r.max(dim=1).values
                                                    / r_max[h]).max()))
            _check(rfrac <= 1.0 + radius_tol,
                   f"{sp} halo {h}: radius {rfrac:.7f} of r_max")
            m_tot = interp(r_max[h].expand(B, 1), rr[:, h],
                           f[_SPECIES_MASS[sp]][:, h])
            merr = worst("max_mass_rel_err", float(
                ((pmass[:, h] * n_h - m_tot[:, 0]).abs() / m_tot[:, 0]).max()))
            _check(merr <= mass_rtol,
                   f"{sp} halo {h}: mass budget off by {merr:.2e}")
            if sp == "gas":
                continue
            _check(bool((vel[:, seg] != 0).any(dim=-1).any(dim=-1).all()),
                   f"{sp} halo {h}: an all-zero velocity block")
            pec = vel[:, seg] - velocities[:, h, None, :]
            v = pec.norm(dim=-1)
            v_esc = torch.sqrt(2.0 * interp(r, rr[:, h], psi[:, h]))
            frac = worst("max_speed_frac", float((v / v_esc).max()))
            _check(frac <= 1.0 + speed_tol,
                   f"{sp} halo {h}: peculiar speed {frac:.6f} of local v_esc")
            if r_a is not None:
                v_r = (pec * d).sum(dim=-1) / r.clamp_min(1e-30)
                shell = (r >= 1.2 * r_a) & (r <= min(2.0 * r_a,
                                                     float(r_max[h])))
                n_sh = int(shell.sum())
                if n_sh >= 1000:
                    beta = 1.0 - float((v[shell] ** 2 - v_r[shell] ** 2)
                                       .mean()) / (
                        2.0 * float((v_r[shell] ** 2).mean()))
                    rmid = float(r[shell].mean())
                    b_om = rmid ** 2 / (rmid ** 2 + r_a ** 2)
                    _check(abs(beta - b_om) < 0.15,
                           f"{sp} halo {h}: anisotropy beta {beta:.3f} vs "
                           f"OM {b_om:.3f} at r~{rmid:.0f}")
            momentum += M200[:, h, None] * vel[:, seg].mean(dim=1)
            var += M200[:, h, None] ** 2 * vel[:, seg].var(dim=1) / n_h
        if sp != "gas":
            sig = float((momentum.abs() / var.sqrt()).max())
            worst("max_momentum_sigmas", sig)
            _check(sig <= 5.0, f"{sp}: total momentum {sig:.2f} standard "
                   "errors from zero")
            continue
        u = out["gas_thermal_energy"].double()
        dens = out["gas_density"].double()
        _check(bool((u > 0).all()) and bool((dens > 0).all()),
               "gas: non-positive energy or density")
        d_exp = de_exp = dv_exp = 0.0
        for h in range(H):
            r_h = (pos - centers[:, h, None, :]).norm(dim=-1)
            d_h = _loglerp(r_h, rr[:, h], rho[:, h])
            d_exp = d_exp + d_h
            de_exp = de_exp + _loglerp(r_h, rr[:, h], rho[:, h] * e_grid[:, h])
            dv_exp = dv_exp + d_h[..., None] * velocities[:, h, None, :]
        u_exp = de_exp / d_exp
        rel = worst("max_energy_rel_err",
                    float(((u - u_exp).abs() / u_exp).max()))
        _check(rel <= energy_rtol, f"gas: mixed thermal energy off by "
               f"{rel:.3e}")
        drel = worst("max_density_rel_err",
                     float(((dens - d_exp).abs() / d_exp).max()))
        _check(drel <= energy_rtol, f"gas: mixed density off by {drel:.3e}")
        v_scale = velocities.abs().amax(dim=(1, 2)).clamp_min(1e-3)
        verr = worst("max_velocity_err", float(
            ((vel - dv_exp / d_exp[..., None]).abs().amax(dim=(1, 2))
             / v_scale).max()))
        _check(verr <= energy_rtol, f"gas: mixed velocity off by {verr:.3e} "
               "of the bulk-speed scale")
    if strict and report["violations"]:
        raise ValueError("merger scene batch failed physics QA:\n  "
                         + "\n  ".join(report["violations"][:20]))
    return report


# ------------------------------------------------------------------ catalogs
def _params_sha(M200, conc, centers, velocities):
    """Identity of the scene-parameter arrays for the resume config: a
    resume against another ensemble must raise, not splice."""
    h = hashlib.sha256()
    for a in (M200, conc, centers, velocities):
        h.update(np.ascontiguousarray(_host(a)).tobytes())
    return h.hexdigest()


def _scene_batches(batch_fn, M200, conc, centers, velocities, r_max,
                   batch_size, seed, b0s, mesh=None, stage=True):
    """The device stage of :func:`merger_datagen`: for each batch offset
    in ``b0s`` the scene-batch program with the generator of ``(seed,
    b0)``, its outputs staged to pinned host memory while the next batch
    computes.  Yields ``(b0, host)``, ``host`` a dict of numpy arrays with
    the program's keys; valid until the next batch is asked for.
    ``mesh`` and ``stage`` as in :func:`~.ensemble._catalog_batches`."""
    dev = M200.device

    def programs():
        for b0 in b0s:
            sl = slice(b0, b0 + batch_size)
            out, rows = _mesh_call(
                batch_fn, mesh, (M200[sl], conc[sl], centers[sl],
                                 velocities[sl]), (r_max,),
                _batch_generator(seed, b0, dev))
            out = _gathered(mesh, out, rows)
            yield (b0, list(out)), list(out.values())

    if not stage:
        for (b0, _), _ in programs():
            yield b0, None
        return
    for (b0, names), arrays in stream_to_host(programs()):
        yield b0, dict(zip(names, arrays))


def _scene_records(b0, Mb, cb, ctr, vel, out):
    """One scene batch in the catalog's layout: per scene ``(group name,
    attrs, [(dataset name, array), ...])``; ``Mb``, ``cb``, ``ctr``,
    ``vel`` host float64 of the batch, ``out`` a host batch of
    :func:`_scene_batches`."""
    for i in range(Mb.shape[0]):
        attrs = {"M200": Mb[i], "conc": cb[i], "center": ctr[i],
                 "bulk_velocity": vel[i]}
        for sp in ("gas", "dm", "star"):
            if f"mass_{sp}" in out:
                attrs[f"particle_mass_{sp}"] = out[f"mass_{sp}"][i]
        data = [(name, arr[i]) for name, arr in out.items()
                if not name.startswith("mass_")]
        yield f"scene_{b0 + i:06d}", attrs, data


def merger_datagen(params, filename, counts, batch_size=64, num_points=512,
                   r_max=5000.0, seed=0, overwrite=False, resume=False,
                   mesh=None, anisotropy_radius=None, gravity="newtonian",
                   prorate=True, device="cuda", _only_batches=None,
                   _extra_attrs=None, _group=None):
    """Stream an ensemble of merger-scene ICs to ONE HDF5 catalog.

    ``params``: ``M200``/``conc`` (n_scenes, H) and either explicit
    ``centers``/``velocities`` (n_scenes, H, 3) or the binary geometry
    inputs ``d``/``b``/``v_rel`` (:func:`binary_scene_geometry`); the
    output of :func:`sample_merger_scene_params` works as it is.
    ``counts``: ``{"gas": n, "dm": n, "star": n}``, each an int (split
    across halos by the ensemble-mean mass fraction, or evenly with
    ``prorate=False``) or a per-halo tuple.  ``r_max``: sampling radius
    (kpc), scalar or per halo.

    Group ``scene_%06d`` holds ``gas_position / gas_velocity /
    gas_thermal_energy / gas_density``, ``dm_position / dm_velocity``,
    ``star_position / star_velocity`` (float32, each the halos' segments
    in halo order, with the per-halo counts in the file attrs
    ``n_<species>_per_halo``) and the attrs ``M200``, ``conc``,
    ``center``, ``bulk_velocity`` and ``particle_mass_<species>`` (per
    halo).  The scenes are what :func:`merger_scene_batches` yields for
    the same ``(seed, batch_size)``; the resume semantics are those of
    :func:`~.ensemble.ensemble_datagen` (shared loop), with the parameter
    arrays' sha256 in the resume config.  ``mesh``: each rank computes its
    ``ens`` rows of every batch, as in :func:`~.ensemble.ensemble_datagen`
    (a short batch whole; only rank 0 writes; the ``ens`` size joins the
    resume config).  Returns the filename.
    """
    from ..core.logging import mylog

    _check_r_a(anisotropy_radius)
    dev = resolve_device(device) if mesh is None else mesh_device(mesh)
    M200, conc, centers, velocities = _scene_inputs(params, dev)
    n_sc, H = M200.shape
    counts = _normalize_counts(
        counts, H, weights=halo_mass_weights(M200) if prorate else None)
    r_max = f64_on(r_max, dev).reshape(-1).expand(H).contiguous()
    batch_fn = _merger_batch_fn(num_points, counts["gas"], counts["dm"],
                                counts["star"], r_a=anisotropy_radius,
                                gravity=gravity, device=dev)
    mylog.info("Merger datagen: %d scenes x %d halos x %s particles%s -> %s",
               n_sc, H, counts, "" if anisotropy_radius is None
               else f" (OM r_a={anisotropy_radius:g} kpc)", filename)
    host = [_host(a) for a in (M200, conc, centers, velocities)]

    def produce(todo, write=True):
        for b0, out in _scene_batches(batch_fn, M200, conc, centers,
                                      velocities, r_max, batch_size, seed,
                                      todo, mesh=mesh, stage=write):
            sl = slice(b0, b0 + batch_size)
            yield b0, (out if out is None else _scene_records(
                b0, *(a[sl] for a in host), out))

    expected = [k for sp in ("gas", "dm", "star") if sum(counts[sp])
                for k in ([f"{sp}_position", f"{sp}_velocity"]
                          + (["gas_thermal_energy", "gas_density"]
                             if sp == "gas" else []))]
    extra = _extra_attrs or {}
    config = {"draws_version": _PORT_DRAWS + _MERGER_DRAWS_VERSION,
              "product": "merger_scenes",
              "n_clusters": n_sc,  # the count read_catalog keys on
              "n_scenes": n_sc,
              "n_halos": H, "batch_size": int(batch_size),
              "num_points": int(num_points),
              "r_a": (0.0 if anisotropy_radius is None
                      else float(anisotropy_radius)),
              "mesh_ens": _mesh_ens(mesh),
              "gravity": str(gravity),
              "r_max": _host(r_max),
              "params_sha": _params_sha(*host),
              "shard_rank": int(extra.get("shard_rank", 0)),
              "shard_count": int(extra.get("shard_count", 1)),
              "key_data": np.asarray([int(seed)], np.int64)}
    for sp in ("gas", "dm", "star"):
        config[f"n_{sp}_per_halo"] = np.asarray(counts[sp], np.int64)
    _stream_batched_catalog(filename, overwrite, resume, config,
                            _extra_attrs, expected, "scene", n_sc,
                            batch_size, _only_batches, produce, mesh, _group)
    return str(filename)


def merger_datagen_multihost(params, filename, counts, batch_size=64,
                             num_points=512, r_max=5000.0, seed=0,
                             overwrite=False, resume=False, mesh=None,
                             anisotropy_radius=None, gravity="newtonian",
                             prorate=True, rank=None, nproc=None,
                             device="cuda"):
    """Multi-process :func:`merger_datagen`: process ``rank`` of ``nproc``
    computes batches ``rank, rank+nproc, ...`` into
    ``<stem>.<rank>of<nproc><suffix>``, bit-identical to one process's
    catalog (see :func:`~.ensemble.ensemble_datagen_multihost`, also for
    ``mesh``: the ranks at ``part`` coordinate j write shard j together).
    Returns this process's shard filename."""
    rank, nproc, group = _mesh_shard(mesh, rank, nproc)
    shard, mine = _shard_plan(filename, len(params["M200"]), batch_size,
                              rank, nproc)
    return merger_datagen(
        params, shard, counts, batch_size=batch_size, num_points=num_points,
        r_max=r_max, seed=seed, overwrite=overwrite, resume=resume,
        mesh=mesh, anisotropy_radius=anisotropy_radius, gravity=gravity,
        prorate=prorate, device=device, _only_batches=mine,
        _extra_attrs={"shard_rank": rank, "shard_count": nproc},
        _group=group)


def read_merger_catalog(filename, indices=None, fields=None):
    """Iterate ``(index, scene_dict)`` over a :func:`merger_datagen`
    catalog: the raw pread path, shard lists and ``fields=`` of
    :func:`~.ensemble.read_catalog`; the scene attrs (per-halo ``M200``,
    ``conc``, masses, ``center``, ``bulk_velocity``) always come."""
    import contextlib

    filenames = _catalog_filenames(filename)
    with contextlib.ExitStack() as stack:
        files, readers, n_sc, where = _open_catalog(stack, filenames,
                                                    prefix="scene")
        if indices is None:
            indices = range(n_sc)
        if fields is not None:
            fields = list(fields)
        for i in indices:
            yield int(i), _read_cluster(files, readers, where, int(i),
                                        fields, filenames, prefix="scene")


def _merger_report():
    return {"n_scenes_checked": 0, "n_particles_checked": 0,
            "max_speed_frac": 0.0, "max_energy_rel_err": 0.0,
            "max_density_rel_err": 0.0, "max_velocity_err": 0.0,
            "max_radius_frac": 0.0, "max_mass_rel_err": 0.0,
            "violations": []}


def _check_scene(i, sc, f, n_per_halo, r_max, report, r_a=0.0,
                 speed_tol=_QA["speed_tol"],
                 energy_rtol=_QA["merger"]["energy_rtol"],
                 mass_rtol=_QA["merger"]["mass_rtol"],
                 radius_tol=_QA["merger"]["radius_tol"],
                 zero_row_tol=_QA["zero_row_tol"]):
    """The physics QA of one catalog scene on the host: ``sc`` the scene's
    dict (as :func:`read_merger_catalog` yields it), ``f`` its halos'
    rebuilt models (float64 numpy, (H, num_points) per field),
    ``n_per_halo`` the per-species per-halo counts, ``r_max`` (H,).  Adds
    to ``report`` (see :func:`verify_merger_catalog`)."""
    def _check(cond, msg):
        if not cond:
            report["violations"].append(msg)

    rr = f["radius"]
    psi = -f["gravitational_potential"]
    rho = f["density"]
    e_grid = 1.5 * f["pressure"] / rho
    centers = np.asarray(sc["center"], np.float64)
    bulk = np.asarray(sc["bulk_velocity"], np.float64)

    for sp in ("dm", "star"):
        if f"{sp}_position" not in sc:
            continue
        pos = np.asarray(sc[f"{sp}_position"], np.float64)
        vel = np.asarray(sc[f"{sp}_velocity"], np.float64)
        _check(np.isfinite(pos).all() and np.isfinite(vel).all(),
               f"scene {i} {sp}: non-finite values")
        o = 0
        for h, n_h in enumerate(n_per_halo[sp]):
            if n_h == 0:
                continue
            seg = slice(o, o + n_h)
            o += n_h
            r = np.sqrt(((pos[seg] - centers[h]) ** 2).sum(axis=1))
            zfrac = float((r == 0.0).mean())
            _check(zfrac <= zero_row_tol,
                   f"scene {i} {sp} halo {h}: {zfrac:.2%} zero-radius rows "
                   "(unwritten file extents?)")
            # the stored values: an unwritten extent is zero-filled, healthy
            # merger draws always carry bulk motion
            _check(np.count_nonzero(vel[seg]) > 0,
                   f"scene {i} {sp} halo {h}: all-zero stored velocities "
                   "(unwritten file extents?)")
            rfrac = float(r.max() / r_max[h])
            report["max_radius_frac"] = max(report["max_radius_frac"], rfrac)
            _check(rfrac <= 1.0 + radius_tol,
                   f"scene {i} {sp} halo {h}: radius {rfrac:.6f} of r_max")
            v = np.sqrt(((vel[seg] - bulk[h]) ** 2).sum(axis=1))
            v_esc = np.sqrt(2.0 * np.interp(r, rr[h], psi[h]))
            frac = float((v / v_esc).max())
            report["max_speed_frac"] = max(report["max_speed_frac"], frac)
            _check(frac <= 1.0 + speed_tol,
                   f"scene {i} {sp} halo {h}: peculiar speed {frac:.6f} of "
                   "local v_esc")
            if r_a > 0.0:
                nh = (pos[seg] - centers[h]) / np.maximum(r, 1e-30)[:, None]
                v_r = ((vel[seg] - bulk[h]) * nh).sum(axis=1)
                shell = ((r >= 1.2 * r_a)
                         & (r <= min(2.0 * r_a, float(r_max[h]))))
                if shell.sum() >= 1000:
                    v_t2 = v[shell] ** 2 - v_r[shell] ** 2
                    beta = 1.0 - v_t2.mean() / (2.0 * (v_r[shell] ** 2)
                                                .mean())
                    rmid = float(r[shell].mean())
                    b_om = rmid ** 2 / (rmid ** 2 + r_a ** 2)
                    _check(abs(beta - b_om) < 0.15,
                           f"scene {i} {sp} halo {h}: anisotropy beta "
                           f"{beta:.3f} vs OM {b_om:.3f} at r~{rmid:.0f} "
                           "(isotropic draws in an OM catalog?)")
            m_tot = float(np.interp(r_max[h], rr[h], f[_SPECIES_MASS[sp]][h]))
            pmass = float(np.asarray(sc[f"particle_mass_{sp}"])[h])
            merr = abs(pmass * n_h - m_tot) / m_tot
            report["max_mass_rel_err"] = max(report["max_mass_rel_err"], merr)
            _check(merr <= mass_rtol,
                   f"scene {i} {sp} halo {h}: mass budget off by {merr:.2e}")
            report["n_particles_checked"] += n_h

    if "gas_position" in sc:
        pos = np.asarray(sc["gas_position"], np.float64)
        u = np.asarray(sc["gas_thermal_energy"], np.float64)
        dens = np.asarray(sc["gas_density"], np.float64)
        gvel = np.asarray(sc["gas_velocity"], np.float64)
        _check(np.isfinite(pos).all() and np.isfinite(u).all(),
               f"scene {i} gas: non-finite values")
        _check((u > 0).all() and (dens > 0).all(),
               f"scene {i} gas: non-positive energy or density")
        # the density-weighted mix recomputed from the rebuilt fields with
        # the draws' own lerp; the device mix sums the interpolated product
        # rho * e per halo, so rho * e is interpolated, not e
        tpos = torch.from_numpy(pos)
        d_exp = de_exp = dv_exp = 0.0
        for h in range(len(rr)):
            r_h = (tpos - torch.from_numpy(centers[h])).norm(dim=-1)
            rr_h = torch.from_numpy(rr[h])
            d_h = _loglerp(r_h, rr_h, torch.from_numpy(rho[h])).numpy()
            d_exp = d_exp + d_h
            de_exp = de_exp + _loglerp(
                r_h, rr_h, torch.from_numpy(rho[h] * e_grid[h])).numpy()
            dv_exp = dv_exp + d_h[:, None] * bulk[h]
        o = 0
        for h, n_h in enumerate(n_per_halo["gas"]):
            if n_h == 0:
                continue
            seg = slice(o, o + n_h)
            o += n_h
            r = np.sqrt(((pos[seg] - centers[h]) ** 2).sum(axis=1))
            zfrac = float((r == 0.0).mean())
            _check(zfrac <= zero_row_tol,
                   f"scene {i} gas halo {h}: {zfrac:.2%} zero-radius rows "
                   "(unwritten file extents?)")
            rfrac = float(r.max() / r_max[h])
            report["max_radius_frac"] = max(report["max_radius_frac"], rfrac)
            _check(rfrac <= 1.0 + radius_tol,
                   f"scene {i} gas halo {h}: radius {rfrac:.6f} of r_max")
            m_tot = float(np.interp(r_max[h], rr[h], f["gas_mass"][h]))
            pmass = float(np.asarray(sc["particle_mass_gas"])[h])
            merr = abs(pmass * n_h - m_tot) / m_tot
            report["max_mass_rel_err"] = max(report["max_mass_rel_err"], merr)
            _check(merr <= mass_rtol,
                   f"scene {i} gas halo {h}: mass budget off by {merr:.2e}")
        u_exp = de_exp / d_exp
        rel = float((np.abs(u - u_exp) / u_exp).max())
        report["max_energy_rel_err"] = max(report["max_energy_rel_err"], rel)
        _check(rel <= energy_rtol,
               f"scene {i} gas: mixed thermal energy off by {rel:.3e}")
        drel = float((np.abs(dens - d_exp) / d_exp).max())
        report["max_density_rel_err"] = max(report["max_density_rel_err"],
                                            drel)
        _check(drel <= energy_rtol,
               f"scene {i} gas: mixed density off by {drel:.3e}")
        v_scale = max(float(np.abs(bulk).max()), 1e-3)
        verr = float(np.abs(gvel - dv_exp / d_exp[:, None]).max() / v_scale)
        report["max_velocity_err"] = max(report["max_velocity_err"], verr)
        _check(verr <= energy_rtol,
               f"scene {i} gas: mixed velocity off by {verr:.3e} of the "
               "bulk-speed scale")
        report["n_particles_checked"] += len(u)
    report["n_scenes_checked"] += 1


def _rebuild_halos(M200, conc, num_points, gravity, device):
    """Every halo of a batch of scenes rebuilt at once on ``device``:
    ``{name: (B, H, num_points)}`` float64 numpy (one copy to the host)."""
    M200 = np.asarray(M200, np.float64)
    B, H = M200.shape
    f = _rebuild_fields(M200.reshape(-1), np.asarray(conc).reshape(-1),
                        num_points, gravity, device)
    return {k: v.reshape(B, H, -1) for k, v in f.items()}


def _check_scenes(items, fields, n_per_halo, r_max, report, **tol):
    """:func:`_check_scene` for each ``(index, scene dict)`` of one
    rebuilt batch (``fields`` as :func:`_rebuild_halos` returns them)."""
    for j, (i, sc) in enumerate(items):
        _check_scene(i, sc, {k: v[j] for k, v in fields.items()},
                     n_per_halo, r_max, report, **tol)


def verify_merger_catalog(filename, indices=None,
                          speed_tol=_QA["speed_tol"],
                          energy_rtol=_QA["merger"]["energy_rtol"],
                          mass_rtol=_QA["merger"]["mass_rtol"],
                          radius_tol=_QA["merger"]["radius_tol"],
                          zero_row_tol=_QA["zero_row_tol"], strict=True,
                          batch_size=64, device="cuda"):
    """Physics QA gate of a :func:`merger_datagen` catalog (also reached
    through :func:`~.ensemble.verify_catalog`): every halo's model is
    REBUILT from its recorded ``(M200, conc)``, the halos of
    ``batch_size`` scenes at once on ``device``, and the stored draws are
    checked against it, halo segment by halo segment:

    * every value finite; no zero-radius rows past ``zero_row_tol``, no
      all-zero stored velocity block;
    * each halo's particles within its ``r_max`` of ITS centre
      (``radius_tol``);
    * collisionless peculiar speeds (velocity less the halo's bulk
      velocity) under the halo's local escape speed (``speed_tol``); for
      an OM catalog the anisotropy in a shell outside r_a;
    * gas thermal energy, density and velocity against the
      density-weighted mix of all halos recomputed from the rebuilt fields
      (``energy_rtol``);
    * each halo's particle mass against the species' grid mass at r_max
      (``mass_rtol``).

    Returns a report; ``strict`` raises ``ValueError`` on any violation."""
    import h5py

    filenames = _catalog_filenames(filename)
    with h5py.File(filenames[0], "r") as f:
        if f.attrs.get("product") != "merger_scenes":
            raise ValueError(f"{filenames[0]} is not a merger-scene "
                             "catalog; use verify_catalog")
        num_points = int(f.attrs["num_points"])
        n_sc = int(f.attrs["n_clusters"])
        r_a = float(f.attrs.get("r_a", 0.0))  # 0 = isotropic
        gravity = str(f.attrs.get("gravity", "newtonian"))
        r_max = np.asarray(f.attrs["r_max"], np.float64)
        n_per_halo = {sp: tuple(int(x) for x in f.attrs[f"n_{sp}_per_halo"])
                      for sp in ("gas", "dm", "star")}
    if indices is None:
        indices = range(n_sc)
    report = _merger_report()
    tol = dict(r_a=r_a, speed_tol=speed_tol, energy_rtol=energy_rtol,
               mass_rtol=mass_rtol, radius_tol=radius_tol,
               zero_row_tol=zero_row_tol)
    items = []

    def flush():
        fields = _rebuild_halos([sc["M200"] for _, sc in items],
                                [sc["conc"] for _, sc in items],
                                num_points, gravity, device)
        _check_scenes(items, fields, n_per_halo, r_max, report, **tol)
        items.clear()

    for i, sc in read_merger_catalog(filenames, indices=list(indices)):
        items.append((i, sc))
        if len(items) == batch_size:
            flush()
    if items:
        flush()
    if strict and report["violations"]:
        raise ValueError("merger catalog failed physics QA:\n  "
                         + "\n  ".join(report["violations"][:20]))
    return report


def _scene_particle_fields(sc, n_per_halo):
    """A catalog scene's dict as ``ClusterParticles`` fields (numpy): the
    per-halo particle masses expanded over the halo segments; gas keeps its
    mixed velocity, thermal energy and density."""
    fields = {}
    for sp in ("gas", "dm", "star"):
        pos = sc.get(f"{sp}_position")
        if pos is None:
            continue
        fields[sp, "particle_position"] = pos
        fields[sp, "particle_velocity"] = sc[f"{sp}_velocity"]
        pm = np.asarray(sc[f"particle_mass_{sp}"], np.float32)
        fields[sp, "particle_mass"] = np.repeat(pm, n_per_halo[sp])
        if sp == "gas":
            fields[sp, "thermal_energy"] = sc["gas_thermal_energy"]
            fields[sp, "density"] = sc["gas_density"]
    return fields


def scene_to_particles(filename, index, device="cuda"):
    """One merger scene as a :class:`~..particles.ClusterParticles` on
    ``device`` (:func:`~.ensemble.catalog_to_particles` dispatches here).
    Positions are in the scene frame: for a Gadget box add
    ``p.add_offsets([box / 2] * 3, [0] * 3)``."""
    import h5py

    from ..particles import ClusterParticles

    filenames = _catalog_filenames(filename)
    with h5py.File(filenames[0], "r") as f:
        n_per_halo = {sp: tuple(int(x) for x in f.attrs[f"n_{sp}_per_halo"])
                      for sp in ("gas", "dm", "star")}
    (_, sc), = read_merger_catalog(filenames, indices=[index])
    return ClusterParticles.from_fields(_scene_particle_fields(sc, n_per_halo),
                                        device=device)
