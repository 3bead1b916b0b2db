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
uniforms.  :func:`merger_scene_batches` streams an ensemble batch by batch
as tensors on the device; :func:`verify_scene_batch` holds a batch to the
physics QA of the merger catalog.

The HDF5 catalog side of the product (writer, resume, readers, the catalog
verifier, ``scene_to_particles``) is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.draws import uniform
from ..core.interp import interp
from ..model.gravity import get_gravity
from ..pipeline import (build_merger_models, build_radius_tables,
                        build_speed_tables, sample_merger_ic)
from .ensemble import _batch_generator, _check_r_a, _f64, build_one_cluster
from .qa import QA_TOLERANCES as _QA

__all__ = ["sample_merger_scene_params", "binary_scene_geometry",
           "triple_scene_geometry", "sample_triple_scene_params",
           "halo_mass_weights", "merger_scene_batches", "verify_scene_batch"]

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
        return [_f64(u, device) for u in given]
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
    return torch.clamp(c_mean * torch.exp(_f64(normals, device) * 0.3),
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
    return {"M200": M200, "conc": conc, "centers": _f64(centers, dev),
            "velocities": _f64(velocities, dev)}


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
    methods so that each can be timed alone."""

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

    def __call__(self, M200, conc, centers, velocities, r_max,
                 generator=None, uniforms=None):
        dev = self.device
        M200, conc = _f64(M200, dev), _f64(conc, dev)
        centers, velocities = _f64(centers, dev), _f64(velocities, dev)
        r_max = _f64(r_max, dev).reshape(-1)
        if generator is None and uniforms is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        fields = self.models(M200, conc)
        tables = self.tables(fields, r_max)
        return self.draws(fields, tables, M200, centers, velocities, r_max,
                          generator, uniforms)


def _merger_batch_fn(num_points, n_gas, n_dm, n_star, r_a=None,
                     gravity="newtonian", device="cuda"):
    """The scene-batch program for one configuration (see
    :class:`_SceneBatch`); ``n_*`` are per-halo counts."""
    return _SceneBatch(num_points, n_gas, n_dm, n_star, r_a=r_a,
                       gravity=gravity, device=device)


def _scene_inputs(params, device):
    """``(M200, conc, centers, velocities)`` float64 tensors on ``device``
    from a params dict with explicit ``centers``/``velocities`` or the
    binary geometry inputs ``d``, ``b``, ``v_rel``."""
    M200 = _f64(params["M200"], device)
    conc = _f64(params["conc"], device)
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
    centers, velocities = _f64(centers, device), _f64(velocities, device)
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
    r_max = _f64(r_max, dev).reshape(-1).expand(H).contiguous()
    batch_fn = _merger_batch_fn(num_points, counts["gas"], counts["dm"],
                                counts["star"], r_a=anisotropy_radius,
                                gravity=gravity, device=dev)
    make_gen = seed if callable(seed) else (
        lambda b0: _batch_generator(seed, b0, dev))
    pending = None
    for b0 in range(0, int(M200.shape[0]), batch_size):
        sl = slice(b0, b0 + batch_size)
        nxt = (b0, batch_fn(M200[sl], conc[sl], centers[sl], velocities[sl],
                            r_max, make_gen(b0)))
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
    M200, conc = _f64(M200, dev), _f64(conc, dev)
    centers, velocities = _f64(centers, dev), _f64(velocities, dev)
    B, H = M200.shape
    r_max = _f64(r_max, dev).reshape(-1).expand(H)
    f = build_one_cluster(M200.reshape(-1), conc.reshape(-1),
                          num_points=num_points, with_df=False,
                          gravity=gravity)
    f = {k: v.reshape(B, H, -1) for k, v in f.items()}
    rr = f["radius"]
    psi = -f["gravitational_potential"]
    rho = f["density"]
    e_grid = 1.5 * f["pressure"] / rho
    mass_key = {"dm": "dark_matter_mass", "star": "stellar_mass",
                "gas": "gas_mass"}
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
            m_tot = interp(r_max[h].expand(B, 1), rr[:, h], f[mass_key[sp]][:, h])
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
