"""Particle sampling on the model's device.

All draws are inverse-CDF transforms:

* radii: u ~ U(0,1) mapped through the normalized enclosed-mass CDF,
  tabulated at ``_RQ_CLASS`` uniform quantiles;
* angles: isotropic (cos(theta) ~ U(-1,1), phi ~ U(0, 2 pi));
* speeds: the per-model inverse speed-CDF table
  (:func:`~.virial.speed_inverse_cdf_table`, inverted by kernel K1) folded
  onto the radius-quantile nodes; no rejection loop.

Every generator takes ``prng`` (None, an int, a ``numpy.random.RandomState``
or a ``torch.Generator`` on the model's device) and, in its place, the
pre-drawn ``uniforms`` of its random sites, which is how two generators
that cannot produce the same stream are given the same numbers.  Radii and
directions are float64 draws; speeds are drawn in the table's dtype.
A draw reads nothing back from the model's device: the grid index of
``r_max`` and the log-uniform gate of the grid come from the model's host
copy of its radii (``ClusterModel._host_field``, made once per model).

Everything a draw needs besides its random numbers (the truncated CDF's
quantile nodes, the field splines, the joint speed table) depends only on
the model and ``r_max``.  It is built at the first draw and kept on the
object the draw belongs to (:func:`_draw_tables`), so that a second draw
is the per-particle work alone.  The tables and the draw are programs
(:func:`~.core.compiled.function`; on the card memoized CUDA graphs, the
counterparts of the JAX package's jitted draw functions): a model of other
parameters on a grid of the same shape replays them, and a warm draw makes
no host sync.  A draw without sub-sampling runs at the capacity class of
its count (:func:`~.core.compiled.capacity`), its uniforms drawn at the
count into the front of the class's buffers and its outputs sliced back
to the count, so a stream of draws whose counts change (an IC scene's)
replays one program per class and gives, bit for bit, the particles of a
draw at the count.  Marks (:func:`~.core.profiling.device_stage`):
``tables`` around a tables program, ``draws`` around a draw.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from .core import compiled
from .core.device import resolve_device, tensor_on
from .core.draws import (isotropic, isotropic_uniforms, node_lerp, uniform,
                         velocity_draw)
from .core.grid import linspace
from .core.interp import (cubic_spline, interp, is_loguniform, spline_eval,
                          spline_eval_loguniform)
from .core.logging import mylog
from .core.profiling import device_stage, span
from .particles import ClusterParticles

__all__ = ["parse_prng", "generate_particle_radii", "generate_gas_particles",
           "generate_tracer_particles", "generate_collisionless_particles"]


def parse_prng(prng, device="cuda"):
    """None / int / ``numpy.random.RandomState`` / ``torch.Generator`` as
    a ``torch.Generator`` on ``device``.  A generator passed in must
    already live there."""
    device = resolve_device(device)
    if isinstance(prng, torch.Generator):
        if prng.device.type != device.type:
            raise ValueError(f"the generator lives on {prng.device}, the "
                             f"model on {device}")
        return prng
    if prng is None:
        import secrets

        seed = secrets.randbits(63)
    elif isinstance(prng, (int, np.integer)):
        seed = int(prng)
    elif isinstance(prng, np.random.RandomState):
        # the upstream package's RandomState, for API compatibility: its
        # state is folded into a seed
        seed = int(prng.randint(0, 2**31 - 1))
    else:
        raise TypeError(f"cannot make a torch.Generator from {prng!r}")
    return torch.Generator(device=device).manual_seed(seed)


def _grid_index(r_host, r_max):
    """The number of grid points below ``r_max`` on the host copy
    ``r_host`` of a radial grid (the grid length for ``None``): the
    truncation index, a static of the draw-table programs."""
    if r_max is None:
        return int(r_host.shape[0])
    ridx = int(np.searchsorted(r_host, float(r_max)))
    if ridx == 0:
        # ridx - 1 would wrap to the last grid point: the full-grid mass,
        # and draws far beyond r_max
        raise ValueError(
            f"r_max={r_max} lies below the first grid point "
            f"(r[0]={float(r_host[0])}); nothing to sample.")
    return ridx


def _cdf(r, m, dens, ridx):
    """Normalized enclosed mass of the float64 tensors ``r``, ``m``,
    truncated at grid index ``ridx`` (:func:`_grid_index`): ``(P, r with a
    leading 0, mtot)``, ``mtot`` a 0-d tensor.  The body the draw-table
    programs run.

    Zero-density grid points (the clamped dark-matter outskirts) are
    masked by forward-filling the mass, so they carry zero sampling
    probability.
    """
    if dens is not None:
        neg_inf = torch.full_like(m, -torch.inf)
        m_eff = torch.cummax(torch.where(dens > 0.0, m, neg_inf), dim=0).values
        m_eff = torch.where(torch.isfinite(m_eff), m_eff,
                            torch.zeros_like(m_eff))
    else:
        m_eff = m
    mtot = m_eff[ridx - 1]
    P = torch.clamp(m_eff / mtot, 0.0, 1.0)
    P = torch.cummax(P, dim=0).values
    zero = torch.zeros(1, dtype=r.dtype, device=r.device)
    return torch.cat([zero, P]), torch.cat([zero, r]), mtot


def _truncated_cdf(r, m, dens=None, r_max=None, r_host=None):
    """:func:`_cdf` truncated at ``r_max``, with ``mtot`` a float (as the
    JAX package returns it): the index from ``r_host``, the grid on the
    host (default: a copy of ``r``), and one read of ``mtot``."""
    if r_host is None:
        r_host = r.detach().cpu().numpy()
    P, rr, mtot = _cdf(r, m, dens, _grid_index(r_host, r_max))
    with span("cg.wait.read"):
        return P, rr, float(mtot)


# radius-quantile table resolution of the generators: a draw is a
# computed-index lerp, with no per-particle search over the CDF, at an
# O(1/RQ^2) CDF resampling error
_RQ_CLASS = 4096


def _radius_quantile_nodes(P, rr):
    """The inverse CDF at ``_RQ_CLASS`` uniform quantiles.

    The top node is clamped at the radius where P first reaches 1: the
    r_max clip leaves a P = 1 plateau out to the grid end, and the
    interpolation at exactly 1.0 walks to the plateau's far edge, so that
    draws would leak past the truncation radius.  A CDF that tops out
    below 1 takes the grid end as its cap."""
    full = P >= 1.0
    # a 1-element index: indexing with a 0-d tensor reads it on the host
    first = torch.argmax(full.to(torch.int8)).reshape(1)
    r_cap = torch.where(full.any(), rr[first][0], rr[-1])
    q = linspace(0.0, 1.0, _RQ_CLASS, device=rr.device)
    return torch.minimum(interp(q, P, rr), r_cap)


def _sample_radii_table(r_q, u):
    """``(radius, kq, wq)`` at the float64 uniforms ``u``: computed-index
    lerp on the quantile-node table.  kq/wq feed the joint speed table and
    any per-particle node-value lerp, so that later lookups share the one
    radius draw."""
    RQ = r_q.shape[0]
    x = torch.clamp(u * (RQ - 1), 0.0, RQ - 1 - 1e-9)
    # integer clamp as well, as at the float32 sites
    kq = torch.clamp_max(x.to(torch.int64), RQ - 2)
    wq = x - kq
    return node_lerp(r_q, kq, wq), kq, wq


def generate_particle_radii(r, m, num_particles, r_max=None, prng=None,
                            dens=None, uniforms=None, device="cuda"):
    """Inverse-CDF radius sampling by per-particle interpolation of the
    CDF; returns ``(radii, mtot)``, ``mtot`` a float.  ``uniforms``: the
    (num,) float64 draws.  The draw runs where ``r`` lives when it is a
    tensor, and on ``device`` when it is an array; ``m`` and ``dens`` as
    arrays follow ``r``, as tensors they must live there already.  The
    host reads ``mtot``, and ``r`` too when it is a tensor on a card (for
    the index of ``r_max``); an array ``r`` is its own host copy."""
    r_host = (None if isinstance(r, torch.Tensor)
              else np.asarray(r, dtype=np.float64))
    r = tensor_on(r, device)
    m = tensor_on(m, r.device)
    if dens is not None:
        dens = tensor_on(dens, r.device)
    P, rr, mtot = _truncated_cdf(r, m, dens=dens, r_max=r_max, r_host=r_host)
    if uniforms is None:
        uniforms = uniform(parse_prng(prng, rr.device), int(num_particles),
                           torch.float64, rr.device)
    return interp(uniforms, P, rr), mtot


def _tile(arr, sub_sample, num):
    if sub_sample > 1:
        # num may be no multiple of sub_sample: one extra copy, so that
        # the truncation always has >= num elements
        reps = (sub_sample + 1,) + (1,) * (arr.ndim - 1)
        return arr.repeat(reps)[:num]
    return arr


def _draw_tables(owner, r_max, sources, build):
    """``build()``, kept on ``owner`` (a model for its gas, a virial
    object for its species) for the next draw.  One entry is held: it is
    rebuilt when ``r_max`` changes and when any tensor of ``sources``, the
    fields the tables were made of, was replaced or written in place."""
    key = None if r_max is None else float(r_max)
    stamp = tuple(t._version for t in sources)
    held = owner._draw_tables
    if (held is not None and held[0] == key and held[2] == stamp
            and all(a is b for a, b in zip(held[1], sources))):
        return held[3]
    tables = build()
    owner._draw_tables = (key, sources, stamp, tables)
    return tables


def _grid_statics(model, r_max):
    """``(ridx, loguniform)`` of a draw at ``r_max`` on ``model``'s grid,
    from the host copy of the grid (``ClusterModel._host_field``): the
    truncation index (:func:`_grid_index`) and the log-uniform gate of the
    computed-index evaluators (:func:`~.core.interp.is_loguniform`, on the
    host copy: no read from the card)."""
    r_host = model._host_field("radius")
    return (_grid_index(r_host, r_max),
            is_loguniform(torch.from_numpy(r_host)))


def _spline_at(sp, loguniform, radius_sub):
    """The cubic spline ``sp`` of a field at the drawn radii.  Log-uniform
    grids (every built model) take the computed-index path, other grids a
    bracketing search.  Queries are clamped to the knot range: the
    sampling CDF starts at r = 0, so inner-bin draws land below the first
    knot, where the boundary polynomial's extrapolation can turn 1.5 P/rho
    negative."""
    if loguniform:
        return spline_eval_loguniform(sp, radius_sub)
    return spline_eval(sp, torch.clamp(radius_sub, sp.x[0], sp.x[-1]))


@compiled.function(static=("ridx",))
def _gas_tables_program(radius, gas_mass, density, pressure, potential, ridx):
    """The gas draw tables of one model (the body of :func:`_gas_tables`):
    the radius-quantile nodes, the mass inside ``r_max`` (0-d) and the
    splines of the fields the model has."""
    P, rr_ins, mtot = _cdf(radius, gas_mass, None, ridx)
    tables = {"r_q": _radius_quantile_nodes(P, rr_ins), "mtot": mtot}
    if pressure is not None:
        tables["energy"] = cubic_spline(radius, 1.5 * pressure / density)
        tables["density"] = cubic_spline(radius, density)
    if potential is not None:
        tables["potential"] = cubic_spline(radius, potential)
    return tables


def _gas_tables(model, r_max):
    """What a gas or tracer draw needs of ``model`` inside ``r_max``: the
    radius-quantile nodes, the mass, the splines of the per-particle
    fields (the potential's whenever the model has one, so that no draw
    adds to held tables) and the grid's log-uniform gate, built by one
    program (:func:`_gas_tables_program`) and kept on the model."""
    names = ["radius", "gas_mass"]
    names += [k for k in ("density", "pressure", "gravitational_potential")
              if k in model]
    sources = tuple(model[k] for k in names)

    def build():
        ridx, loguniform = _grid_statics(model, r_max)
        with device_stage("tables", model["radius"]):
            tables = _gas_tables_program(
                model["radius"], model["gas_mass"],
                model["density"] if "pressure" in model else None,
                model["pressure"] if "pressure" in model else None,
                (model["gravitational_potential"]
                 if "gravitational_potential" in model else None),
                ridx=ridx)
        return dict(tables, loguniform=loguniform)

    return _draw_tables(model, r_max, sources, build)


def _gas_uniforms(gen, num, num_sub, device, out=None):
    """Every uniform of a gas or tracer draw, in the order the draw takes
    them: ``(u_radius (num_sub,), (cos_theta, u_phi) (num,))``, float64
    (into ``out``, a program's static buffers)."""
    out = out or (None, None)
    return (uniform(gen, num_sub, torch.float64, device, out=out[0]),
            isotropic_uniforms(gen, num, torch.float64, device, out=out[1]))


# the draws' memo: each holds a program per capacity class in use, and an
# IC scene's two halos at three mass ratios use about a dozen classes of
# DM and stars (whose draws share one memo)
DRAW_PROGRAMS = 24


def _drawn_positions(r_q, u_radius, u_dir, num, sub_sample):
    """``(radius_sub, kq, wq, radius, rhat)`` of ``num`` particles:
    ``num // sub_sample`` radii from the quantile nodes, tiled, and their
    directions."""
    radius_sub, kq, wq = _sample_radii_table(r_q, u_radius)
    radius = _tile(radius_sub, sub_sample, num)
    rhat = isotropic(num, torch.float64, r_q.device, uniforms=u_dir)
    return radius_sub, kq, wq, radius, rhat


@compiled.function(static=("num", "sub_sample"), random="uniforms",
                   memo=DRAW_PROGRAMS)
def _draw_tracers(r_q, uniforms, num, sub_sample):
    """The tracer draw after the tables (one program) at ``num``, the
    count or its capacity class (:func:`_sized`)."""
    _, _, _, radius, rhat = _drawn_positions(r_q, *uniforms, num, sub_sample)
    pos = radius[:, None] * rhat
    return {("tracer", "particle_position"): pos,
            ("tracer", "particle_velocity"): torch.zeros_like(pos),
            ("tracer", "particle_mass"): torch.zeros_like(radius)}


@compiled.function(static=("num", "sub_sample", "compute_potential"),
                   random="uniforms", memo=DRAW_PROGRAMS)
def _draw_gas(tables, count, uniforms, num, sub_sample, compute_potential):
    """The gas draw after the tables (one program) at ``num``, the count or
    its capacity class (:func:`_sized`); ``count`` (a float) the count,
    which divides the mass."""
    radius_sub, _, _, radius, rhat = _drawn_positions(
        tables["r_q"], *uniforms, num, sub_sample)
    pos = radius[:, None] * rhat

    # field values at the DRAWN radii: lerping them between the
    # radius-quantile nodes instead would be exact for the radius but not
    # for a curved field (the innermost mass-quantile bin spans a huge
    # radius range)
    def field_at(name):
        return _tile(_spline_at(tables[name], tables["loguniform"],
                                radius_sub), sub_sample, num)

    fields = OrderedDict()
    fields["gas", "particle_position"] = pos
    fields["gas", "thermal_energy"] = field_at("energy")
    fields["gas", "particle_mass"] = (tables["mtot"] / count).expand(
        num).contiguous()
    fields["gas", "density"] = field_at("density")
    fields["gas", "particle_velocity"] = torch.zeros_like(pos)
    if compute_potential:
        fields["gas", "particle_potential"] = field_at("potential")
    return fields


def _device_and_generator(model, ptype, num_particles, prng, uniforms):
    """``(device, generator)`` of a class-path draw on ``model``'s device
    (logged): the generator ``prng`` gives, ``None`` when ``uniforms`` are
    given."""
    dev = model["radius"].device
    mylog.info("We will be assigning %d %s particles.", num_particles, ptype)
    gen = None if uniforms is not None else parse_prng(prng, dev)
    return dev, gen


def _sized(num, sub):
    """The length a draw of ``num`` particles runs at: the capacity class
    of ``num`` (:func:`~.core.compiled.capacity`), or ``num`` itself with
    sub-sampling, whose tiling depends on the count."""
    return compiled.capacity(num) if sub == 1 else num


def _front(fields, num):
    """The first ``num`` particles of a draw's outputs, each in a tensor of
    its own where the draw ran at a larger class: a view would keep the
    class's padding alive, so that what a scene holds would follow its
    counts' classes rather than its counts."""
    if all(v.shape[0] == num for v in fields.values()):
        return fields
    compiled.room_for(next(iter(fields.values())).device, *[
        (num * v[:1].numel(), v.dtype) for v in fields.values()])
    return OrderedDict((k, v[:num].clone()) for k, v in fields.items())


def generate_tracer_particles(model, num_particles, r_max=None, sub_sample=1,
                              prng=None, uniforms=None):
    """Massless tracers at rest that follow the gas.  ``uniforms``:
    ``(u_radius (num // sub_sample,), (cos_theta, u_phi) (num,))``.

    The tables (:func:`_gas_tables`) and the draw
    (:func:`_draw_tracers`) are one program each, the counterparts of the
    JAX package's jitted draw functions: the uniforms are drawn from the
    generator before the program runs, in the body's order."""
    num, sub = int(num_particles), int(sub_sample)
    dev, gen = _device_and_generator(model, "tracer", num, prng, uniforms)
    tables = _gas_tables(model, r_max)
    size = _sized(num, sub)
    draw = compiled.drawer(uniforms, gen, dev, lambda g, out: _gas_uniforms(
        g, num, num // sub, dev, out), count=num, size=size)
    with device_stage("draws", tables["r_q"]):
        out = _draw_tracers(tables["r_q"], draw, num=size, sub_sample=sub)
    return ClusterParticles("tracer", _front(out, num), device=dev)


def generate_gas_particles(model, num_particles, r_max=None, sub_sample=1,
                           compute_potential=False, prng=None, uniforms=None):
    """Gas particles in hydrostatic equilibrium: positions from the
    gas-mass CDF, thermal energies e = 1.5 P / rho and densities splined at
    each drawn radius, equal masses, zero velocities.  ``uniforms``: as
    for :func:`generate_tracer_particles`, and so are the programs
    (:func:`_draw_gas`)."""
    num, sub = int(num_particles), int(sub_sample)
    dev, gen = _device_and_generator(model, "gas", num, prng, uniforms)
    tables = _gas_tables(model, r_max)
    size = _sized(num, sub)
    draw = compiled.drawer(uniforms, gen, dev, lambda g, out: _gas_uniforms(
        g, num, num // sub, dev, out), count=num, size=size)
    with device_stage("draws", tables["r_q"]):
        out = _draw_gas(tables, float(num), draw, num=size, sub_sample=sub,
                        compute_potential=bool(compute_potential))
    return ClusterParticles("gas", _front(out, num), device=dev)


@compiled.function(static=("ridx",))
def _collisionless_tables_program(radius, mass, density, potential, speed,
                                  ridx):
    """The draw tables of one collisionless species (the body of
    :func:`_collisionless_tables`).  ``speed``: the held inverse speed-CDF
    table ``{"row_ee", "s_inv"}``, or the arguments of
    :func:`~.virial.speed_inverse_cdf_table`, which then runs here (kernel
    K1 inside this program) and joins the outputs as ``"s_inv"``."""
    from .virial import build_joint_speed_pairs, speed_inverse_cdf_table

    P, rr_ins, mtot = _cdf(radius, mass, density, ridx)
    r_q = _radius_quantile_nodes(P, rr_ins)
    psi_grid = -potential   # the virial object's ee in radial ordering
    psi_sp = cubic_spline(radius, psi_grid)
    psi_q = spline_eval(psi_sp, r_q)
    tables = {"r_q": r_q, "mtot": mtot, "psi": psi_sp, "psi_q": psi_q}
    s_inv = speed.get("s_inv")
    if s_inv is None:
        s_inv = tables["s_inv"] = speed_inverse_cdf_table(**speed)
    tables["joint"] = build_joint_speed_pairs(
        radius, psi_grid, speed["row_ee"], s_inv, r_q, dtype=s_inv.dtype,
        psi_q=psi_q)
    return tables


def _collisionless_tables(virial, r_max, n_rows=256):
    """What a draw of ``virial``'s species needs inside ``r_max``: the
    radius-quantile nodes, the mass, psi as a spline and at the nodes
    (exact cubic spline; it feeds the joint table and the escape-speed
    cap), the joint absolute-speed table
    (:func:`~.virial.build_joint_speed_pairs`) and the grid's log-uniform
    gate, built by one program (:func:`_collisionless_tables_program`) and
    kept on the virial object.  The inverse speed-CDF table it folds is
    ``virial``'s (``_speed_table``) when held, else the program builds it
    (K1 inside) and hands it to ``virial``."""
    model, ptype = virial.model, virial.ptype
    sources = (model["radius"], model[f"{ptype}_mass"],
               model[f"{ptype}_density"], model["gravitational_potential"],
               virial.df)

    def build():
        ridx, loguniform = _grid_statics(model, r_max)
        held = virial._s_inv.get(n_rows)
        speed = (virial._speed_table_inputs(n_rows) if held is None
                 else {"row_ee": held[0], "s_inv": held[1]})
        with device_stage("tables", model["radius"]):
            tables = _collisionless_tables_program(
                model["radius"], model[f"{ptype}_mass"],
                model[f"{ptype}_density"], model["gravitational_potential"],
                speed, ridx=ridx)
        if held is None:
            virial._s_inv[n_rows] = (speed["row_ee"], tables.pop("s_inv"))
        return dict(tables, loguniform=loguniform)

    return _draw_tables(virial, r_max, sources, build)


def _collisionless_uniforms(gen, num, num_sub, dtype, device, out=None):
    """Every uniform of a DM or star draw, in the order the draw takes
    them: ``(u_radius (num_sub,), (cos_theta, u_phi) of the positions
    (num,), (u_quantile, u_row) of the speeds (num_sub,) in ``dtype``,
    (cos_theta, u_phi) of the velocities (num,))``."""
    out = out or (None, None, (None, None), None)
    f64 = torch.float64
    return (uniform(gen, num_sub, f64, device, out=out[0]),
            isotropic_uniforms(gen, num, f64, device, out=out[1]),
            (uniform(gen, num_sub, dtype, device, out=out[2][0]),
             uniform(gen, num_sub, dtype, device, out=out[2][1])),
            isotropic_uniforms(gen, num, f64, device, out=out[3]))


@compiled.function(static=("num", "sub_sample", "compute_potential",
                           "short"), random="uniforms",
                   memo=DRAW_PROGRAMS)
def _draw_collisionless(tables, r_a, count, uniforms, num, sub_sample,
                        compute_potential, short):
    """The DM or star draw after the tables (one program) at ``num``, the
    count or its capacity class (:func:`_sized`); ``r_a`` the
    Osipkov-Merritt radius or ``None`` (isotropic); ``count`` (a float)
    the count, which divides the mass."""
    from .virial import sample_speeds_joint

    u_r, u_pos, u_speed, u_vel = uniforms
    radius_sub, kq, wq, radius, rhat = _drawn_positions(
        tables["r_q"], u_r, u_pos, num, sub_sample)
    pos = radius[:, None] * rhat
    psi_p = node_lerp(tables["psi_q"], kq, wq)

    speed_sub = sample_speeds_joint(tables["joint"], kq, wq,
                                    uniforms=u_speed)
    # the joint table picks the speed row by a Bernoulli draw between the
    # two radius-quantile nodes while the radius is lerped, so a particle
    # near the outer node can draw from the inner node's (faster) table
    # and pass its LOCAL escape speed by up to the inter-node difference,
    # O(1/RQ).  The cap at v_esc(r) = sqrt(2 psi(r)) keeps it bound.
    speed_sub = torch.minimum(speed_sub,
                              torch.sqrt(2.0 * psi_p).to(speed_sub.dtype))
    speed = _tile(speed_sub, sub_sample, num)
    # rhat is the position draw's own unit vector (exact at r = 0)
    vel = velocity_draw(speed, u_vel, rhat, radius, r_a)

    fields = OrderedDict()
    fields[short, "particle_position"] = pos
    fields[short, "particle_velocity"] = vel
    fields[short, "particle_mass"] = (tables["mtot"] / count).expand(
        num).contiguous()
    if compute_potential:
        # exact-radius evaluation for the OUTPUT potential (the lerped
        # psi_p above only bounds the escape-speed cap)
        psi_sub = _spline_at(tables["psi"], tables["loguniform"], radius_sub)
        fields[short, "particle_potential"] = -_tile(psi_sub, sub_sample,
                                                     num)
    return fields


def generate_collisionless_particles(virial, num_particles, r_max=None,
                                     sub_sample=1, compute_potential=False,
                                     prng=None, uniforms=None):
    """DM or star particles in virial equilibrium.

    Speeds come from the inverse speed-CDF table folded onto the radius
    quantile nodes as a joint absolute-speed table
    (:func:`~.virial.build_joint_speed_pairs`): per particle, one
    computed-index radius lerp and one joint-table lookup, with no psi
    lookup and no search.

    When ``virial`` carries an Osipkov-Merritt anisotropy radius, the same
    speed draw applies (the OM f(Q) is isotropic in (v_r, gamma v_t)
    space) and only the velocity directions change: the tangential
    components are divided by gamma(r) = sqrt(1 + r^2/r_a^2), which gives
    beta(r) = r^2/(r^2 + r_a^2).

    ``uniforms``: ``(u_radius (num // sub_sample,), (cos_theta, u_phi) of
    the positions (num,), (u_quantile, u_row) of the speeds (num //
    sub_sample,) in the table's dtype, (cos_theta, u_phi) of the
    velocities (num,))``.

    The tables (:func:`_collisionless_tables`) and the draw
    (:func:`_draw_collisionless`; ``r_a`` an input, whether there is one
    its key) are one program each, the counterparts of the JAX package's
    jitted draw functions.
    """
    num, sub = int(num_particles), int(sub_sample)
    short = {"dark_matter": "dm", "stellar": "star"}[virial.ptype]
    dev, gen = _device_and_generator(virial.model, virial.ptype, num, prng,
                                     uniforms)
    tables = _collisionless_tables(virial, r_max)
    dtype = tables["joint"].dtype
    size = _sized(num, sub)
    draw = compiled.drawer(uniforms, gen, dev, lambda g, out: (
        _collisionless_uniforms(g, num, num // sub, dtype, dev, out)),
        count=num, size=size)
    with device_stage("draws", tables["r_q"]):
        out = _draw_collisionless(
            tables, virial.r_a, float(num), draw, num=size, sub_sample=sub,
            compute_potential=bool(compute_potential), short=short)
    return ClusterParticles(short, _front(out, num), device=dev)
