"""The numbers that decide ``correct``: how far the arrays a run handed over
on the host lie from the reference's.

Every output is named ``"<species>/<field>"`` (particles) or
``"field/<name>"`` (a model field of the merger, one row per halo) and is a
numpy array.  Per particle, a vector (position, velocity) and a scalar
(density, thermal energy, mass) have the error
``|a - b| / max(|b|, 1e-3 median |b|)``; a model field per halo row
``max |a - b| / max |b|``.  A value that is not finite has an infinite
error.  The numbers are the 99.9th percentile and the largest error of each
kind over every particle of every compared answer, and the largest row
error of the model fields and of the DFs.  A merger's gas velocity, the
density-weighted mix of both halos' bulk velocities, cancels where they
oppose, and is a kind of its own (``gasvel``).
"""

from __future__ import annotations

import math

import numpy as np

KINDS = {
    "particle_position": "pos", "particle_velocity": "vel",
    "particle_mass": "mass", "density": "gas", "thermal_energy": "gas",
    "energy": "gas",
}
DFS = ("dm_df", "star_df")


def kind_of(name):
    group, field = name.split("/", 1)
    if group == "field":
        return "df" if field in DFS else "field"
    if group == "gas" and field == "particle_velocity":
        # a density-weighted mix of the halos' bulk velocities, which
        # cancels where they oppose: a number of its own
        return "gasvel"
    return KINDS.get(field, "other")


def _scaled(d, s):
    floor = 1e-3 * float(np.median(s)) if s.size else 0.0
    e = d / np.maximum(s, floor if floor > 0 else np.finfo(np.float64).tiny)
    return e


def errors(a, b, kind):
    """The errors of ``a`` against the reference ``b``: one per particle,
    or one per halo row for a model field."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if a.shape != b.shape:
        return np.array([math.inf])
    bad = ~np.isfinite(a)
    if kind in ("field", "df"):
        rows = a.reshape(-1, a.shape[-1])
        ref = b.reshape(-1, b.shape[-1])
        scale = np.max(np.abs(ref), axis=-1)
        e = np.max(np.abs(rows - ref), axis=-1) / np.where(scale > 0, scale,
                                                            1.0)
        e[bad.reshape(rows.shape).any(-1)] = math.inf
        return e
    if kind in ("pos", "vel", "gasvel"):
        d = np.linalg.norm(a - b, axis=-1)
        e = _scaled(d, np.linalg.norm(b, axis=-1))
        bad = bad.any(-1)
    else:
        e = _scaled(np.abs(a - b), np.abs(b))
    e = np.where(bad, math.inf, e).reshape(-1)
    return e


def numbers(pairs):
    """``pairs``: ``[(name, program array, reference array)]`` over every
    compared answer.  Returns ``{number: value}``: ``<kind>_p999`` and
    ``<kind>_max`` for the particle kinds, ``field_max`` and ``df_max``
    for the model fields."""
    by_kind = {}
    for name, a, b in pairs:
        by_kind.setdefault(kind_of(name), []).append(errors(a, b, kind_of(name)))
    out = {}
    for kind, errs in sorted(by_kind.items()):
        e = np.concatenate(errs)
        out[f"{kind}_max"] = float(np.max(e))
        if kind not in ("field", "df"):
            k = max(1, math.ceil(0.999 * e.size)) - 1
            out[f"{kind}_p999"] = float(np.partition(e, k)[k])
    return out


def against(got, ref):
    """:func:`numbers` of one answer, ``{name: array}`` each; an output
    that only one side has counts as infinitely wrong."""
    pairs = []
    for name in sorted(set(got) | set(ref)):
        if name in got and name in ref:
            pairs.append((name, got[name], ref[name]))
        else:
            pairs.append((name, np.array([np.nan]), np.array([1.0])))
    return numbers(pairs)


def worst(readings):
    """The largest of each number over several ``numbers`` results."""
    out = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, -math.inf), v)
    return out
