"""The halos of the merger cells, one binary merger per call.

From the run's seed (``numpy.random.default_rng``): the primary's M200
log-uniform over ``m200_range``; the mass ratio from ``ratios`` (ZuHone
2011's 1, 3 and 10), in blocks that hold each ratio once, shuffled within
the block, so every seed makes the same mix of program keys; the impact
parameter uniform over ``[0, b_max]``; the concentrations from
5 (M200 / 1e15 Msun)^-0.1.  The halos sit ``separation`` apart along x and
``b`` apart along y, about their centre of mass, and close along x at
``v_rel``, with zero total momentum.  Particle counts go to the halos in
proportion to M200, the last halo taking the remainder (as ``bench.py``
splits its 1e7 particles).
"""

from __future__ import annotations

import math

import numpy as np


def counts_for(ratio, totals):
    """Per-halo counts ``{species: (n0, n1)}`` for a mass ratio."""
    share = ratio / (1.0 + ratio)
    out = {}
    for sp, n in totals.items():
        n0 = int(round(n * share))
        out[sp] = (n0, n - n0)
    return out


class MergerHalos:
    """The calls of a run: ``halos(i)`` gives call ``i``'s inputs."""

    def __init__(self, seed, traffic):
        self.t = traffic
        self.seed = int(seed) % 2**128
        self.rng = np.random.default_rng([self.seed, 1])
        self._cache = []

    def _block(self):
        t = self.t
        ratios = list(t["ratios"])
        order = self.rng.permutation(len(ratios))
        lo, hi = (math.log10(m) for m in t["m200_range"])
        out = []
        for k in order:
            m1 = 10.0 ** self.rng.uniform(lo, hi)
            b = self.rng.uniform(0.0, t["b_max_kpc"])
            out.append((m1, float(ratios[k]), b))
        return out

    def halos(self, i):
        while len(self._cache) <= i:
            self._cache.extend(self._block())
        m1, ratio, b = self._cache[i]
        t = self.t
        m2 = m1 / ratio
        mt = m1 + m2
        d, v = t["separation_kpc"], t["v_rel_kpc_per_myr"]
        centers = [[-d * m2 / mt, -b * m2 / mt, 0.0],
                   [d * m1 / mt, b * m1 / mt, 0.0]]
        velocities = [[v * m2 / mt, 0.0, 0.0], [-v * m1 / mt, 0.0, 0.0]]
        M200 = [m1, m2]
        conc = [5.0 * (m / 1.0e15) ** (-0.1) for m in M200]
        return {"M200": M200, "conc": conc, "centers": centers,
                "velocities": velocities, "ratio": ratio,
                "counts": counts_for(ratio, t["particles"]),
                "seed": seed_of(self.seed, 2, i)}


def seed_of(seed, stream, i):
    """The seed of the ``i``-th generator of ``stream`` in a run: a
    non-negative 63-bit integer, whatever came before it."""
    state = np.random.SeedSequence([seed, stream, i]).generate_state(
        1, dtype=np.uint64)[0]
    return int(state >> np.uint64(1))
