"""Driver of ``pipeline.merger_ic_fused``: one binary-merger IC per call,
closed loop, one caller.

A call is the port's fused merger program for the call's two halos
(:mod:`portbench.traffic_gen.merger_halos`), drawing from a
``torch.Generator`` on the card seeded for the call, and then the copy of
every particle array and every model field to pinned host memory through
``core.staging.to_host``.  The call ends when the arrays are in host
memory; the next call starts then.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.reference import paths
from portbench.traffic_gen.merger_halos import MergerHalos, seed_of

UNIT = "ics"


class Driver:
    def __init__(self, config, traffic, seed, device):
        from cluster_generator_tpu_torch.core.staging import to_host
        from cluster_generator_tpu_torch.pipeline import merger_ic_fused

        self.cfg, self.t, self.seed = config, traffic, int(seed)
        self.dev = torch.device(device)
        self.halos = MergerHalos(self.seed, traffic)
        self._fused, self._to_host = merger_ic_fused, to_host
        rng = np.random.default_rng([self.seed % 2**128, 3])
        self.checked = sorted(int(i) for i in rng.choice(
            traffic["check_within"], traffic["check_answers"], replace=False))
        self.kept = {}

    # ------------------------------------------------------------ calls
    def call(self, h):
        """One IC for the halos ``h``: ``{name: host array}``."""
        cfg = self.cfg
        gen = torch.Generator(device=self.dev).manual_seed(h["seed"])
        n = h["counts"]
        parts, fields = self._fused(
            h["M200"], h["conc"], h["centers"], h["velocities"],
            cfg["r_max_kpc"], n["gas"], n["dm"], n["star"], z=cfg["z"],
            num_points=cfg["num_points"], generator=gen, device=self.dev)
        names = [f"{sp}/{f}" for sp, f in parts] + [f"field/{k}"
                                                     for k in fields]
        arrays = self._to_host(list(parts.values()) + list(fields.values()))
        return dict(zip(names, arrays))

    def setup(self):
        """Every program key the run uses (one per mass ratio) captured,
        then replayed once, on halos of their own; the host arrays that
        keep the checked calls' output made and written once, so that
        keeping them in the window faults in no page."""
        warm = MergerHalos(seed_of(self.seed, 4, 0), self.t)
        done = {}
        i = 0
        while len(done) < len(self.t["ratios"]):
            h = warm.halos(i)
            if h["ratio"] not in done:
                self.call(h)
                out = self.call(warm.halos(i))
                done[h["ratio"]] = i
            i += 1
        # every key hands over arrays of the same shapes: the totals of
        # each species are the same whatever the mass ratio
        self._spare = [{k: v.copy() for k, v in out.items()}
                       for _ in self.checked]

    def window(self, seconds, max_calls=None):
        """Calls until ``seconds`` have passed (or ``max_calls`` are done):
        ``[(start, end, ics)]`` on the host clock.  Calls that a short
        window leaves before the last checked one run after it, unrecorded."""
        records = []
        t_end = time.perf_counter() + seconds
        i = 0
        while True:
            h = self.halos.halos(i)
            ts = time.perf_counter()
            out = self.call(h)
            te = time.perf_counter()
            if max_calls is not None or ts < t_end:
                records.append((ts, te, 1))
            if i in self.checked:
                kept = self.kept.get(i) or self._spare.pop()
                self.kept[i] = kept
                for k, v in out.items():
                    np.copyto(kept[k], v)
            i += 1
            done = (i >= max_calls if max_calls is not None
                    else te >= t_end)
            if done and i > self.checked[-1]:
                return records

    # ------------------------------------------------------------ check
    def reference(self, h, **precision):
        """The reference's IC for the halos ``h``: ``{name: host array}``;
        ``precision``: ``dt``, ``df_dt``, ``pdt`` of
        :func:`portbench.reference.paths.merger_ic`."""
        cfg = self.cfg
        parts, fields = paths.merger_ic(
            h["M200"], h["conc"], h["centers"], h["velocities"],
            cfg["r_max_kpc"], cfg["z"], h["counts"], h["seed"],
            cfg["num_points"], cfg["speed_tables"], self.dev,
            cfg["radius_quantiles"], **precision)
        out = {f"{sp}/{f}": v.numpy() for (sp, f), v in parts.items()}
        out.update({f"field/{k}": v for k, v in fields.items()})
        return out

    def answers(self):
        """Each kept call's host arrays, with the function that works out
        the reference's (its precision as in :meth:`reference`)."""
        return [(got, lambda h=self.halos.halos(i), **kw:
                 self.reference(h, **kw))
                for i, got in sorted(self.kept.items())]

    def k1_shapes(self):
        """K1 launches of one call: ``[(rows, n_s, n_q)]``, one per species
        over both halos' rows."""
        return [(2 * t["rows"], t["n_s"], t["n_q"])
                for t in self.cfg["speed_tables"].values()]
