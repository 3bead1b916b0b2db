"""Driver of ``parallel.mergers.merger_scene_batches``: an ensemble of
binary-merger scenes streamed batch by batch to the host, one consumer.

The scenes (M200, c, centres and bulk velocities of both halos) come from
the run's seed (:mod:`portbench.traffic_gen.scene_params`), long enough
that the window never runs dry; the per-halo counts are the traffic's.
Each batch draws from a ``torch.Generator`` on the card seeded for that
batch.  ``merger_scene_batches`` enqueues batch k+1 before it yields batch
k; ``core.staging.stream_to_host`` copies each batch to pinned host memory
on its side stream and hands it over two batches later, as a catalog
writer consumes them.  A call is one batch, from its enqueue (when
``merger_scene_batches`` asks for its generator) to its arrays handed over
on the host.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.reference import scenes
from portbench.traffic_gen import scene_params
from portbench.traffic_gen.merger_halos import seed_of

UNIT = "ics"

# the batch's outputs by the names the comparison reads
_NAMES = {"gas_position": "gas/particle_position",
          "gas_velocity": "gas/particle_velocity",
          "gas_thermal_energy": "gas/thermal_energy",
          "gas_density": "gas/density", "mass_gas": "gas/particle_mass",
          "dm_position": "dm/particle_position",
          "dm_velocity": "dm/particle_velocity",
          "mass_dm": "dm/particle_mass",
          "star_position": "star/particle_position",
          "star_velocity": "star/particle_velocity",
          "mass_star": "star/particle_mass"}


class Driver:
    def __init__(self, config, traffic, seed, device):
        from cluster_generator_tpu_torch.core.staging import stream_to_host
        from cluster_generator_tpu_torch.parallel.mergers import \
            merger_scene_batches

        self.cfg, self.t, self.seed = config, traffic, int(seed)
        self.dev = torch.device(device)
        self.B = int(traffic["batch_size"])
        self.counts = {sp: tuple(int(n) for n in traffic["particles"][sp])
                       for sp in ("gas", "dm", "star")}
        self._batches, self._stream = merger_scene_batches, stream_to_host
        rng = np.random.default_rng([self.seed % 2**128, 3])
        self.checked = {
            int(k): np.sort(rng.choice(self.B, traffic["check_scenes"],
                                       replace=False))
            for k in rng.choice(traffic["check_within"],
                                traffic["check_answers"], replace=False)}
        self.kept = {}
        self.params = None

    def _scenes(self, stream, n_batches):
        gen = torch.Generator(device=self.dev).manual_seed(
            seed_of(self.seed, stream, 0))
        return scene_params.sample(gen, n_batches * self.B,
                                   self.cfg["scenes"])

    def _stream_of(self, params, stream, enqueued):
        """The handed-over batches of a scene ensemble: ``(b0, {name: host
        array})``; ``enqueued[b0]`` gets each batch's enqueue time."""
        M200, conc, centers, velocities = params

        def generator(b0):
            enqueued[b0] = time.perf_counter()
            return torch.Generator(device=self.dev).manual_seed(
                seed_of(self.seed, stream, b0 // self.B))

        def flat():
            for b0, out in self._batches(
                    {"M200": M200, "conc": conc, "centers": centers,
                     "velocities": velocities}, self.counts,
                    batch_size=self.B, num_points=self.cfg["num_points"],
                    r_max=self.cfg["r_max_kpc"], seed=generator,
                    device=self.dev):
                names = list(out)
                yield (b0, names), [out[k] for k in names]

        for (b0, names), arrays in self._stream(flat()):
            yield b0, {_NAMES[k]: a for k, a in zip(names, arrays)}

    def setup(self):
        """The batch program captured and replayed, and the staging ring
        filled, on an ensemble of its own."""
        self.params = self._scenes(1, self.t["ensemble_batches"])
        for _, out in self._stream_of(self._scenes(5, 4), 6, {}):
            pass
        # the host arrays that keep the checked scenes, written once so
        # that keeping them in the window faults in no page
        n = self.t["check_scenes"]
        self._spare = [{name: a[:n].copy() for name, a in out.items()}
                       for _ in self.checked]

    def window(self, seconds, max_calls=None):
        """Batches until ``seconds`` have passed: ``[(enqueued, handed
        over, scenes)]``.  With ``max_calls`` the first ``max_calls``
        batches of the ensemble instead, every one enqueued, copied and
        handed over.  Batches that a short window leaves before the last
        checked one are handed over after it, unrecorded."""
        records, enqueued = [], {}
        t_end = time.perf_counter() + seconds
        n = None if max_calls is None else max_calls * self.B
        it = self._stream_of([p[:n] for p in self.params], 2, enqueued)
        try:
            last = max(self.checked)
            for b0, out in it:
                te = time.perf_counter()
                if max_calls is not None or not records or (
                        records[-1][1] < t_end):
                    records.append((enqueued[b0], te, self.B))
                k = b0 // self.B
                if k in self.checked:
                    kept = self.kept.get(k) or self._spare.pop()
                    self.kept[k] = kept
                    for name, a in out.items():
                        np.take(a, self.checked[k], axis=0, out=kept[name])
                if max_calls is None and te >= t_end and k >= last:
                    break
        finally:
            it.close()
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        return records

    def reference(self, k, rows, **precision):
        """The reference's scenes ``rows`` of batch ``k``; ``precision``:
        ``dt``, ``df_dt``, ``pdt`` of
        :func:`portbench.reference.scenes.batch`."""
        sl = slice(k * self.B, (k + 1) * self.B)
        M200, conc, centers, velocities = (p[sl].cpu().numpy()
                                           for p in self.params)
        cfg = self.cfg
        return scenes.batch(M200, conc, centers, velocities,
                            cfg["r_max_kpc"], cfg["z"], self.counts,
                            seed_of(self.seed, 2, k), self.B, rows,
                            cfg["num_points"], cfg["speed_tables"],
                            cfg["radius_quantiles"], self.dev, **precision)

    def answers(self):
        """Each kept batch's host rows, with the function that works out
        the reference's (its precision as in :meth:`reference`)."""
        return [(got, lambda k=k, **kw: self.reference(k, self.checked[k],
                                                       **kw))
                for k, got in sorted(self.kept.items())]

    def k1_shapes(self):
        """K1 launches of one batch: ``[(rows, n_s, n_q)]``, one per
        species over both halos of every scene."""
        return [(self.B * 2 * t["rows"], t["n_s"], t["n_q"])
                for t in self.cfg["speed_tables"].values()]
