"""Driver of ``parallel.ensemble.datagen_batches``: an ensemble streamed
batch by batch to the host, one consumer.

The ensemble's (M200, c) come from the run's seed
(:mod:`portbench.traffic_gen.ensemble_params`), long enough that the
window never runs dry.  Each batch draws from a ``torch.Generator`` on the
card seeded for that batch.  ``datagen_batches`` enqueues batch k+1 before
it yields batch k; ``core.staging.stream_to_host`` copies each batch to
pinned host memory on its side stream and hands it over two batches later,
as a catalog writer consumes them.  A call is one batch, from its enqueue
(when ``datagen_batches`` asks for its generator) to its arrays handed
over on the host.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.reference import paths
from portbench.traffic_gen import ensemble_params
from portbench.traffic_gen.merger_halos import seed_of

UNIT = "clusters"


class Driver:
    def __init__(self, config, traffic, seed, device):
        from cluster_generator_tpu_torch.core.staging import stream_to_host
        from cluster_generator_tpu_torch.parallel.ensemble import \
            datagen_batches

        self.cfg, self.t, self.seed = config, traffic, int(seed)
        self.dev = torch.device(device)
        self.B = int(traffic["batch_size"])
        self.counts = {sp: int(traffic["particles"][sp])
                       for sp in ("dm", "gas", "star")}
        self._batches, self._stream = datagen_batches, stream_to_host
        rng = np.random.default_rng([self.seed % 2**128, 3])
        self.checked = {
            int(k): np.sort(rng.choice(self.B, traffic["check_clusters"],
                                       replace=False))
            for k in rng.choice(traffic["check_within"],
                                traffic["check_answers"], replace=False)}
        self.kept = {}
        self.M200 = self.conc = None

    def _ensemble(self, stream, n_batches):
        gen = torch.Generator(device=self.dev).manual_seed(
            seed_of(self.seed, stream, 0))
        p = self.cfg["ensemble"]
        return ensemble_params.sample(gen, n_batches * self.B,
                                      tuple(p["log10_m200_range"]),
                                      tuple(p["conc_range"]),
                                      p["conc_scatter"])

    def _stream_of(self, M200, conc, stream, enqueued):
        """The handed-over batches of an ensemble: ``(b0, {name: host
        array})``; ``enqueued[b0]`` gets each batch's enqueue time."""
        def generator(b0):
            enqueued[b0] = time.perf_counter()
            return torch.Generator(device=self.dev).manual_seed(
                seed_of(self.seed, stream, b0 // self.B))

        def flat():
            for b0, out in self._batches(
                    M200, conc, self.counts, batch_size=self.B,
                    num_points=self.cfg["num_points"], seed=generator,
                    device=self.dev):
                names, tensors = [], []
                for sp, arrays in out.items():
                    for f, a in zip(_FIELDS[sp], arrays):
                        names.append(f"{sp}/{f}")
                        tensors.append(a)
                yield (b0, names), tensors

        for (b0, names), arrays in self._stream(flat()):
            yield b0, dict(zip(names, arrays))

    def setup(self):
        """The batch program captured and replayed, and the staging ring
        filled, on an ensemble of its own."""
        self.M200, self.conc = self._ensemble(1, self.t["ensemble_batches"])
        M, c = self._ensemble(5, 4)
        for _, out in self._stream_of(M, c, 6, {}):
            pass
        # the host arrays that keep the checked clusters, written once so
        # that keeping them in the window faults in no page
        n = self.t["check_clusters"]
        self._spare = [{name: a[:n].copy() for name, a in out.items()}
                       for _ in self.checked]

    def window(self, seconds, max_calls=None):
        """Batches until ``seconds`` have passed: ``[(enqueued, handed
        over, clusters)]``.  With ``max_calls`` the first ``max_calls``
        batches of the ensemble instead, every one enqueued, copied and
        handed over.  Batches that a short window leaves before the last
        checked one are handed over after it, unrecorded."""
        records, enqueued = [], {}
        t_end = time.perf_counter() + seconds
        n = None if max_calls is None else max_calls * self.B
        it = self._stream_of(self.M200[:n], self.conc[:n], 2, enqueued)
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
        """The reference's clusters ``rows`` of batch ``k``; ``precision``:
        ``dt``, ``df_dt``, ``pdt`` of
        :func:`portbench.reference.paths.datagen_batch`."""
        sl = slice(k * self.B, (k + 1) * self.B)
        cfg = self.cfg
        out = paths.datagen_batch(
            self.M200[sl].double().cpu().numpy(),
            self.conc[sl].double().cpu().numpy(), self.counts,
            seed_of(self.seed, 2, k), self.B, cfg["num_points"],
            cfg["speed_tables"], cfg["radius_quantiles"], cfg["z"],
            self.dev, rows=rows, **precision)
        return {f"{sp}/{f}": a.numpy()
                for sp, arrays in out.items()
                for f, a in zip(_FIELDS[sp], arrays)}

    def answers(self):
        """Each kept batch's host rows, with the function that works out
        the reference's (its precision as in :meth:`reference`)."""
        return [(got, lambda k=k, **kw: self.reference(k, self.checked[k],
                                                       **kw))
                for k, got in sorted(self.kept.items())]

    def k1_shapes(self):
        """K1 launches of one batch: ``[(rows, n_s, n_q)]``, one per
        species over every cluster's rows."""
        return [(self.B * t["rows"], t["n_s"], t["n_q"])
                for t in self.cfg["speed_tables"].values()]


_FIELDS = {"dm": ("particle_position", "particle_velocity", "particle_mass"),
           "star": ("particle_position", "particle_velocity",
                    "particle_mass"),
           "gas": ("particle_position", "energy", "particle_mass")}
