"""Driver of the port's random magnetic fields: one field per call, closed
loop, one caller.

A call is the configuration's field B (``RandomMagneticField``,
divergence-cleaned) or its vector potential A
(``RandomMagneticVectorPotential``) on the card, drawing its white noise
from a ``torch.Generator`` seeded for the call, and then the copy of its
three components to pinned host memory through ``core.staging.to_host``.
The call ends when they are in host memory; the next call starts then.  B
and A come in blocks that hold each once, in an order drawn from the run's
seed, so every run asks for both program keys alike.

``window`` returns the calls' records as a list that also carries the
grid its fields have (``shape``, and ``itemsize``, the bytes of one real
value), which the transforms' roofline readers take.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.reference import field
from portbench.traffic_gen.merger_halos import seed_of

UNIT = "fields"


class Calls(list):
    """A window's ``[(start, end, fields)]`` and the grid of its fields."""

    shape = None
    itemsize = None


class Driver:
    def __init__(self, config, traffic, seed, device):
        import cluster_generator_tpu_torch as cg
        from cluster_generator_tpu_torch.core.staging import to_host

        self.cfg, self.t, self.seed = config, traffic, int(seed)
        self.dev = torch.device(device)
        self.classes = {k: getattr(cg, name)
                        for k, name in traffic["fields"].items()}
        self.dtype = getattr(torch, config["precision"]["field"])
        self._to_host = to_host
        # per kind: its components' names and whether it is a vector
        # potential, as its first field gives them
        self.comps, self.potential = {}, {}
        self._order = np.random.default_rng([self.seed % 2**128, 1])
        self._kinds = []
        # one checked call of each kind among the first check_within
        rng = np.random.default_rng([self.seed % 2**128, 3])
        first = [self.kind(i) for i in range(traffic["check_within"])]
        self.checked = sorted(
            int(rng.choice([i for i, k in enumerate(first) if k == kind]))
            for kind in traffic["block"])
        self.kept = {}

    def kind(self, i):
        """``"B"`` or ``"A"``: the field call ``i`` asks for."""
        block = self.t["block"]
        while len(self._kinds) <= i:
            self._kinds.extend(block[j]
                               for j in self._order.permutation(len(block)))
        return self._kinds[i]

    # ------------------------------------------------------------ calls
    def _field(self, kind, seed):
        """One field of ``kind`` drawn with ``seed``: ``{name: host
        array}``."""
        cfg = self.cfg
        gen = torch.Generator(device=self.dev).manual_seed(seed)
        f = self.classes[kind](
            cfg["left_edge_kpc"], cfg["right_edge_kpc"], cfg["ddims"],
            cfg["l_min_kpc"], cfg["l_max_kpc"], cfg["B_rms_gauss"],
            padding=cfg["padding"], alpha=cfg["alpha"], prng=gen,
            dtype=self.dtype, device=self.dev)
        arrays = self._to_host([f.gx, f.gy, f.gz])
        self.comps[kind] = list(f.comps)
        self.potential[kind] = bool(f.vector_potential)
        return {f"field/{n}": a for n, a in zip(f.comps, arrays)}

    def call(self, i):
        """Call ``i`` of the run: ``{name: host array}``."""
        return self._field(self.kind(i), seed_of(self.seed, 2, i))

    def setup(self):
        """Both program keys captured, then replayed once, on seeds of
        their own; the host arrays that keep the checked calls' fields
        made and written once, so that keeping them in the window faults
        in no page."""
        out = {}
        for j, kind in enumerate(self.t["block"] * 2):
            out[kind] = self._field(kind, seed_of(self.seed, 4, j))
        self._spare = {i: {k: v.copy() for k, v in
                           out[self.kind(i)].items()} for i in self.checked}

    def window(self, seconds, max_calls=None):
        """Calls until ``seconds`` have passed (or ``max_calls`` are done):
        ``[(start, end, 1)]`` on the host clock.  Calls that a short window
        leaves before the last checked one run after it, unrecorded.  A
        checked call's field is kept from the first window that makes it
        (a traced run makes the same calls three times)."""
        records = Calls()
        records.shape, _ = field.grid(self.cfg)
        records.itemsize = torch.empty((), dtype=self.dtype).element_size()
        t_end = time.perf_counter() + seconds
        i = 0
        while True:
            ts = time.perf_counter()
            out = self.call(i)
            te = time.perf_counter()
            if max_calls is not None or ts < t_end:
                records.append((ts, te, 1))
            if i in self.checked and i not in self.kept:
                kept = self.kept[i] = self._spare.pop(i)
                for k, v in out.items():
                    np.copyto(kept[k], v)
            # the call's pinned buffer goes back before the next call
            out = None
            i += 1
            done = (i >= max_calls if max_calls is not None
                    else te >= t_end)
            if done and i > self.checked[-1]:
                return records

    # ------------------------------------------------------------ check
    def reference(self, i, **precision):
        """The reference's field of call ``i``: ``{name: host array}``;
        ``precision``: ``dt``, ``df_dt``, ``pdt`` of
        :func:`portbench.reference.field.field`."""
        kind = self.kind(i)
        return field.field(self.cfg, self.potential[kind],
                           seed_of(self.seed, 2, i), self.dev,
                           self.comps[kind], **precision)

    def answers(self):
        """Each kept call's host arrays, with the function that works out
        the reference's (its precision as in :meth:`reference`)."""
        return [(got, lambda i=i, **kw: self.reference(i, **kw))
                for i, got in sorted(self.kept.items())]

    def k1_shapes(self):
        """No K1 launch: a field draws no particle."""
        return []
