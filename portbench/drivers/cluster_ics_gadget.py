"""Driver of the IC scene through the class path: one binary-merger IC per
call, closed loop, one caller.

A call is what a user of ``ClusterICs`` runs for one IC: each halo of
:mod:`portbench.traffic_gen.merger_halos` built as a ``ClusterModel``
(``from_dens_and_tden``) with its DM and stellar DFs, a ``ClusterICs``
scene over the two models in memory (the totals split by the halos'
masses), ``setup_particle_ics`` with the call's seed, and the scene's
Gadget blocks (``ClusterParticles.gadget_blocks``) for a box with the
pair's centre of mass at its centre, staged to pinned host memory.  The
call ends when the blocks are in host memory; the next call starts then.
Each call's stage marks are one sequence (``device_sequence``), its halos'
profile set-up marked as ``models``.

``window`` returns the calls' records as a list whose ``captures`` is the
programs the port captured during the window (``core.compiled.captures``).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench.reference import scene
from portbench.traffic_gen.merger_halos import MergerHalos, seed_of

UNIT = "ics"
# Gadget name -> the name the comparison reads
BLOCKS = scene.NAMES


class Calls(list):
    """A window's ``[(start, end, ics)]`` and the programs captured in it."""

    captures = 0


class Driver:
    def __init__(self, config, traffic, seed, device):
        import cluster_generator_tpu_torch as cg
        from cluster_generator_tpu_torch.core import compiled, profiling

        if not (hasattr(cg.ClusterParticles, "gadget_blocks")
                and hasattr(profiling, "device_sequence")):
            raise RuntimeError(
                "this cell needs ClusterICs over models in memory, "
                "ClusterParticles.gadget_blocks and "
                "profiling.device_sequence, which this package lacks")
        self.cg, self.compiled, self.profiling = cg, compiled, profiling
        self.cfg, self.t, self.seed = config, traffic, int(seed)
        self.dev = torch.device(device)
        self.on = torch.empty(0, device=self.dev)
        self.halos = MergerHalos(self.seed, traffic)
        rng = np.random.default_rng([self.seed % 2**128, 3])
        self.checked = sorted(int(i) for i in rng.choice(
            traffic["check_within"], traffic["check_answers"], replace=False))
        self.kept = {}

    # ------------------------------------------------------------ calls
    def model(self, M200, conc):
        """One halo as the class path builds it, with both DFs."""
        cg, cfg, dev = self.cg, self.cfg, self.dev
        z = cfg["z"]
        with self.profiling.device_stage("models", self.on):
            r200 = cg.find_overdensity_radius(M200, 200.0, z=z)
            a = r200 / conc
            M = cg.snfw_total_mass(M200, r200, a)
            rhot = cg.snfw_density_profile(M, a)
            r500, M500 = cg.find_radius_mass(cg.snfw_mass_profile(M, a),
                                             z=z, delta=500.0, device=dev)
            rhog = cg.rescale_profile_by_mass(
                cg.vikhlinin_density_profile(1.0, 100.0, r200, 1.0, 0.67, 3),
                cg.f_gas(M500) * M500, r500)
            lo, hi = cfg["grid_kpc"]
            m = cg.ClusterModel.from_dens_and_tden(
                lo, hi, rhog, rhot, stellar_density=0.02 * rhot,
                num_points=cfg["num_points"], device=dev)
            m.dm_virial, m.star_virial
        return m

    def scene(self, h):
        """The call's ``ClusterICs`` over its two models, box-centred."""
        cfg = self.cfg
        models = [self.model(m, c) for m, c in zip(h["M200"], h["conc"])]
        centers = np.asarray(h["centers"]) + 0.5 * cfg["box_kpc"]
        return self.cg.ClusterICs(
            "scene", 2, models, centers, h["velocities"],
            num_particles=dict(self.t["particles"]), r_max=cfg["r_max_kpc"],
            device=self.dev)

    def call(self, h):
        """One IC for the halos ``h``: ``(ics, blocks)``, the blocks in host
        memory."""
        with self.profiling.device_sequence(self.dev):
            ics = self.scene(h)
            parts = ics.setup_particle_ics(prng=h["seed"])
            blocks, _, _ = parts.gadget_blocks(self.cfg["box_kpc"])
        return ics, blocks

    def setup(self):
        """For each mass ratio the scenes of ``warm_masses`` primary masses
        spread over ``m200_range`` (log-uniform, the ends included), twice:
        every capacity class the traffic's counts fall in captured (the
        counts move little with the mass at a given ratio), then replayed.
        The same for every seed, so that runs hold the same programs."""
        t = self.t
        lo, hi = (math.log10(m) for m in t["m200_range"])
        warm = MergerHalos(seed_of(self.seed, 4, 0), t)
        # the calls' (primary M200, ratio, b), as MergerHalos lays them out
        warm._cache = [(10.0 ** x, float(r), 0.5 * t["b_max_kpc"])
                       for r in t["ratios"]
                       for x in np.linspace(lo, hi, t["warm_masses"])]
        halos = [warm.halos(i) for i in range(len(warm._cache))]
        for _ in range(2):
            for h in halos:
                self.call(h)

    def _keep(self, ics, blocks):
        """A checked call's answer: its blocks under the comparison's
        names, its halos' fields and DFs, and its counts."""
        out = {}
        for sp, arrays in blocks.items():
            for block, name in BLOCKS.items():
                if block in arrays:
                    out[f"{sp}/{name}"] = np.array(arrays[block])
        models = [ics.load_model(i) for i in range(ics.num_halos)]
        for key in scene.FIELDS:
            out[f"field/{key}"] = np.stack([m[key].cpu().numpy()
                                            for m in models])
        for key, v in (("dm_df", "dm_virial"), ("star_df", "star_virial")):
            out[f"field/{key}"] = np.stack([
                getattr(m, v).df.cpu().numpy() for m in models])
        counts = {sp: list(ics.num_particles[sp]) for sp in scene.SPECIES}
        return out, counts

    def window(self, seconds, max_calls=None):
        """Calls until ``seconds`` have passed (or ``max_calls`` are done):
        ``Calls`` of ``(start, end, ics)`` on the host clock.  Calls that a
        short window leaves before the last checked one run after it,
        unrecorded."""
        records = Calls()
        before = self.compiled.captures
        t_end = time.perf_counter() + seconds
        i = 0
        while True:
            h = self.halos.halos(i)
            ts = time.perf_counter()
            ics, blocks = self.call(h)
            te = time.perf_counter()
            if max_calls is not None or ts < t_end:
                records.append((ts, te, 1))
                records.captures = self.compiled.captures - before
            if i in self.checked:
                self.kept[i] = self._keep(ics, blocks)
            del ics, blocks
            i += 1
            done = (i >= max_calls if max_calls is not None
                    else te >= t_end)
            if done and i > self.checked[-1]:
                return records

    # ------------------------------------------------------------ check
    def reference(self, h, counts, **precision):
        """The reference's answer for the halos ``h`` and the program's
        ``counts``; ``precision``: ``dt``, ``df_dt``, ``pdt`` of
        :func:`portbench.reference.scene.scene`."""
        centers = np.asarray(h["centers"]) + 0.5 * self.cfg["box_kpc"]
        return scene.scene(h["M200"], h["conc"], centers, h["velocities"],
                           self.t["particles"], counts, h["seed"], self.cfg,
                           self.dev, **precision)

    def answers(self):
        """Each kept call's host arrays, with the function that works out
        the reference's (its precision as in :meth:`reference`)."""
        return [(got, lambda h=self.halos.halos(i), c=counts, **kw:
                 self.reference(h, c, **kw))
                for i, (got, counts) in sorted(self.kept.items())]

    def k1_shapes(self):
        """K1 launches of one call: ``[(rows, n_s, n_q)]``, one per halo
        and collisionless species."""
        return [(t["rows"], t["n_s"], t["n_q"])
                for t in self.cfg["speed_tables"].values()] * 2
