#!/usr/bin/env python3
"""Where the time of the port's paths that no benchmark cell covers goes,
on one NVIDIA card.  The fused merger and the datagen batch program are
the benchmark's cells: ``python3 portbench/run.py --workload <cell>
--trace 1`` splits their calls by stage, host span and idle gap.

``--path model``: the single-cluster class path at ``chip_smoke.py``'s full
width (the profiles with their solvers, a 4096-point ``ClusterModel``, both
DFs, both speed tables, and each ``generate_*_particles`` call, first and
again on the same model, for 1.05e7 particles in all).
``--path fields``: the 512^3 float32 magnetic field and its vector
potential, the 282^3 float64 radial field over the merger IC, and its
sampling at the IC's 5e6 gas particles, at ``chip_smoke.py``'s sizes.
``--path scenes``: the four stages of one merger-scene batch
(``parallel.mergers._merger_batch_fn``) at cfg6, 64 binary scenes of 1e5
particles on a 512-point grid.
``--path ics``: the stages of ``chip_smoke.py``'s two-halo IC scene
(1.05e7 particles): the per-halo draws (tables built), the gas mixing of
``combine_two_clusters``, ``resample_two_clusters`` with a passive scalar,
AREPO's 128^3 background grid added to the scene, the Gadget block
assembly with its copy to the host, and the Fortran particle file of the
dark matter.
``--path catalog``: one batch of ``chip_smoke.py``'s cfg5c catalog stream:
the batch program, the copy of its draws to pinned host memory through the
staging ring (``core/staging``), the per-cluster split into the catalog's
layout.  ``--path grid``: one batch of 64 chunks of the 512^3 grid painter
over the class-path model: the paint (f8), its copy to pinned memory, the
three momentum copies scaled on the host.  Each path runs
warm, under ``torch.profiler``, one stage at a time, and prints for each
stage one JSON line: host wall time, number of kernel launches, device busy
time (union of kernel intervals) and busy share.  Then it prints the
repository's own kernels and the ten that took the most device time over
the whole path.  The trace arithmetic is ``portbench/yardstick``'s.

    python3 scripts/profile_torch_merger.py \
        --path model|fields|scenes|ics|catalog|grid

Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (AREPO_NX, CATALOG_SEED, CLASS_COUNTS,  # noqa: E402
                        CLASS_POINTS, DATAGEN_BATCH, DATAGEN_COUNTS,
                        DATAGEN_POINTS, FIELD_DIMS, FIELD_SEED, GRID_BATCH,
                        GRID_BETA, GRID_BOX, GRID_CHUNK, GRID_DIMS,
                        GRID_VELOCITY, IC_BOX, IC_TOTALS, R_MAX, RADIAL_DIMS,
                        SCENE_BATCH, SCENE_COUNTS, SCENE_POINTS,
                        build_class_model, class_profiles, ic_combine,
                        ic_draws, ic_geometry, ic_resample, kernel_profile,
                        make_field, merger_models, nvidia_smi_line,
                        radial_field, run_main_path, scene_params)
from portbench.yardstick import kernels as yard_kernels  # noqa: E402
from portbench.yardstick import trace as yard_trace  # noqa: E402


def model_stages():
    import cluster_generator_tpu_torch as cg

    state = {}

    def dfs():
        state["m"].dm_virial, state["m"].star_virial  # noqa: B018

    def speed_tables():
        # cached per virial object; the model stage makes a new model, so
        # every round of the stages builds both tables once
        m = state["m"]
        m.dm_virial._speed_table(), m.star_virial._speed_table()

    n = CLASS_COUNTS
    draws = [
        ("gas", lambda: state["m"].generate_gas_particles(
            n["gas"], r_max=R_MAX, prng=1)),
        ("dm", lambda: state["m"].generate_dm_particles(
            n["dm"], r_max=R_MAX, compute_potential=True, prng=2)),
        ("star", lambda: state["m"].generate_star_particles(
            n["star"], r_max=R_MAX, prng=3)),
        ("tracer", lambda: state["m"].generate_tracer_particles(
            n["tracer"], r_max=R_MAX, prng=4)),
    ]
    # a species' first draw on a model builds its draw tables, the second
    # finds them (the tracers share the gas draws' tables both times)
    return ([("profiles", lambda: state.__setitem__(
                "profiles", class_profiles(cg))),
             ("model", lambda: state.__setitem__(
                 "m", cg.ClusterModel.from_dens_and_tden(
                     0.1, 1e4, state["profiles"][0], state["profiles"][1],
                     stellar_density=0.02 * state["profiles"][1],
                     num_points=CLASS_POINTS))),
             ("dfs", dfs), ("speed_tables", speed_tables)]
            + [(f"{name}_first", fn) for name, fn in draws]
            + [(f"{name}_again", fn) for name, fn in draws])


def fields_stages():
    import cluster_generator_tpu_torch as cg
    from cluster_generator_tpu_torch import fields as F
    from cluster_generator_tpu_torch import pipeline as P

    models = merger_models(cg)
    state = {"parts": run_main_path(P)[0]}
    return [
        ("magnetic_field_512", lambda: make_field(
            F, "RandomMagneticField", FIELD_DIMS, FIELD_SEED)),
        ("vector_potential_512", lambda: make_field(
            F, "RandomMagneticVectorPotential", FIELD_DIMS, FIELD_SEED)),
        ("radial_field_282", lambda: state.__setitem__(
            "f", radial_field(F, models, RADIAL_DIMS, "cuda"))),
        ("attach_5e6", lambda: P.attach_field_to_particles(
            state["parts"], state["f"])),
    ]


def scenes_stages():
    from cluster_generator_tpu_torch import pipeline as P
    from cluster_generator_tpu_torch.parallel import mergers as MG

    prog = MG._merger_batch_fn(SCENE_POINTS, *SCENE_COUNTS.values())
    p = scene_params(MG, SCENE_BATCH)
    ctr, vel = (torch.as_tensor(a, device="cuda") for a in
                MG.binary_scene_geometry(p["M200"], p["d"], p["b"],
                                         p["v_rel"]))
    r_max = torch.full((2,), R_MAX, dtype=torch.float64, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = {}

    def radius_tables():
        state["tabs"]["radius"] = P.build_radius_tables(
            state["f"], r_max.repeat(SCENE_BATCH))

    return [
        ("models", lambda: state.__setitem__(
            "f", prog.models(p["M200"], p["conc"]))),
        ("speed_tables", lambda: state.__setitem__(
            "tabs", P.build_speed_tables(state["f"]))),
        ("radius_tables", radius_tables),
        ("draws", lambda: state.__setitem__("out", prog.draws(
            state["f"], state["tabs"], p["M200"], ctr, vel, r_max, gen))),
    ]


def ics_stages():
    import tempfile

    import cluster_generator_tpu_torch as cg
    from cluster_generator_tpu_torch import codes as CO
    from cluster_generator_tpu_torch import ics as I
    from cluster_generator_tpu_torch import particles as PA

    models = merger_models(cg)
    for m in models:
        m.set_field("metallicity", torch.linspace(
            1.0, 0.1, m.num_elements, dtype=torch.float64, device="cuda"))
    centers, velocities = ic_geometry(cg, 2)
    counts = I.halo_particle_counts(models, [R_MAX] * 2, IC_TOTALS)
    state = {}

    def combine():
        scene = ic_combine(PA, state["halos"], models, centers, velocities)
        scene.set_field("gas", "metallicity",
                        torch.zeros(scene.num_particles["gas"],
                                    device="cuda"), passive_scalar=True)
        state["scene"] = scene

    def background():
        bg = CO._arepo_background(centers, [R_MAX] * 2, IC_BOX, AREPO_NX,
                                  state["scene"])
        state["full"] = state["scene"] + cg.ClusterParticles.from_fields(
            bg, device="cuda")

    def fortran_dm():
        with tempfile.TemporaryDirectory() as d:
            CO.write_amr_particles(state["scene"], os.path.join(d, "p.dat"),
                                   ["dm"], {"dm": 1}, format="fortran",
                                   in_cgs=True)

    # the first round of profile_path's warm-up builds the draw tables; the
    # profiled draws reuse them, as a second draw at the same r_max does
    return [
        ("draws", lambda: state.__setitem__("halos", ic_draws(
            I, models, counts, 2))),
        ("combine", combine),
        ("resample", lambda: ic_resample(PA, state["scene"], models,
                                         centers, velocities)),
        ("background", background),
        ("gadget_blocks", lambda: state["full"].gadget_blocks(
            IC_BOX, code="arepo")),
        ("fortran_dm", fortran_dm),
    ]


def catalog_stages():
    from cluster_generator_tpu_torch.core.staging import _Ring
    from cluster_generator_tpu_torch.parallel import ensemble as E

    M, c = E.sample_ensemble_params(
        torch.Generator(device="cuda").manual_seed(CATALOG_SEED),
        DATAGEN_BATCH)
    M_host, c_host = M.cpu().numpy(), c.cpu().numpy()
    _, _, prog = E._resolve_batch_fn(dict(DATAGEN_COUNTS), DATAGEN_POINTS)
    ring = _Ring(M.device)
    state = {}

    def program():
        out = prog(M, c, E._batch_generator(CATALOG_SEED, 0, M.device))
        state["names"], state["tensors"] = E._flat_outputs(out)

    def stage():
        arrays = ring.finish(ring.stage(state["tensors"]))
        host = {}
        for (sp, _), a in zip(state["names"], arrays):
            host.setdefault(sp, []).append(a)
        state["host"] = {sp: tuple(v) for sp, v in host.items()}

    def records():
        for _ in E._cluster_records(True, 0, M_host, c_host, state["host"]):
            pass

    return [("batch_program", program), ("stage_to_pinned", stage),
            ("records", records)]


def grid_stages():
    import numpy as np

    import cluster_generator_tpu_torch as cg
    from cluster_generator_tpu_torch import data_structures as DS
    from cluster_generator_tpu_torch.core.interp import cubic_spline
    from cluster_generator_tpu_torch.core.staging import _Ring

    m = build_class_model(cg, num_points=CLASS_POINTS)
    m.set_magnetic_field_from_beta(GRID_BETA)
    sp = cubic_spline(m["radius"], m["density"])
    starts = torch.as_tensor(DS.construct_chunks(
        [GRID_DIMS] * 3, GRID_CHUNK)[:, 0, :GRID_BATCH].T.astype(np.float64),
        device="cuda")
    deltas = torch.full((3,), GRID_BOX / GRID_DIMS, dtype=torch.float64,
                        device="cuda")
    left = torch.full((3,), -GRID_BOX / 2.0, dtype=torch.float64,
                      device="cuda")
    ring = _Ring(starts.device)
    state = {}

    def paint():
        state["blk"] = DS._paint_batch(sp, starts, deltas, left, GRID_CHUNK)

    def stage():
        state["host"], = ring.finish(ring.stage([state["blk"]]))

    def scaled():
        if "scratch" not in state:
            state["scratch"] = np.empty_like(state["host"])
        for fac in GRID_VELOCITY:
            np.multiply(state["host"], fac, out=state["scratch"])

    return [("paint_batch", paint), ("stage_to_pinned", stage),
            ("momentum_copies", scaled)]


def profile_path(path, stages, card):
    for _ in range(2):  # warm: kernels built, allocator pools filled
        for _, fn in stages:
            fn()
    torch.cuda.synchronize()

    all_kernels = []
    total_wall = 0.0
    for name, fn in stages:
        wall_ms, kern, busy = kernel_profile(fn)
        total_wall += wall_ms / 1e3
        all_kernels.extend(kern)
        print(json.dumps({"path": path, "stage": name, "wall_ms": wall_ms,
                          "kernel_launches": len(kern), "busy_ms": busy,
                          "busy_share": busy / wall_ms, "card": card}))

    # the same stages unprofiled (the profiler slows the host)
    plain = {}
    for name, fn in stages:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        plain[name] = (time.perf_counter() - t0) * 1e3

    by_name = {}
    for e in all_kernels:
        t = by_name.setdefault(e.name, [0, 0.0])
        t[0] += 1
        t[1] += e.dur_us / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    # the repository's own kernels, by their device time alone
    own = {n: {"launches": c, "ms": ms} for n, (c, ms) in by_name.items()
           if yard_kernels.K1_NAME in n}
    print(json.dumps({"path": path, "total_wall_ms": total_wall * 1e3,
                      "unprofiled_wall_ms": plain,
                      "kernel_launches": len(all_kernels),
                      "busy_ms": yard_trace.busy_us(
                          all_kernels, yard_trace.extent(all_kernels)) / 1e3,
                      "own_kernels": own,
                      "top_kernels": [{"name": n[:90], "launches": c,
                                       "ms": ms} for n, (c, ms) in top],
                      "card": card}))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--path", required=True,
                    choices=("model", "fields", "scenes", "ics", "catalog",
                             "grid"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_merger: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    stages = {"model": model_stages, "fields": fields_stages,
              "scenes": scenes_stages, "ics": ics_stages,
              "catalog": catalog_stages, "grid": grid_stages}[args.path]
    profile_path(args.path, stages(), nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
