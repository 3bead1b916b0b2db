#!/usr/bin/env python3
"""Where the time of the port's main paths goes, on one NVIDIA card.

``--path merger``: the four stages of ``cluster_generator_tpu_torch.pipeline``
at the full 1e7-particle binary-merger workload of ``chip_smoke.py``.
``--path datagen``: the five stages of one ensemble datagen batch
(``parallel.ensemble._datagen_full_batch_fn``) at ``chip_smoke.py``'s full
width, 256 clusters of 1e5 particles on a 512-point grid.
``--path model``: the single-cluster class path at ``chip_smoke.py``'s full
width (the profiles with their solvers, a 4096-point ``ClusterModel``, both
DFs, both speed tables, and each ``generate_*_particles`` call, first and
again on the same model, for 1.05e7 particles in all).
``--path fields``: the 512^3 float32 magnetic field and its vector
potential, the 282^3 float64 radial field over the merger IC, and its
sampling at the IC's 5e6 gas particles, at ``chip_smoke.py``'s sizes.
``--path scenes``: the four stages of one merger-scene batch
(``parallel.mergers._merger_batch_fn``) at cfg6, 64 binary scenes of 1e5
particles on a 512-point grid.  Each path runs
warm, under ``torch.profiler``, one stage at a time, and prints for each
stage one JSON line: host wall time, number of kernel launches, device busy
time (union of kernel intervals) and busy share.  Then it prints the
repository's own kernels and the ten that took the most device time over
the whole path.  The default, ``both``, runs the merger and the datagen
path.

    python3 scripts/profile_torch_merger.py \
        [--path merger|datagen|model|fields|scenes|both]

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

from chip_smoke import (CENTERS, CLASS_COUNTS, CLASS_POINTS,  # noqa: E402
                        CONC, DATAGEN_BATCH, DATAGEN_COUNTS, DATAGEN_POINTS,
                        DATAGEN_SEED, FIELD_DIMS, FIELD_SEED, M200, N_DM,
                        N_GAS, N_STAR, R_MAX, RADIAL_DIMS, SCENE_BATCH,
                        SCENE_COUNTS, SCENE_POINTS, VELOCITIES,
                        class_profiles, kernel_profile, make_field,
                        merger_models, nvidia_smi_line, radial_field,
                        run_main_path, scene_params)


def merger_stages():
    from cluster_generator_tpu_torch import pipeline as P

    gen = torch.Generator(device="cuda").manual_seed(0)
    state = {}
    return [
        ("models", lambda: state.__setitem__(
            "fields", P.build_merger_models(M200, CONC, device="cuda"))),
        ("speed_tables", lambda: state.__setitem__(
            "tables", P.build_speed_tables(state["fields"]))),
        ("radius_tables", lambda: state["tables"].__setitem__(
            "radius", P.build_radius_tables(state["fields"], R_MAX))),
        ("draws", lambda: state.__setitem__("parts", P.sample_merger_ic(
            state["fields"], state["tables"], CENTERS, VELOCITIES, R_MAX,
            N_GAS, N_DM, N_STAR, generator=gen))),
    ]


def datagen_stages():
    from cluster_generator_tpu_torch.parallel import ensemble as E

    gen = torch.Generator(device="cuda").manual_seed(DATAGEN_SEED)
    M, c = E.sample_ensemble_params(gen, DATAGEN_BATCH)
    prog = E._datagen_full_batch_fn(DATAGEN_POINTS, DATAGEN_COUNTS["dm"],
                                    DATAGEN_COUNTS["gas"],
                                    DATAGEN_COUNTS["star"])
    state = {}
    return [
        ("models", lambda: state.__setitem__("f", prog.models(M, c))),
        ("dfs", lambda: state.__setitem__("dfs", prog.dfs(state["f"]))),
        ("speed_tables", lambda: state.__setitem__(
            "tabs", prog.speed_tables(state["f"], state["dfs"]))),
        ("joint_tables", lambda: state.__setitem__(
            "dtabs", prog.draw_tables(state["f"], state["tabs"]))),
        ("draws", lambda: state.__setitem__(
            "out", prog.draws(state["f"], state["dtabs"], gen))),
    ]


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
        t[1] += (e.time_range.end - e.time_range.start) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    # the repository's own kernels, by their device time alone
    own = {n: {"launches": c, "ms": ms} for n, (c, ms) in by_name.items()
           if "invert_cdf_rows" in n}
    print(json.dumps({"path": path, "total_wall_ms": total_wall * 1e3,
                      "unprofiled_wall_ms": plain,
                      "kernel_launches": len(all_kernels),
                      "busy_ms": sum(v[1] for v in by_name.values()),
                      "own_kernels": own,
                      "top_kernels": [{"name": n[:90], "launches": c,
                                       "ms": ms} for n, (c, ms) in top],
                      "card": card}))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--path", choices=("merger", "datagen", "model", "fields",
                                       "scenes", "both"), default="both")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_merger: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = nvidia_smi_line()
    if args.path in ("merger", "both"):
        profile_path("merger", merger_stages(), card)
    if args.path in ("datagen", "both"):
        profile_path("datagen", datagen_stages(), card)
    if args.path == "model":
        profile_path("model", model_stages(), card)
    if args.path == "fields":
        profile_path("fields", fields_stages(), card)
    if args.path == "scenes":
        profile_path("scenes", scenes_stages(), card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
