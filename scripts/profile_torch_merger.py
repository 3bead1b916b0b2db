#!/usr/bin/env python3
"""Where the time of the port's two main paths goes, on one NVIDIA card.

``--path merger``: the four stages of ``cluster_generator_tpu_torch.pipeline``
at the full 1e7-particle binary-merger workload of ``chip_smoke.py``.
``--path datagen``: the five stages of one ensemble datagen batch
(``parallel.ensemble._datagen_full_batch_fn``) at ``chip_smoke.py``'s full
width, 256 clusters of 1e5 particles on a 512-point grid.  Each path runs
warm, under ``torch.profiler``, one stage at a time, and prints for each
stage one JSON line: host wall time, number of kernel launches, device busy
time (union of kernel intervals) and busy share.  Then it prints the
repository's own kernels and the ten that took the most device time over
the whole path.  The default runs both paths.

    python3 scripts/profile_torch_merger.py [--path merger|datagen|both]

Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (CENTERS, CONC, DATAGEN_BATCH,  # noqa: E402
                        DATAGEN_COUNTS, DATAGEN_POINTS, DATAGEN_SEED, M200,
                        N_DM, N_GAS, N_STAR, R_MAX, VELOCITIES,
                        nvidia_smi_line)


def busy_us(events):
    """Union of the device intervals of the kernels in ``events``."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


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


def profile_path(path, stages, card):
    for _ in range(2):  # warm: kernels built, allocator pools filled
        for _, fn in stages:
            fn()
    torch.cuda.synchronize()

    all_kernels = []
    total_wall = 0.0
    for name, fn in stages:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        busy = busy_us(kern) / 1e3
        total_wall += wall
        all_kernels.extend(kern)
        print(json.dumps({"path": path, "stage": name, "wall_ms": wall * 1e3,
                          "kernel_launches": len(kern), "busy_ms": busy,
                          "busy_share": busy / (wall * 1e3), "card": card}))

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
    ap.add_argument("--path", choices=("merger", "datagen", "both"),
                    default="both")
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
