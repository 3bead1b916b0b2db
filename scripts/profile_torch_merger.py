#!/usr/bin/env python3
"""Where the time of the port's merger IC goes, on one NVIDIA card.

Runs the four stages of ``cluster_generator_tpu_torch.pipeline`` at the
full 1e7-particle binary-merger workload of ``chip_smoke.py``, warm, under
``torch.profiler``, one stage at a time, and prints for each stage one JSON
line: host wall time, number of kernel launches, device busy time (union of
kernel intervals) and busy share.  Then it prints the repository's own
kernels and the ten that took the most device time over the whole run.

    python3 scripts/profile_torch_merger.py

Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (CENTERS, CONC, M200, N_DM, N_GAS,  # noqa: E402
                        N_STAR, R_MAX, VELOCITIES)


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


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_merger: no CUDA device", file=sys.stderr)
        return 1
    from cluster_generator_tpu_torch import pipeline as P

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = {}

    stages = [
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
        print(json.dumps({"stage": name, "wall_ms": wall * 1e3,
                          "kernel_launches": len(kern), "busy_ms": busy,
                          "busy_share": busy / (wall * 1e3), "card": card}))

    by_name = {}
    for e in all_kernels:
        t = by_name.setdefault(e.name, [0, 0.0])
        t[0] += 1
        t[1] += (e.time_range.end - e.time_range.start) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    # the repository's own kernels, by their device time alone
    own = {n: {"launches": c, "ms": ms} for n, (c, ms) in by_name.items()
           if "invert_cdf_rows" in n}
    print(json.dumps({"total_wall_ms": total_wall * 1e3,
                      "kernel_launches": len(all_kernels),
                      "busy_ms": sum(v[1] for v in by_name.values()),
                      "own_kernels": own,
                      "top_kernels": [{"name": n[:90], "launches": c,
                                       "ms": ms} for n, (c, ms) in top],
                      "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
