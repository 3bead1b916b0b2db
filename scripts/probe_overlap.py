#!/usr/bin/env python3
"""Does a catalog stream's copy to pinned host memory hide behind compute?

Runs ``chip_smoke.py``'s catalog stream (``--path catalog``: cfg5c, 1024
clusters in batches of 256) or merger catalog stream (``--path merger``:
cfg6, 256 scenes in batches of 64) on one NVIDIA card, three ways per turn:
the batch programs alone, the stream with the staging's copies taken out
(``chip_smoke.no_copy_ring``) and the stream itself, the last two in
alternating order, for seven turns.  Prints every turn's seconds per batch
and the median of each turn's difference (what the copies cost).  Then
profiles one stream of each kind and prints, for each batch's group of
device-to-host copies into pinned memory, its start, its length and how
long kernels ran on the card meanwhile.

    python3 scripts/probe_overlap.py [--path catalog|merger]

Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as S  # noqa: E402


def streams(path):
    """``(programs alone, stream, number of batches)`` of one path."""
    from cluster_generator_tpu_torch.parallel import ensemble as E
    from cluster_generator_tpu_torch.parallel import mergers as MG

    dev = torch.device("cuda")
    if path == "catalog":
        M, c = E.sample_ensemble_params(
            torch.Generator(device="cuda").manual_seed(S.CATALOG_SEED),
            S.CATALOG_CLUSTERS)
        _, _, prog = E._resolve_batch_fn(dict(S.DATAGEN_COUNTS),
                                         S.DATAGEN_POINTS)
        batch = S.DATAGEN_BATCH
        b0s = list(range(0, S.CATALOG_CLUSTERS, batch))

        def programs():
            for b0 in b0s:
                prog(M[b0:b0 + batch], c[b0:b0 + batch],
                     E._batch_generator(S.CATALOG_SEED, b0, dev))

        def stream():
            for _ in E._catalog_batches(M, c, prog, batch, S.CATALOG_SEED,
                                        b0s):
                pass

        return programs, stream, len(b0s)
    p = S.scene_params(MG, S.SCENES)
    M, c, ctr, vel = MG._scene_inputs(p, dev)
    counts = MG._normalize_counts(S.SCENE_COUNTS, 2)
    prog = MG._merger_batch_fn(S.SCENE_POINTS, counts["gas"], counts["dm"],
                               counts["star"])
    r_max = torch.full((2,), S.R_MAX, dtype=torch.float64, device=dev)
    batch = S.SCENE_BATCH
    b0s = list(range(0, S.SCENES, batch))

    def programs():
        for b0 in b0s:
            sl = slice(b0, b0 + batch)
            prog(M[sl], c[sl], ctr[sl], vel[sl], r_max,
                 MG._batch_generator(S.SCENE_SEED, b0, dev))

    def stream():
        for _ in MG._scene_batches(prog, M, c, ctr, vel, r_max, batch,
                                   S.SCENE_SEED, b0s):
            pass

    return programs, stream, len(b0s)


def copy_groups(fn):
    """``fn`` once under the profiler: each group of device-to-host copies
    into pinned memory with the kernel time inside it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    t0 = min(e.time_range.start for e in ev)
    union = []
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in ev
                       if "Memcpy" not in e.name and "Memset" not in e.name):
        if union and a <= union[-1][1]:
            union[-1][1] = max(union[-1][1], b)
        else:
            union.append([a, b])
    groups = []
    for e in sorted((e for e in ev if "DtoH" in e.name
                     and "Pinned" in e.name),
                    key=lambda e: e.time_range.start):
        a, b = e.time_range.start, e.time_range.end
        if groups and a - groups[-1][1] < 2000:  # us: one batch's copies
            groups[-1][1] = max(groups[-1][1], b)
        else:
            groups.append([a, b])
    return {"device_span_ms": (max(b for _, b in union) - t0) / 1e3,
            "kernel_busy_ms": sum(b - a for a, b in union) / 1e3,
            "copy_groups": [{"start_ms": (a - t0) / 1e3, "ms": (b - a) / 1e3,
                             "kernels_during_ms": sum(
                                 max(0, min(b, y) - max(a, x))
                                 for x, y in union) / 1e3}
                            for a, b in groups]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--path", choices=("catalog", "merger"),
                    default="catalog")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_overlap: no CUDA device", file=sys.stderr)
        return 1
    from cluster_generator_tpu_torch.core import staging

    card = S.nvidia_smi_line()
    programs, stream, n = streams(args.path)
    plain, dry = staging._Ring, S.no_copy_ring()

    def copy_free():
        staging._Ring = dry
        try:
            stream()
        finally:
            staging._Ring = plain

    def per_batch(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n

    for fn in (programs, stream, copy_free):
        fn()
    turns = []
    for turn in range(7):
        alone = per_batch(programs)
        if turn % 2:
            wall, free = per_batch(stream), per_batch(copy_free)
        else:
            free = per_batch(copy_free)
            wall = per_batch(stream)
        turns.append({"programs": alone, "copy_free": free,
                      "overlapped": wall})
    cost = statistics.median(t["overlapped"] - t["copy_free"] for t in turns)
    print(json.dumps({"path": args.path, "turns_s_per_batch": turns,
                      "median_copy_cost_ms": cost * 1e3, "card": card}))
    for name, fn in (("overlapped", stream), ("copy_free", copy_free)):
        print(json.dumps({"path": args.path, "run": name,
                          **copy_groups(fn), "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
