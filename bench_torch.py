#!/usr/bin/env python
"""Headline benchmark of the PyTorch/CUDA port: the 1e7-particle
three-component binary-merger IC on one card.

The workload of ``bench.py``: two halos (M200 1.5e15 / 1.0e15 Msun, c 4 / 5,
centers at -/+1500 kpc, bulk velocities +0.3 / -0.45 kpc/Myr, r_max 5000
kpc), 5e6 gas + 4e6 DM + 1e6 star particles, through
``pipeline.merger_ic_fused``: both equilibrium models, their DFs, the speed
and radius tables and every draw with the merger's gas mixing.

    python bench_torch.py                  # on the card
    python bench_torch.py --device cpu     # on the CPU
    BENCH_SMOKE=1 python bench_torch.py    # counts divided by 100

One first run, then three warm runs; run k draws from a ``torch.Generator``
on the device seeded with k.  On the card ``merger_ic_fused`` is a CUDA
graph: the first run runs eagerly and captures it, the warm runs replay it
(``"program": "cuda_graph"``; on the CPU ``"eager"``).  A run ends when a
small checksum of its output reaches the host, which waits for the
device.  The first run builds
the CUDA kernel into ``build/kernels/`` when that cache is empty, so
``first_run_s`` then includes the ``nvcc`` build.  Without a card and
without ``--device cpu`` the script raises the device error: it never
falls back to the CPU.

Prints ONE JSON line on stdout (progress goes to stderr):
  {"metric", "value" (median warm seconds), "unit": "s",
   "vs_baseline" (5 s / value; > 1 is faster than the limit), "aot": false,
   "first_run_s", "backend", "device", "program", "peak_mem_gib",
   "k1_launches"}
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch

METRIC = "binary_merger_ic_1e7_particles_wall_time"
BASELINE_S = 5.0   # BASELINE.md's wall-time limit for this workload
WARM_TRIALS = 3

M200 = (1.5e15, 1.0e15)
CONC = (4.0, 5.0)
CENTERS = ((-1500.0, 0.0, 0.0), (1500.0, 0.0, 0.0))
VELOCITIES = ((0.3, 0.0, 0.0), (-0.45, 0.0, 0.0))
R_MAX = (5000.0, 5000.0)
N_GAS = (3_000_000, 2_000_000)     # per halo, prorated by mass
N_DM = (2_400_000, 1_600_000)
N_STAR = (600_000, 400_000)


def counts(smoke: bool):
    """Per-halo (gas, DM, star) counts; ``smoke`` divides them by 100."""
    div = 100 if smoke else 1
    return tuple(tuple(n // div for n in t) for t in (N_GAS, N_DM, N_STAR))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from cluster_generator_tpu_torch.core.device import resolve_device
    from cluster_generator_tpu_torch.ops import cdf_inverse as K
    from cluster_generator_tpu_torch.pipeline import merger_ic_fused

    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    n_gas, n_dm, n_star = counts(os.environ.get("BENCH_SMOKE") == "1")

    def run(seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        parts, _ = merger_ic_fused(M200, CONC, CENTERS, VELOCITIES, R_MAX,
                                   n_gas, n_dm, n_star, generator=gen,
                                   device=dev)
        # the host sync: a small checksum copied to the host
        return float(parts["dm", "particle_velocity"][::4096].sum()
                     + parts["gas", "thermal_energy"][::4096].sum())

    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    launches = K.invert_cdf_rows.launches
    t0 = time.perf_counter()
    checksum = run(0)
    first_s = time.perf_counter() - t0
    print(f"# first run (kernel build included when not cached): "
          f"{first_s:.3f} s checksum={checksum:.6g}", file=sys.stderr)
    times = []
    for trial in range(WARM_TRIALS):
        t0 = time.perf_counter()
        run(trial + 1)
        times.append(time.perf_counter() - t0)
        print(f"# warm trial {trial}: {times[-1]:.4f} s", file=sys.stderr)
    value = statistics.median(times)
    print(json.dumps({
        "metric": METRIC,
        "value": value,
        "unit": "s",
        "vs_baseline": BASELINE_S / value,
        "aot": False,
        "first_run_s": first_s,
        "backend": dev.type,
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "program": "cuda_graph" if cuda else "eager",
        "peak_mem_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                         if cuda else None),
        "k1_launches": K.invert_cdf_rows.launches - launches,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
