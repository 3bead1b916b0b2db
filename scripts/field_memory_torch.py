#!/usr/bin/env python3
"""Memory and wall time of the random fields at 1024^3 float32 on one card.

Two parts, each on a clean card (``compiled.clear()`` before it):

* ``RandomMagneticField`` (the constant-rms route), called three times
  with three seeds, then once under ``compiled.eager()``;
* ``sharded_gaussian_random_field`` on a world of one (NCCL), called
  three times, the third on another box of the same grid, then once under
  ``compiled.eager()``; the caller holds the previous call's field during
  each call, as a sweep does.

For each call one JSON line: wall seconds, the peak the call adds to the
memory allocated before it, and the memory the card holds after it beyond
the fields (the one returned and the one the caller holds), counted from
the part's clean start: reserved after ``torch.cuda.empty_cache()``, so
a CUDA graph's pool and static buffers and a workspace count.  A package
without ``compiled.eager`` measures its eager route four times.  Then the
card's name and power limit.

Run from the root of the checkout whose package is to be measured:

    PYTHONPATH=. python3 scripts/field_memory_torch.py [--dims 1024] \\
        [--label change] [--only field|sharded]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import socket
import subprocess
import sys
import time

import torch

LE, RE = [-1000.0] * 3, [1000.0] * 3        # kpc
L_MIN, L_MAX, B_RMS, SEED = 50.0, 500.0, 1.0e-6, 42
GIB = 2.0 ** 30


def clean():
    """The memory reserved on a clean card: after ``compiled.clear()``."""
    from cluster_generator_tpu_torch.core import compiled as C

    C.clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved()


def nbytes(tensors):
    return sum(g.numel() * g.element_size() for g in tensors)


def measure(label, fn, base, held=()):
    """``fn()`` once, with its numbers printed as one JSON line; ``base``:
    :func:`clean`'s reserved memory; ``held``: the field the caller holds
    meanwhile."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - before
    torch.cuda.empty_cache()
    kept = torch.cuda.memory_reserved() - base - nbytes(out) - nbytes(held)
    print(json.dumps({"call": label, "wall_s": wall,
                      "peak_added_gib": peak / GIB,
                      "peak_gib": torch.cuda.max_memory_allocated() / GIB,
                      "field_gib": nbytes(out) / GIB,
                      "caller_holds_gib": nbytes(held) / GIB,
                      "held_after_gib": kept / GIB}), flush=True)
    return out


def modes(compiled):
    """The calls' labels and contexts: three, then one eager."""
    eager = getattr(compiled, "eager", None)
    yield "first", contextlib.nullcontext()
    yield "second", contextlib.nullcontext()
    yield "third", contextlib.nullcontext()
    yield ("eager" if eager else "fourth"), (
        eager() if eager else contextlib.nullcontext())


def field_part(n, tag):
    from cluster_generator_tpu_torch import fields as F
    from cluster_generator_tpu_torch.core import compiled as C

    base = clean()
    for k, (label, ctx) in enumerate(modes(C)):
        with ctx:
            out = measure(f"{tag} RandomMagneticField {n}^3 {label}",
                          lambda: (lambda f: (f.gx, f.gy, f.gz))(
                              F.RandomMagneticField(
                                  LE, RE, (n,) * 3, L_MIN, L_MAX, B_RMS,
                                  padding=0.0, prng=SEED + k,
                                  dtype=torch.float32, device="cuda")),
                          base)
        del out
    C.clear()


def sharded_part(n, tag):
    import torch.distributed as dist

    from cluster_generator_tpu_torch.core import compiled as C
    from cluster_generator_tpu_torch.parallel.fields import (
        sharded_gaussian_random_field)
    from cluster_generator_tpu_torch.parallel.mesh import make_mesh

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(1, 1, device_type="cuda")
        base = clean()
        prev = ()
        for k, (label, ctx) in enumerate(modes(C)):
            box = (RE[0] - LE[0]) * (1.25 if k == 2 else 1.0)
            with ctx:
                out = measure(
                    f"{tag} sharded field {n}^3 world 1 {label} box {box}",
                    lambda: tuple(g.to_local() for g in
                                  sharded_gaussian_random_field(
                                      SEED, (n,) * 3, (box / n,) * 3, L_MIN,
                                      L_MAX, mesh, g_rms=B_RMS)),
                    base, held=prev)
            prev = out
            del out
        del prev
        C.clear()
    finally:
        dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dims", type=int, default=1024)
    ap.add_argument("--label", default="tree")
    ap.add_argument("--only", choices=("field", "sharded"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("field_memory_torch: no CUDA device", file=sys.stderr)
        return 1
    if args.only != "sharded":
        field_part(args.dims, args.label)
    if args.only != "field":
        sharded_part(args.dims, args.label)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}, "
          f"package {os.path.abspath('cluster_generator_tpu_torch')}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
