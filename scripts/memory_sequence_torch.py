#!/usr/bin/env python3
"""Every path in one process on one card, with no ``compiled.clear()``
between the steps, under a memory cap set from the sequence's own need.

The steps, each at full width and with seeds of its own:

1. ``class``: the class path at class-4096-1e7: profiles and model on a
   4096-point grid, DM 5e6 and gas 4e6 draws;
2. ``merger``: ``merger_ic_fused`` on bench2h-1e7;
3. ``datagen``: one datagen cfg5c batch of 256 clusters;
4. ``field512`` and 5. ``field1024``: the constant-rms float32 field;
6. ``joined``: steps 1 and 2 again, their particles then joined by the
   package's eager ``ClusterParticles.__add__`` (a ``torch.cat`` on the
   card beside the held programs, which make no room for it);
7. ``sharded1024``: the sharded 1024^3 field on a world of one over NCCL,
   in this process;
8. ``eager-after-sharded``: eager work only, no program call, on what the
   caller kept from steps 1 and 2: the class containers and the merger's
   particles joined :data:`JOIN_REPEATS` times by
   ``ClusterParticles.__add__`` (9.5e7 particles), the sum moved into a
   Gadget box by ``add_offsets``, and its Gadget blocks
   (``ClusterParticles.gadget_blocks``, the device half of
   ``write_to_gadget_file``);
9. ``datagen again`` and ``merger again``: steps 3 and 2 with their seeds.

The caller keeps every step's outputs, as a user's script would.

First each step runs alone on a clean card (``compiled.clear()`` before
it) under ``compiled.eager()``: its eager peak and its outputs, copied to
the host as the reference (a step that works on earlier steps' outputs
gets them from eager runs of those steps made before it).  The need
under JAX's memory model, where an executable keeps only its outputs, is
the largest over the steps of the outputs kept before the step plus the
step's eager peak; the cap is ``--margin`` (default :data:`MARGIN`)
times that need, as a fraction of the card's memory
(``torch.cuda.set_per_process_memory_fraction``), unless ``--fraction``
gives it.  Then the sequence runs under the cap: for each step one JSON
line with its wall seconds, the headroom before it (what the card can
still allocate under the cap), the peak it adds, the memory the card holds
after it beyond the outputs kept (reserved after ``empty_cache()``), the
programs it captured (and how many of them had been captured before: the
recaptures) with their capture seconds, the programs and workspaces the
package released and the calls it ran again after running out of memory
(``compiled.releases`` and ``retries``, where the package counts them),
what the package accounts as held (``compiled.held()``), and whether its
outputs equal the reference bit for bit.  A step that
runs out of memory ends the sequence; the last line names it
(``oom_step``, null when every step ran).

Run from the root of the checkout whose package is to be measured (or
with ``PYTHONPATH`` at another checkout's root):

    PYTHONPATH=. python3 scripts/memory_sequence_torch.py [--label change] \\
        [--margin 1.15 | --fraction F] [--first N]

``--first N`` runs only the first N steps (their first calls: with
``--fraction`` of the whole sequence's cap, a wall comparable between
checkouts).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
import weakref
from typing import Callable, NamedTuple

import numpy as np
import torch

GIB = 2.0 ** 30
#: the cap over the sequence's need under JAX's memory model
MARGIN = 1.15
# bench2h-1e7 (bench.py's workload)
M200, CONC = (1.5e15, 1.0e15), (4.0, 5.0)
CENTERS = ((-1500.0, 0.0, 0.0), (1500.0, 0.0, 0.0))
VELOCITIES = ((0.3, 0.0, 0.0), (-0.45, 0.0, 0.0))
R_MAX = 5000.0
N_GAS, N_DM, N_STAR = (3_000_000, 2_000_000), (2_400_000, 1_600_000), \
    (600_000, 400_000)
# datagen-cfg5c-256x1e5
DATAGEN_BATCH, DATAGEN_POINTS = 256, 512
DATAGEN_COUNTS = {"dm": 50_000, "gas": 40_000, "star": 10_000}
# class-4096-1e7: the canonical cluster
CLASS_M200, CLASS_CONC, CLASS_Z, CLASS_POINTS = 1.5e15, 4.0, 0.1, 4096
CLASS_DM, CLASS_GAS = 5_000_000, 4_000_000
# field-512 (and its 1024^3 form)
FIELD_LE, FIELD_RE = [-1000.0] * 3, [1000.0] * 3
FIELD_L, FIELD_B_RMS = (50.0, 500.0), 1.0e-6
SEED = 25
# eager-after-sharded: the join of steps 1-2's 1.9e7 particles five times
# over (9.5e7, inside the 1e6-1e9 users run) peaks near 10 GiB eagerly:
# above the ~2 GiB the parent leaves after the sharded field, and above
# that plus the class and merger programs held before the workspace, so
# that making room reaches the workspace
JOIN_REPEATS = 5
PARTICLES_PER_JOIN = CLASS_DM + CLASS_GAS + sum(N_GAS + N_DM + N_STAR)
GADGET_BOX = 14000.0   # kpc: the IC scenes' box, the sum at its centre


class Step(NamedTuple):
    """One step: ``fn(kept)`` runs it, ``kept`` the outputs of the steps
    before it by name; ``ref`` names its reference (a step run again
    shares its first run's); ``uses`` the earlier steps whose outputs it
    reads."""

    name: str
    fn: Callable
    ref: str
    uses: tuple = ()


def gen(k):
    return torch.Generator(device="cuda").manual_seed(SEED + k)


def leaves(obj):
    """The tensors of a step's output: containers, particles and models
    (their ``fields``) opened in a fixed order."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if hasattr(obj, "fields") and isinstance(obj.fields, dict):
        obj = obj.fields
    if isinstance(obj, dict):
        return [t for k in sorted(obj, key=str) for t in leaves(obj[k])]
    if isinstance(obj, (tuple, list)):
        return [t for v in obj for t in leaves(v)]
    return []


def nbytes(obj):
    """The card's bytes of ``obj`` (its host tensors hold none)."""
    return sum(t.numel() * t.element_size() for t in leaves(obj)
               if t.is_cuda)


def to_host(obj):
    return [t.detach().cpu() for t in leaves(obj)]


_INT = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def bitwise_equal(obj, host, chunk=1 << 26):
    """Whether every tensor of ``obj`` equals its host copy bit for bit
    (compared as integers of the same width, chunk by chunk)."""
    got = leaves(obj)
    if len(got) != len(host):
        return False
    for t, h in zip(got, host):
        if t.shape != h.shape or t.dtype != h.dtype:
            return False
        if not t.is_contiguous():
            t = t.cpu()
        a, b = t.reshape(-1), h.reshape(-1)
        if a.is_floating_point():
            a = a.view(_INT[a.element_size()])
            b = b.view(_INT[b.element_size()])
        for i in range(0, a.numel(), chunk):
            if not torch.equal(a[i:i + chunk].cpu(), b[i:i + chunk]):
                return False
    return True


def class_step(cg):
    r200 = cg.find_overdensity_radius(CLASS_M200, 200.0, z=CLASS_Z)
    a = r200 / CLASS_CONC
    M = cg.snfw_total_mass(CLASS_M200, r200, a)
    rhot, Mt = cg.snfw_density_profile(M, a), cg.snfw_mass_profile(M, a)
    r500, M500 = cg.find_radius_mass(Mt, z=CLASS_Z, delta=500.0)
    rhog = cg.rescale_profile_by_mass(
        cg.vikhlinin_density_profile(1.0, 100.0, r200, 1.0, 0.67, 3),
        cg.f_gas(M500) * M500, r500)
    m = cg.ClusterModel.from_dens_and_tden(
        0.1, 1e4, rhog, rhot, stellar_density=0.02 * rhot,
        num_points=CLASS_POINTS)
    dm = m.generate_dm_particles(CLASS_DM, r_max=R_MAX, prng=gen(1))
    gas = m.generate_gas_particles(CLASS_GAS, r_max=R_MAX, prng=gen(2))
    return m, dm, gas


def merger_step(P):
    return P.merger_ic_fused(M200, CONC, CENTERS, VELOCITIES, R_MAX, N_GAS,
                             N_DM, N_STAR, generator=gen(3), device="cuda")


def datagen_step(E):
    M, c = E.sample_ensemble_params(gen(4), DATAGEN_BATCH)
    (_, out), = E.datagen_batches(M, c, DATAGEN_COUNTS,
                                  batch_size=DATAGEN_BATCH,
                                  num_points=DATAGEN_POINTS, seed=SEED,
                                  device="cuda")
    return out


def field_step(F, n):
    f = F.RandomMagneticField(FIELD_LE, FIELD_RE, (n,) * 3, *FIELD_L,
                              FIELD_B_RMS, padding=0.0, prng=SEED + n,
                              dtype=torch.float32, device="cuda")
    return f.gx, f.gy, f.gz


def sharded_step(mesh, n):
    from cluster_generator_tpu_torch.parallel.fields import (
        sharded_gaussian_random_field)

    box = FIELD_RE[0] - FIELD_LE[0]
    return tuple(g.to_local() for g in sharded_gaussian_random_field(
        SEED, (n,) * 3, (box / n,) * 3, *FIELD_L, mesh, g_rms=FIELD_B_RMS))


def joined_step(cg, P):
    _, dm, gas = class_step(cg)
    parts, _ = merger_step(P)
    return dm + gas + cg.ClusterParticles(sorted({k[0] for k in parts}),
                                          parts)


def eager_step(cg, kept, repeats=JOIN_REPEATS, box=GADGET_BOX):
    """``eager-after-sharded``: the class containers and the merger's
    particles kept from steps 1 and 2 joined ``repeats`` times over, the
    sum moved to the centre of a Gadget box of side ``box``, and its
    Gadget blocks.  Returns the sum and the blocks' bytes (one host
    tensor)."""
    from cluster_generator_tpu_torch import particles

    _, dm, gas = kept["class"]
    parts, _ = kept["merger"]
    one = dm + gas + cg.ClusterParticles(sorted({k[0] for k in parts}),
                                         parts)
    total = one
    for _ in range(repeats - 1):
        total = total + one
    total.add_offsets([box / 2.0] * 3, [0.0] * 3)
    # a checkout before the public method has the module function
    blocks, _, _ = (total.gadget_blocks(box)
                    if hasattr(total, "gadget_blocks")
                    else particles._gadget_blocks(total, box))
    return total, torch.from_numpy(np.concatenate([
        np.ascontiguousarray(a).view(np.uint8).reshape(-1)
        for arrays in blocks.values() for a in arrays.values()]))


@contextlib.contextmanager
def world_of_one(store_dir):
    """A world of one over NCCL, started as a rank of a world does (a file
    store, rank 0 of 1, its card set), and its ``(ens, part)`` mesh."""
    import torch.distributed as dist

    from cluster_generator_tpu_torch.parallel.mesh import make_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method="file://" + os.path.join(
        store_dir, "store"), rank=0, world_size=1)
    try:
        yield make_mesh(1, 1, device_type="cuda")
    finally:
        dist.destroy_process_group()


def steps(mesh, field_dims=(512, 1024), sharded_dims=1024):
    """``[(name, fn, reference name)]``: the sequence."""
    import cluster_generator_tpu_torch as cg
    from cluster_generator_tpu_torch import fields as F
    from cluster_generator_tpu_torch import pipeline as P
    from cluster_generator_tpu_torch.parallel import ensemble as E

    small, big = field_dims
    sharded = f"sharded{sharded_dims}"
    return [Step("class", lambda kept: class_step(cg), "class"),
            Step("merger", lambda kept: merger_step(P), "merger"),
            Step("datagen", lambda kept: datagen_step(E), "datagen"),
            Step(f"field{small}", lambda kept: field_step(F, small),
                 f"field{small}"),
            Step(f"field{big}", lambda kept: field_step(F, big),
                 f"field{big}"),
            Step("joined", lambda kept: joined_step(cg, P), "joined"),
            Step(sharded, lambda kept: sharded_step(mesh, sharded_dims),
                 sharded),
            Step("eager-after-sharded", lambda kept: eager_step(cg, kept),
                 "eager-after-sharded", ("class", "merger")),
            Step("datagen again", lambda kept: datagen_step(E), "datagen"),
            Step("merger again", lambda kept: merger_step(P), "merger")]


def clean():
    """The memory reserved on a clean card: after ``compiled.clear()``."""
    from cluster_generator_tpu_torch.core import compiled as C

    C.clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved()


def alone(seq):
    """Each step of ``seq`` alone on a clean card, eagerly (the steps it
    uses run eagerly before it, outside its peak): ``{reference name:
    (host outputs, output bytes, eager peak bytes)}``."""
    from cluster_generator_tpu_torch.core import compiled as C

    by_name = {s.name: s for s in seq}
    refs = {}
    for step in seq:
        if step.ref in refs:
            continue
        clean()
        with C.eager():
            kept = {u: by_name[u].fn({}) for u in step.uses}
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with C.eager():
            out = step.fn(kept)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - before
        refs[step.ref] = (to_host(out), nbytes(out), peak)
        print(json.dumps({"alone": step.name, "eager_peak_gib": peak / GIB,
                          "outputs_gib": nbytes(out) / GIB}), flush=True)
        del out, kept
    clean()
    return refs


def need(seq, refs):
    """The sequence's need under JAX's memory model, in bytes: the largest
    over the steps of the outputs kept before it plus its eager peak."""
    kept, most = 0, 0
    for step in seq:
        _, out_bytes, peak = refs[step.ref]
        most = max(most, kept + peak)
        kept += out_bytes
    return most


def headroom():
    """What the card can still allocate under the process's memory
    fraction, beside the allocator's cache."""
    free, total = torch.cuda.mem_get_info()
    cap = torch.cuda.get_per_process_memory_fraction() * total
    return min(free, cap - torch.cuda.memory_reserved())


def sequence(seq, refs, report=print):
    """The steps of ``seq`` in turn, every output kept, no
    ``compiled.clear()``; one record per step (``report``-ed as it
    ends).  Returns ``(records, name of the step that ran out of memory or
    None)``."""
    from cluster_generator_tpu_torch.core import compiled as C

    base = clean()
    kept, kept_bytes, records, seen = {}, 0, [], set()
    for step in seq:
        # weak: a program held here could not be released by the package
        before_progs = weakref.WeakSet(C.programs())
        released = getattr(C, "releases", None)
        retried = getattr(C, "retries", None)
        torch.cuda.synchronize()
        room = headroom()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            out = step.fn(kept)
            torch.cuda.synchronize()
        except torch.cuda.OutOfMemoryError as e:
            report(json.dumps({"step": step.name,
                               "headroom_before_gib": room / GIB,
                               "oom": str(e).split("\n")[0]}))
            return records, step.name
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - before
        kept[step.name] = out
        kept_bytes += nbytes(out)
        torch.cuda.empty_cache()
        held = torch.cuda.memory_reserved() - base - kept_bytes
        new = [p for p in C.programs() if p not in before_progs]
        keys = [p.key for p in new]
        rec = {"step": step.name, "wall_s": wall,
               "headroom_before_gib": room / GIB,
               "peak_added_gib": peak / GIB,
               "outputs_kept_gib": kept_bytes / GIB,
               "held_after_gib": held / GIB,
               "captures": len(new),
               "recaptures": sum(k in seen for k in keys),
               "capture_s": sum(p.capture_s or 0.0 for p in new),
               "released": (None if released is None
                            else C.releases - released),
               "retries": None if retried is None else C.retries - retried,
               "accounted_gib": (sum(h.nbytes for h in C.held()) / GIB
                                 if hasattr(C, "held") else None),
               "programs_held": len(C.programs()),
               "workspaces_held": (len(C.workspaces())
                                   if hasattr(C, "workspaces") else None),
               "equal_to_alone": bitwise_equal(out, refs[step.ref][0])}
        seen.update(keys)
        records.append(rec)
        report(json.dumps(rec))
        del out, new
    return records, None


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="tree")
    ap.add_argument("--margin", type=float, default=MARGIN)
    ap.add_argument("--fraction", type=float)
    ap.add_argument("--first", type=int, help="run only the first N steps")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("memory_sequence_torch: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    total = torch.cuda.get_device_properties(0).total_memory
    with tempfile.TemporaryDirectory() as d, world_of_one(d) as mesh:
        seq = steps(mesh)[:args.first]
        refs = alone(seq)
        jax_need = need(seq, refs)
        fraction = args.fraction or min(1.0, args.margin * jax_need / total)
        print(json.dumps({"label": args.label,
                          "card_total_gib": total / GIB,
                          "jax_model_need_gib": jax_need / GIB,
                          "fraction": fraction,
                          "cap_gib": fraction * total / GIB}), flush=True)
        torch.cuda.set_per_process_memory_fraction(fraction)
        try:
            records, oom = sequence(seq, refs,
                                    lambda s: print(s, flush=True))
        finally:
            torch.cuda.set_per_process_memory_fraction(1.0)
    print(f"card: {card_line()}; torch {torch.__version__}, package "
          f"{os.path.abspath('cluster_generator_tpu_torch')}")
    eager = next((refs[s.ref] for s in seq
                  if s.ref == "eager-after-sharded"), None)
    if eager is not None:
        host, out_bytes, peak = eager
        print(json.dumps({"eager_after_sharded": {
            "particles": JOIN_REPEATS * PARTICLES_PER_JOIN,
            "sum_gib": out_bytes / GIB,
            "gadget_blocks_gib": host[-1].numel() / GIB,
            "eager_peak_gib": peak / GIB}}))
    print(json.dumps({"label": args.label, "oom_step": oom,
                      "steps_run": len(records),
                      "all_equal": all(r["equal_to_alone"]
                                       for r in records)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
