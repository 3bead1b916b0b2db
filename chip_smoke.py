#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:

1. print the card (``nvidia-smi``) and switch TF32 off;
2. build every CUDA kernel under ``cluster_generator_tpu_torch/ops/csrc``
   (one ``nvcc`` per source, all started together);
3. hold each kernel against its plain PyTorch version on the card, bit for
   bit, at the shapes the three main paths give it (merger, ensemble batch
   and single-cluster class path; DM and stars) and on rows that probe its
   bin selection, and time kernel, plain version and a library yardstick;
   the Abel kernel of the DFs within 1e-12 of each row's largest |g| (its
   own summation order), at the DF shapes of the ensemble batch, the
   merger and the class path and on edge rows, with the same bits at
   every lane count; the datagen's draw kernel (one launch a species) bit
   for bit on its isotropic and Osipkov-Merritt paths, at the batches of
   256 and 64 and on edge uniforms, timed against its byte bound and its
   plain version;
4. drive the first main path, ``merger_ic_fused``, at the full
   1e7-particle binary-merger workload: one first run and three warm runs,
   then check counts, dtypes, finiteness, bulk velocities and that the
   path launched every kernel (and not the datagen's draw kernel);
5. the same call once with Osipkov-Merritt anisotropy, tracers and
   particle potentials, at the same counts;
6. drive the second main path, ``datagen_batches``, at the ensemble
   product's defaults (batches of 256 clusters, a 512-point grid, 1e5
   particles per cluster over three species): one first batch, a stream
   of 512 clusters, one Osipkov-Merritt batch.  Every batch must launch
   K1 twice and the draw kernel three times (DM and stars, then gas),
   hold no non-finite value and pass the physics QA of the
   draws (radius, local escape speed, mass budget, gas energy, KS of the
   radii, and for the OM batch the anisotropy profile);
7. drive the third main path, the single-cluster class API
   (``ClusterModel.from_dens_and_tden`` on a 4096-point grid, the
   hydrostatic and virial checks, ``generate_*_particles`` for 1.05e7
   particles, ``VirialEquilibrium(r_a=...)``, the other constructors and
   the MOND laws), with its physics QA on the card, K1's launches (one
   per species and model, none for a second draw) and card against CPU
   for the fields, the DFs (end to end, and the DF step on the card's
   fields; the DM DF also with the profiles' floats inline) and the speed
   table;
8. build the merger's models, tables and a small draw with the same
   uniforms on the card and on the CPU and compare them;
9. the gradient of the central pressure with respect to M200 through the
   whole model build (the implicit gradient of r500 included) against a
   central difference;
10. the random fields: the 512^3 float32 divergence-free magnetic field
    (first run, three warm runs, peak memory) with its rms, divergence and
    spectrum checks, once at 1024^3 (the program's peak and the memory
    it holds after the call beside its eager body's), the vector
    potential with the curl check at 128^3;
11. a float64 radial magnetic field over the merger IC (two class-path
    models, 282^3 with padding) attached to the 5e6 gas particles of the
    1e7-particle IC and mapped onto a ``ClusterParticles``; card against
    CPU for a 64^3 field and for the trilinear sampling;
12. the fourth main path, the merger-scene batches at cfg6 (256 binary
    scenes of 1e5 particles, batches of 64, a 512-point grid): first
    batch, the warm stream, one Osipkov-Merritt batch, each with K1's
    launches (and none of the datagen's draw kernel) and the physics QA
    of the scene catalog on the card;
13. the IC scene of ``ClusterICs`` (BASELINE.md's config 4) through the
    module functions its methods call, since the machine has no ``h5py``
    for its files: bench2h-1e7's two halos as class-path models, 1.05e7
    particles pro-rated by ``halo_particle_counts``, each halo drawn by
    ``draw_halo_particles`` (K1 once per species and model), then
    ``combine_two_clusters``, ``resample_two_clusters`` with a passive
    scalar, AREPO's 128^3 background grid, the Gadget blocks for a 14000
    kpc box and the Fortran particle file of the dark matter, each step
    first and warm, with the scene's QA; card against CPU for combine and
    resample on the same particles;
14. the same with a third halo (``combine_three_clusters``,
    ``resample_three_clusters``);
15. the ensemble catalog's device stage at cfg5c (1024 clusters of
    ``sample_ensemble_params``, batches of 256, 512 points, 1e5 particles
    over three species): the batch program, the copy to pinned host memory
    on a side stream while the next batch computes, the writer's
    per-cluster split into the catalog's layout (the machine has no
    ``h5py``), first and warm, with K1's launches (2 per batch), the
    non-finite values counted on the card, compute alone, copy alone
    (GB/s) and the overlapped wall per batch, the synchronizing calls of
    one stream, the verifier's checks on one batch against models rebuilt
    at once on the card, and the particle bridge for one cluster;
16. the same for the merger catalog at cfg6 (256 binary scenes, batches of
    64), with the scene verifier's checks and ``scene_to_particles``'
    mapping;
17. the chunked grid's painter: the class-path model (4096 points, beta
    100, bulk velocity 0.3 kpc/Myr) on a 512^3 grid over a 14000 kpc box
    in 64^3 chunks, batches of 64 chunks, every field of the file f8 and
    f4 into host memory through the painter's stream (the density's three
    momentum copies scaled on the host), 16 chunks (the 8 corners, the
    centre) against the CPU, the corners against the boundary value;
    paint alone, copy alone and the overlapped stream per field;
18. the command line and the host tooling: ``cli.main(["info"])`` names
    the card and the count, a ``datagen --aot-dir`` call exits 2; the
    native (host C++) painter against the card's on the grid's density at
    512^3 in 8 batches of 64 chunks (max |diff| / max <= 1e-12, seconds per
    batch of each); ``stage`` around one warm 1e7 merger IC against CUDA
    events on the same run; ``trace`` around one datagen batch, whose
    trace names K1; ``device_memory_stats``; ``nan_guard`` raising on a
    NaN made on the card; ``validate_model_fields`` on the merger's
    models; K1 4 launches (2 per IC, 2 per batch);
19. the multi-device layer over ``torch.distributed``, its ranks started
    by ``torch.multiprocessing``: (a) a world of one on NCCL at full width
    (the sharded merger draw at bench2h-1e7's counts, bit for bit against
    ``sample_merger_ic`` with the rank's generator; the sharded random
    field at 1024^3 float32 with its rms, divergence and peak memory; a
    cfg5c mesh batch of 256 and a cfg6 mesh batch of 64 scenes, bit for
    bit against no mesh; the field's three stages and each mesh batch as
    programs, the capture call and a replay against their eager bodies,
    bit for bit, with capture seconds, pool, workspace, the memory held
    after the call, peak memory and host launches), (b) a world
    of four on gloo with every rank on
    ``cuda:0`` (the real decomposition with P = 4, the transport through
    the host: each shard of the draw bit for bit against its generator,
    the field at 256^3 against world 1, the batches gathered against
    world 1, the union of the sharded Gadget blocks against one file's),
    each also with one pencil transpose's all-to-all timed by events and
    the dry run's steps; (c) a world of four on NCCL where the machine has
    four cards, else a line saying why not.  K1 against its plain version
    on each rank's first batch; its launches per rank;
20. the entry scripts over the port: where ``h5py`` imports, the five
    ``examples_torch/`` scripts at ``CG_EXAMPLE_SCALE=1``
    (``multichip_export`` as a world of one on NCCL) with the checks of
    the CPU tests, else one line saying why not;
21. the three batch programs as captured CUDA graphs at full width
    (bench2h-1e7, the cfg5c batch of 256, the cfg6 batch of 64): for each
    the first call (eager warm-up, then the capture) and three replays
    with parameters and seeds of their own against the eager body, bit
    for bit, K1 twice per call; the merger again at a second ``z`` (an
    input: the same program replays); every
    batch of a stream with a remainder batch (``datagen_batches``,
    ``merger_scene_batches``) and of the catalogs' ``stream_to_host``
    stage against its eager body after the later batches replayed; no
    sync and no release in a warm call;
22. the class path and the staged merger path as captured programs (the
    bisection, the builders, the DFs, the speed tables with K1 inside,
    the four merger stages): the class set-up (profiles, the model at
    4096 points, both DFs, both speed tables), the Osipkov-Merritt DF and
    table, the QUMOND and EMOND models and bench2h-1e7's four stages, each
    first (captures) and three warm calls with parameters of their own
    against the eager bodies (``compiled.eager()``) bit for bit, K1
    counted from inside the programs, no sync in a warm program call,
    eager and graph warm wall, capture seconds, host launches, pool
    growth; a changed MOND ``a0`` after a QUMOND capture (a new program,
    a moved result equal to the eager body); a ``z`` sweep of four values
    of ``merger_ic_fused`` (one program); phase 9's gradient again, with
    the eager calls it made;
23. the class path's particle draws and the IC scene's gas mixing as
    captured programs (the draw tables, K1 inside the collisionless ones,
    the draws, the mixing of combine and resample): at class-4096-1e7
    each species (gas, tracers, DM with potentials, stars, Osipkov-Merritt
    DM) on a fresh model and again with its tables held, and the two- and
    three-halo IC scenes at 1.05e7 particles (draws and combine on fresh
    models, combine alone, resample with a passive scalar), each first
    (captures) and three warm calls on models of other masses and
    concentrations against the eager bodies bit for bit, K1 counted from
    inside the draw-table program (1 per species and fresh model, 0 on
    held tables), no sync under a program call (the syncs left outside
    named: ``halo_generators``' seeds, ``generate_particle_radii``'s
    reads), eager and graph warm wall,
    capture seconds, host launches, pool growth and static bytes, the
    host launches of combine's eager part, and phases 7 and 13's QA on
    the first call's particles;
24. the last programs: the 512^3 float32 magnetic field and its vector
    potential, the 282^3 float64 radial field over the merger, its
    sampling at bench2h-1e7's 5e6 gas particles, and one painter batch of
    64 chunks of 64^3, f8 and f4: each first (the capture) and three warm
    calls with seeds, positions or chunks of their own against the eager
    bodies bit for bit, capture seconds, host launches per warm call,
    pool growth, static bytes, eager and graph warm wall and the peak
    memory a warm call adds; then phase 19's mesh batches and sharded
    field per rank again, each against its eager body;
25. every path in one process with no ``compiled.clear()`` between its
    steps (``scripts/memory_sequence_torch.py``: the class path at
    class-4096-1e7, the merger, a datagen batch, the 512^3 and 1024^3
    fields, the class path and the merger again with their particles
    joined eagerly, the sharded 1024^3 field on a world of one over NCCL,
    ``eager-after-sharded`` (eager only: the particles of the first two
    steps joined five times over, 9.5e7, moved into a Gadget box and made
    into Gadget blocks), the datagen batch and the merger again, every
    output kept) under a memory fraction of 1.15 times the sequence's
    need under JAX's memory model (outputs kept plus a step's eager
    peak): every step runs and equals its run alone on a clean card bit
    for bit; per step the headroom before it, the programs released and
    recaptured and the memory held after it; the eager step releases the
    sharded field's workspace, reruns nothing and launches no K1 (its
    particles, sizes, eager peak and headroom printed); warm calls after
    it release nothing;
26. print one JSON line of kernel numbers;
27. print the card's name and power limit, then the last line
    ``{"ok": true, "device": {...}}``.

Phases 4-7, 10-18 and 20 run the programs as a user does: on the card
each batch program, each function of the class path and the merger
stages, each draw's tables and draw, the gas mixing, each random field,
the trilinear sampling and each painter batch is a CUDA graph, captured
at its first call and replayed after
(``cluster_generator_tpu_torch/core/compiled.py``); in phase 19 so are
each rank's mesh batches, its sharded draw and the sharded field's
stages.  Nothing is dropped between phases to free memory: a program or
workspace that does not fit releases the least recently used ones
(phase 25, and each warm call of phases 21-24 checks that it released
none).  The memoized programs are dropped before phase 19, whose ranks
are other processes on the card, at the start of phases 21-24 and each
IC scene of phase 23, whose first calls are captures (measured in phases
22-24), and before phase 10's 1024^3 field, whose held memory is
measured.

It needs ``torch`` with CUDA and ``nvcc``; it imports no JAX.  Without a
card, or without the package beside it, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

from portbench.yardstick import kernels as yard_kernels
from portbench.yardstick import peaks as yard_peaks
from portbench.yardstick import trace as yard_trace

# H100 SXM published peaks (NVIDIA data sheet), for the kernels' bounds:
# the memory rate from the benchmark's table of peaks
HBM_BYTES_PER_S = yard_peaks.PEAKS["NVIDIA H100 80GB HBM3"]["hbm_bytes_per_s"]
FP32_OPS_PER_S = 67e12
FP64_OPS_PER_S = 34e12

# bench.py's workload: two halos, 1e7 particles in all
M200 = (1.5e15, 1.0e15)
CONC = (4.0, 5.0)
CENTERS = ((-1500.0, 0.0, 0.0), (1500.0, 0.0, 0.0))
VELOCITIES = ((0.3, 0.0, 0.0), (-0.45, 0.0, 0.0))
R_MAX = 5000.0
N_GAS = (3_000_000, 2_000_000)
N_DM = (2_400_000, 1_600_000)
N_STAR = (600_000, 400_000)

# the ensemble datagen product at its defaults, full-species counts
DATAGEN_BATCH = 256
DATAGEN_POINTS = 512
DATAGEN_CLUSTERS = 512
DATAGEN_COUNTS = {"dm": 50_000, "gas": 40_000, "star": 10_000}
DATAGEN_SEED = 11
DATAGEN_OM_BATCH = 256   # clusters of the Osipkov-Merritt batch
DATAGEN_R_A = 1000.0     # its anisotropy radius, kpc

# the merger once more with every switch on
MERGER_R_A = 1500.0
N_TRACER = (300_000, 200_000)

# the single-cluster class path: the canonical cluster on a 4096-point grid
CLASS_M200, CLASS_CONC, CLASS_Z = 1.5e15, 4.0, 0.1
CLASS_POINTS = 4096
CLASS_COUNTS = {"gas": 4_000_000, "dm": 5_000_000, "star": 1_000_000,
                "tracer": 500_000}
CLASS_OM_COUNT = 1_000_000
CLASS_R_A = 1500.0
CLASS_OTHER_POINTS = 1000   # the other constructors and the MOND laws
CLASS_RESIDUAL = 1e-4       # hydrostatic and virial residuals
CLASS_SPEED_TOL = 5e-5      # speed over the local escape speed, less 1
CLASS_MASS_RTOL = 1e-6
CLASS_KS_MAX = 0.005
CLASS_FIELD_RTOL = 1e-12    # float64 fields of the class model, card vs CPU
# DFs, card vs CPU.  The DF step on the same fields (the CPU's DF of the
# card's fields) reads 1.3e-12 (DM) and 1.7e-12 (stars).  End to end, f(E)
# at the innermost knot is the end-knot derivative of a spline of an Abel
# sum, which turns the fields' ulps (~5e-15) into 1.6e-8 with the profiles'
# floats on the host and 7.2e-8 (both DFs) with them lifted to 0-d tensor
# inputs of the programs; the bound is about twice that reading
CLASS_DF_RTOL = 1.5e-7
CLASS_DF_STEP_RTOL = 1e-11

# the gradient check: tests/test_autodiff.py's case
GRAD_M200, GRAD_CONC, GRAD_EPS, GRAD_RTOL = 1.5e15, 4.0, 1.0e10, 1e-3

# the random fields: benchmarks/bench_configs.py's 512^3 magnetic field
FIELD_LE, FIELD_RE = [-1000.0] * 3, [1000.0] * 3    # kpc
FIELD_DIMS, FIELD_BIG_DIMS, CURL_DIMS = 512, 1024, 128
FIELD_L = (50.0, 500.0)     # l_min, l_max, kpc
FIELD_B_RMS = 1.0e-6        # gauss
FIELD_SEED = 42
# float32 field: the rms comes out of float32 inverse transforms whose
# roundoff is ~1e-7 per value
FIELD_RMS_RTOL = 1e-5
# central-difference divergence over |g| / dx: float32 roundoff of the
# field values and transforms (the float64 field reaches ~1e-16)
FIELD_DIV_TOL = 1e-4
# the radial field over the merger IC (two class-path models)
RADIAL_LE, RADIAL_RE = [-4000.0] * 3, [4000.0] * 3
RADIAL_DIMS, RADIAL_CPU_DIMS = 256, 64  # 282^3 and 72^3 with padding 0.1
RADIAL_L = (100.0, 1000.0)
RADIAL_BETA = 100.0
RADIAL_CPU_RTOL = 1e-10     # float64 fields, card vs CPU, of max |g|
TRILINEAR_POINTS = 100_000
TRILINEAR_TOL = 1e-5        # float32 sampling, card vs CPU, of max |g|

# the merger-scene batches: benchmarks/bench_configs.py's cfg6
SCENES, SCENE_BATCH, SCENE_POINTS = 256, 64, 512
SCENE_COUNTS = {"gas": (20_000, 20_000), "dm": (25_000, 25_000),
                "star": (5_000, 5_000)}
SCENE_SEED = 7
SCENE_R_A = 1500.0          # kpc, the Osipkov-Merritt batch

# the IC scene: BASELINE.md's config (4), ClusterICs over bench2h-1e7's halos
IC_CENTER, IC_D, IC_B = [7000.0] * 3, 3000.0, 500.0
IC_TOTALS = {"gas": 5_000_000, "dm": 4_000_000, "star": 1_000_000,
             "tracer": 500_000}
IC_BOX, AREPO_NX = 14000.0, 128
THIRD_HALO = (5e14, 6.0)                # M200, c of the three-halo scene
THIRD_CENTER = (7000.0, 9000.0, 7000.0)
THIRD_VELOCITY = (0.0, -0.25, 0.0)
IC_QA_POINTS = 10_000       # gas densities recomputed in float64 by scipy
IC_DENSITY_RTOL = 1e-10
IC_SIGMAS = 5.0             # bulk velocity per halo block, standard errors
IC_CPU_COUNTS = {"dm": 60_000, "gas": 100_000, "star": 20_000,
                 "tracer": 10_000}
IC_CPU_RTOL = 1e-12         # max |card - CPU| / max |CPU| per field

# the streamed products: the ensemble catalog at cfg5c (DATAGEN_BATCH,
# DATAGEN_POINTS, DATAGEN_COUNTS), the merger catalog at cfg6 (the scene
# constants above) and the chunked grid over the class-path model
CATALOG_CLUSTERS = 1024
CATALOG_SEED = 0
GRID_DIMS, GRID_CHUNK, GRID_BATCH = 512, 64, 64
GRID_BOX = 14000.0                      # kpc, centred on the cluster
GRID_BETA = 100.0
GRID_VELOCITY = (0.3, 0.0, 0.0)         # kpc/Myr
GRID_FIELDS = ("density", "dark_matter_density", "stellar_density",
               "pressure", "magnetic_pressure")
GRID_F8_TOL = 1e-12                     # card vs CPU, of each field's max
GRID_F4_RTOL = 2.0 ** -23               # float32 rounding

# the command line and the host tooling: the native painter against the
# card's on grid-512-class's density (512^3, 64^3 chunks, 8 batches of 64)
NATIVE_TOL = 1e-12                      # max |native - card| / max |card|
STAGE_TOL = (0.05, 0.002)               # |stage - events| <= 5% + 2 ms
K1_KERNEL = "invert_cdf_rows_kernel"    # K1's name in a profiler trace

IN_PROGRAM = " (in a program call)"   # see count_syncs
K1_TOL = 0.0        # kernel vs plain version: bit-identical
# the Abel kernel vs its plain version, over each row's largest |g|: the
# same float64 terms summed in another order
ABEL_RTOL = 1e-12
FIELD_RTOL = 1e-9   # float64 model fields, card vs CPU
DF_RTOL = 1e-6      # DFs: the spline derivative amplifies roundoff
TABLE_TOL = 5e-6    # float32 tables, card vs CPU


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def sync():
    torch.cuda.synchronize()


def cuda_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` back-to-back calls, after
    one warm-up call, by CUDA events."""
    fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


def kernel_profile(fn):
    """``fn`` once under ``torch.profiler``: ``(wall ms, the device's
    events (kernels, copies, fills) as ``portbench.yardstick.trace.Event``,
    device busy ms)``.  The profiler slows the host, so the busy share it
    gives is a lower bound of the unprofiled one."""
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    kern = [e for e in yard_trace.events_of(prof)
            if e.kind in yard_trace.DEVICE_KINDS]
    busy = yard_trace.busy_us(kern, yard_trace.extent(kern))
    return wall * 1e3, kern, busy / 1e3


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0].strip()


# ------------------------------------------------------------------ phase 3
def random_cdf(n_rows, n_s, gen, device):
    pdf = torch.rand((n_rows, n_s - 1), generator=gen, dtype=torch.float64,
                     device=device) + 0.05
    cdf = torch.cat([torch.zeros((n_rows, 1), dtype=torch.float64,
                                 device=device), torch.cumsum(pdf, -1)], -1)
    return (cdf / cdf[:, -1:]).to(torch.float32).contiguous()


def searchsorted_lerp(cdf, n_q):
    """The yardstick: torch.searchsorted plus a lerp, same function as K1."""
    n_rows, n_s = cdf.shape
    ds = 1.0 / (n_s - 1)
    q = (torch.arange(n_q, dtype=torch.float32, device=cdf.device)
         * (1.0 / (n_q - 1))).expand(n_rows, n_q).contiguous()
    k = torch.clamp(torch.searchsorted(cdf, q, right=True) - 1, 0, n_s - 2)
    c_lo = torch.gather(cdf, 1, k)
    c_hi = torch.gather(cdf, 1, k + 1)
    return (k.to(torch.float32) * ds
            + (q - c_lo) / torch.clamp_min(c_hi - c_lo, 1e-30) * ds)


def k1_bound_ms(n_rows, n_s, n_q):
    """Least time for the same work: each input byte read once and each
    output byte written once at the HBM rate, or the search compares plus
    the lerp's ~8 float32 operations per output at the FP32 peak."""
    nbytes = yard_kernels.k1_bytes(n_rows, n_s, n_q)
    ops = n_rows * n_q * (math.ceil(math.log2(n_s)) + 8)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def class_cdf_cases(V, model):
    """K1's inputs on the class path: the float32 CDF rows that
    ``VirialEquilibrium._speed_table`` inverts, for the model's DM and
    stars and for its Osipkov-Merritt DM."""
    cases = []
    for name, vir in (("class_dm", model.dm_virial),
                      ("class_star", model.star_virial),
                      ("class_dm_om", V.VirialEquilibrium(model,
                                                          r_a=CLASS_R_A))):
        kw = vir._speed_table_inputs()
        n_q = kw.pop("n_q")
        cdf = V.speed_cdf_rows(**kw)
        cases.append((name, cdf.to(torch.float32).contiguous(), n_q))
    return cases


def table_path_inputs(P, E):
    """Arguments of ``virial.speed_inverse_cdf_table`` on three main paths,
    built by the port on the card: ``{path: {species: kwargs}}`` for the
    merger (two halos), the scene batch (64 scenes of two halos) and the
    ensemble batch (256 clusters)."""
    from cluster_generator_tpu_torch.parallel import mergers as MG

    fields = P.build_merger_models(M200, CONC, device="cuda")
    inputs = {"merger": P.speed_table_inputs(fields)}
    prog = MG._merger_batch_fn(SCENE_POINTS, *SCENE_COUNTS.values())
    p = scene_params(MG, SCENE_BATCH)
    inputs["scenes"] = P.speed_table_inputs(prog.models(p["M200"],
                                                        p["conc"]))
    prog = E._datagen_full_batch_fn(DATAGEN_POINTS, 1, 0, 1)
    M, c = E.sample_ensemble_params(
        torch.Generator(device="cuda").manual_seed(DATAGEN_SEED),
        DATAGEN_BATCH)
    f = prog.models(M, c)
    inputs["datagen"] = prog.speed_table_inputs(f, prog.dfs(f))
    return inputs


def k1_path_cases(P, V, E):
    """K1's inputs on the four main paths, built by the port on the card:
    ``[(name, float32 CDF rows, n_q), ...]`` for the merger's DM and star
    tables (two halos), the ensemble batch's (256 clusters), the class
    path's (one cluster on a 4096-point grid, 256 rows per species) and
    the scene batch's (64 scenes of two halos)."""
    import cluster_generator_tpu_torch as cg

    cases = class_cdf_cases(V, build_class_model(cg))
    for path, per_species in table_path_inputs(P, E).items():
        for kind, kw in per_species.items():
            n_q = kw.pop("n_q")
            cdf = V.speed_cdf_rows(**kw)
            cdf = cdf.to(torch.float32).reshape(-1, cdf.shape[-1])
            cases.append((f"{path}_{kind}", cdf.contiguous(), n_q))
    return cases


def k1_edge_cases(dev):
    """Rows that probe the bin selection: ragged row counts, widths that
    are no multiple of 4, exact ties q_m == c_k, flat runs, a first value
    above 0, and a row wider than the default 48 KB of shared memory."""
    gen = torch.Generator(device=dev).manual_seed(17)
    cases = [("ragged_17x256", random_cdf(17, 256, gen, dev), 128),
             ("ragged_17x1024", random_cdf(17, 1024, gen, dev), 512),
             ("unaligned_5x255", random_cdf(5, 255, gen, dev), 101),
             ("wide_3x8192", random_cdf(3, 8192, gen, dev), 4096)]
    ident = torch.linspace(0.0, 1.0, 64, device=dev).expand(3, 64)
    cases.append(("identity", ident.contiguous(), 33))
    flat = torch.tensor([[0.0, 0.2, 0.2, 0.2, 0.5, 0.5, 1.0, 1.0]],
                        device=dev)
    cases.append(("flat_bins", flat, 15))
    # every quantile sits exactly on a CDF value: c_k = k * float32(1/64)
    step = torch.tensor(1.0 / 64, dtype=torch.float32, device=dev)
    ties = (torch.arange(65, dtype=torch.float32, device=dev)
            * step)[None, :].contiguous()
    cases.append(("ties_all", ties, 65))
    cases.append(("ties_every_other", ties, 33))
    # first value above 0: the quantiles below it belong to no bin
    lifted = 0.25 + 0.75 * random_cdf(6, 256, gen, dev)
    cases.append(("first_above_zero", lifted.contiguous(), 128))
    # long runs of equal values (a pdf that is zero over stretches)
    pdf = (torch.rand((9, 255), generator=gen, device=dev)
           * (torch.rand((9, 255), generator=gen, device=dev) > 0.6))
    pdf[:, 0] += 1e-3
    runs = torch.cat([torch.zeros((9, 1), device=dev),
                      torch.cumsum(pdf.double(), -1).float()], -1)
    cases.append(("flat_runs", (runs / runs[:, -1:]).contiguous(), 200))
    return cases


def check_k1(P, K, V, E):
    """K1 against its plain version on the card, bit for bit, at the
    main-path shapes and the edge rows; returns ``(timing rows of the path
    shapes by name, largest |kernel - plain| over everything checked)``."""
    dev = torch.device("cuda")
    path_cases = k1_path_cases(P, V, E)
    errs = {}
    for name, cdf, n_q in path_cases + k1_edge_cases(dev):
        got = K.invert_cdf_rows(cdf, n_q)
        want = K.invert_cdf_rows_plain(cdf, n_q)
        sync()
        check(got.shape == (cdf.shape[0], n_q) and got.dtype == torch.float32,
              f"K1 {name}: shape {tuple(got.shape)} dtype {got.dtype}")
        check(bool(torch.isfinite(got).all()), f"K1 {name}: non-finite")
        err = errs[name] = float((got - want).abs().max())
        print(f"K1 {name}: {tuple(cdf.shape)} -> {n_q}  max|kernel - plain| "
              f"= {err:.3e}")
        check(err <= K1_TOL, f"K1 {name}: max |kernel - plain| {err} "
              f"> {K1_TOL}")
        if name == "identity":
            q = torch.linspace(0.0, 1.0, n_q, device=dev)
            ierr = float((got - q).abs().max())
            check(ierr < 1e-6, f"K1 identity row off by {ierr}")
        if name == "flat_bins":
            # q = 1 lands in the right-closed last bin, at s_{n_s-2}
            top = float(torch.tensor(6.0) * torch.tensor(1.0 / 7.0))
            check(float(got[0, -1]) == top,
                  f"K1 q=1 gave {float(got[0, -1])}, want {top}")
        if name == "first_above_zero":
            below = (torch.arange(n_q, device=dev) * (1.0 / (n_q - 1))
                     < cdf[:, :1] - 1e-6)
            check(bool((got[below] == 0).all()),
                  "K1: quantiles below the first CDF value must give 0")
    del got, want
    rows = {}
    for name, cdf, n_q in path_cases:
        lib = searchsorted_lerp(cdf, n_q)
        want = K.invert_cdf_rows_plain(cdf, n_q)
        lerr = float((lib - want).abs().max())
        del lib, want
        # the ensemble shapes (128 and 32 MiB in and out) do not stay in the
        # 50 MB L2 between launches; the merger shapes (<= 2 MiB) do
        big = cdf.shape[0] > 4096
        ms = cuda_ms(lambda: K.invert_cdf_rows(cdf, n_q), 200)
        plain_ms = cuda_ms(lambda: K.invert_cdf_rows_plain(cdf, n_q),
                           1 if big else 5)
        lib_ms = cuda_ms(lambda: searchsorted_lerp(cdf, n_q),
                         20 if big else 200)
        bound, bound_by = k1_bound_ms(cdf.shape[0], cdf.shape[1], n_q)
        print(f"K1 {name}: kernel {ms:.4f} ms ({ms / bound:.1f}x bound), "
              f"plain {plain_ms:.4f} ms, searchsorted+lerp {lib_ms:.4f} ms "
              f"(max|lib - plain| {lerr:.1e}), bound {bound:.5f} ms "
              f"({bound_by})")
        rows[name] = {"path_shape": name,
                      "shape": f"{cdf.shape[0]}x{cdf.shape[1]}->{n_q}",
                      "max_abs_err": errs[name], "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": bound,
                      "bound_by": bound_by, "library_ms": lib_ms}
    return rows, max(errs.values())


def speed_cdf_path_cases(P, V, E):
    """The speed-CDF kernel's arguments on the merger, scene-batch and
    ensemble-batch paths, recorded from the port's own
    ``virial.speed_cdf_rows`` calls on the card: ``[(name, args), ...]``."""
    real, seen, cases = V.speed_cdf_rows_f32, [], []

    def record(*args):
        seen.append(args)
        return real(*args)

    V.speed_cdf_rows_f32 = record
    try:
        for path, per_species in table_path_inputs(P, E).items():
            for kind, kw in per_species.items():
                kw.pop("n_q")
                V.speed_cdf_rows(**kw)
                cases.append((f"{path}_{kind}", seen.pop()))
    finally:
        V.speed_cdf_rows_f32 = real
    return cases


def speed_cdf_edge_cases(dev):
    """Arguments that probe the speed-CDF kernel's edges: a row at each
    halo's e_max and one whose s = 0 query sits on the segment boundary b,
    a halo whose f_E is all zero, one halo, no leading axis, widths that
    are no multiple of 32, and rows of 8192 (above the default 48 KB of
    shared memory)."""
    gen = torch.Generator(device=dev).manual_seed(23)

    def case(halos, rows, n_s, nf1=4096, nf2=4096, zero=None, lead=None):
        e_top = 1e-2 + 1e2 * torch.rand(halos, generator=gen,
                                         dtype=torch.float64, device=dev)
        row_ee = (0.01 + 0.98 * torch.rand((halos, rows), generator=gen,
                                           dtype=torch.float64, device=dev)
                  ) * e_top[:, None]
        row_ee[:, -1] = e_top
        row_ee[:, 0] = 0.9 * e_top
        fu = torch.rand((halos, nf1 + nf2), generator=gen, device=dev)
        fu = torch.where(fu < 0.1, 0.0, fu)
        if zero is not None:
            fu[zero] = 0.0
        lead = (halos,) if lead is None else lead
        e_max = torch.amax(row_ee, dim=-1).reshape(lead)
        return (row_ee.reshape(lead + (rows,)),
                torch.linspace(0.0, 1.0, n_s, dtype=torch.float64,
                               device=dev),
                fu.reshape(lead + (nf1 + nf2,)), 0.9 * e_max, e_max, nf1,
                nf2)

    return [("e_max_and_b_rows", case(3, 8, 512)),
            ("zero_f_halo", case(4, 5, 256, zero=2)),
            ("one_halo", case(1, 16, 512)),
            ("no_lead_axis", case(1, 16, 512, lead=())),
            ("n_s_100", case(2, 7, 100, nf1=300, nf2=50)),
            ("n_s_1000", case(2, 7, 1000)),
            ("n_s_8192", case(1, 3, 8192))]


def speed_cdf_bound_ms(args):
    """Least time of the speed-CDF kernel's work: the node table and row
    energies read once and the float32 rows written once at the HBM rate,
    or its float64 operations (E, 3 a query, and the scan's adds) at the
    card's float64 rate."""
    row_ee, s, fu = args[:3]
    rows, n_s = row_ee.numel(), s.shape[0]
    nbytes = 4 * fu.numel() + 8 * rows + 4 * rows * n_s + 12 * n_s
    ops = rows * (3 * n_s + (n_s - 1) * math.ceil(math.log2(n_s - 1)))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP64_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_speed_cdf(P, V, S, E):
    """The speed-CDF kernel against its plain version on the card, bit for
    bit, at the path shapes and the edge rows; returns ``(timing rows of
    the path shapes by name, largest |kernel - plain|)``."""
    dev = torch.device("cuda")
    path_cases = speed_cdf_path_cases(P, V, E)
    errs = {}
    for name, args in path_cases + speed_cdf_edge_cases(dev):
        got = S.speed_cdf_rows_f32(*args)
        want = S.speed_cdf_rows_f32_plain(*args)
        sync()
        shape = tuple(args[0].shape) + (args[1].shape[0],)
        check(got.shape == shape and got.dtype == torch.float32,
              f"speed CDF {name}: shape {tuple(got.shape)} dtype {got.dtype}")
        check(bool(torch.isfinite(got).all()),
              f"speed CDF {name}: non-finite")
        err = errs[name] = float((got - want).abs().max())
        print(f"speed CDF {name}: {shape}  max|kernel - plain| = {err:.3e}")
        check(torch.equal(got, want),
              f"speed CDF {name}: kernel and plain version differ ({err})")
    del got, want
    rows = {}
    for name, args in path_cases:
        ms = cuda_ms(lambda: S.speed_cdf_rows_f32(*args), 200)
        plain_ms = cuda_ms(lambda: S.speed_cdf_rows_f32_plain(*args), 5)
        bound, bound_by = speed_cdf_bound_ms(args)
        _, events, _ = kernel_profile(lambda: S.speed_cdf_rows_f32(*args))
        dev_ms = sum(e.dur_us for e in events
                     if "speed_cdf_rows_kernel" in e.name) / 1e3
        shape = "x".join(map(str, tuple(args[0].shape) + (args[1].shape[0],)))
        print(f"speed CDF {name}: {shape} kernel {ms:.4f} ms (device "
              f"{dev_ms:.4f} ms, {ms / bound:.1f}x bound), plain "
              f"{plain_ms:.4f} ms, bound {bound:.5f} ms ({bound_by})")
        rows[name] = {"path_shape": name, "shape": shape,
                      "max_abs_err": errs[name], "ms": ms,
                      "device_ms": dev_ms, "plain_ms": plain_ms,
                      "bound_ms": bound, "bound_by": bound_by}
    return rows, max(errs.values())


def abel_path_cases(P, V, E, dev="cuda",
                    batches=(DATAGEN_BATCH, 64, DATAGEN_OM_BATCH)):
    """The Abel kernel's arguments on the main paths, recorded from the
    port's own DF builds on the card (every program's eager body):
    ``[(name, (x, b, c, d, ee)), ...]`` for the ensemble batch (256
    clusters; its Osipkov-Merritt batch on the 704-point extended grid), a
    batch of 64, the merger (two halos, ergodic and Osipkov-Merritt on
    1192 points) and the class path (one cluster on 1000 points), DM and
    stars each.  ``dev`` and ``batches`` (the three ensemble batches) for
    a rehearsal on the CPU."""
    import cluster_generator_tpu_torch as cg
    from cluster_generator_tpu_torch.core import compiled as C

    real, seen, cases = V.abel_g_rows, [], []

    def record(*args):
        seen.append(args)
        return real(*args)

    def run(path, build):
        build()
        check(len(seen) == 2, f"Abel {path}: {len(seen)} DF builds, want 2")
        cases.extend((f"{path}_{sp}", a) for sp, a in zip(("dm", "star"),
                                                          seen))
        seen.clear()

    gen = torch.Generator(device=dev).manual_seed(DATAGEN_SEED)
    M, c = E.sample_ensemble_params(gen, max(batches), device=dev)
    V.abel_g_rows = record
    try:
        with C.eager():
            paths = (("datagen", None), ("datagen_b64", None),
                     ("datagen_om", DATAGEN_R_A))
            for (path, r_a), n in zip(paths, batches):
                prog = E._datagen_full_batch_fn(DATAGEN_POINTS, 1, 0, 1,
                                                r_a=r_a)
                run(path, lambda: prog.dfs(prog.models(M[:n], c[:n])))
            run("merger", lambda: P.build_merger_models(M200, CONC,
                                                        device=dev))
            run("merger_om", lambda: P.build_merger_models(
                M200, CONC, r_a=MERGER_R_A, device=dev))

            def class_dfs():
                m = build_class_model(cg, num_points=1000, device=dev)
                return m.dm_virial.df, m.star_virial.df

            run("class", class_dfs)
    finally:
        V.abel_g_rows = real
    return cases


def abel_edge_cases(dev):
    """Arguments that probe the Abel kernel's edges, on the density
    spline of a smooth rising rho(psi) over geometric knots: N no multiple
    of a piece or a group, N above one group of shared memory (4096 +
    192), a flat density (g = 0), rows off the knots (at 0, inside
    interval 0 and above the last knot), an odd row count, one row, no
    leading axis, and knots shared by every entry."""
    from cluster_generator_tpu_torch.core.interp import cubic_spline

    gen = torch.Generator(device=dev).manual_seed(29)

    def spline(entries, n, flat=False, lead=None, shared=False):
        top = 1.0 + 9.0 * torch.rand((entries, 1), generator=gen,
                                     dtype=torch.float64, device=dev)
        if shared:  # entry 0's knots for every entry
            top = top[:1].expand(entries, 1)
        x = top * torch.logspace(-4.0, 0.0, n, dtype=torch.float64,
                                 device=dev)
        wiggle = 1.0 + 0.05 * torch.sin(
            37.0 * x / top + torch.rand((entries, 1), generator=gen,
                                        dtype=torch.float64, device=dev))
        rho = torch.ones_like(x) if flat else (x / top) ** 1.7 * wiggle
        sp = cubic_spline(x, rho)
        lead = (entries,) if lead is None else lead
        return [t.reshape(lead + t.shape[-1:]) for t in (sp.x, sp.b, sp.c,
                                                          sp.d)]

    def case(entries, n, flat=False, lead=None):
        x, b, c, d = spline(entries, n, flat, lead)
        return x, b, c, d, x

    x, b, c, d = spline(3, 300)
    off = torch.cat([torch.zeros_like(x[:, :1]), 0.5 * x[:, :1], x,
                     2.0 * x[:, -1:]], dim=-1)
    sx, sb, sc, sd = spline(4, 200, shared=True)
    return [("n_777", case(3, 777)),
            ("n_4288", case(2, 4096 + 192)),
            ("flat_density", case(2, 300, flat=True)),
            ("rows_off_the_knots", (x, b, c, d, off)),
            ("odd_rows", (x, b, c, d, x[:, :99])),
            ("one_row", (x, b, c, d, x[:, 150:151])),
            ("no_lead_axis", case(1, 512, lead=())),
            ("shared_knots", (sx[0], sb, sc, sd, sx[0]))]


def abel_row_err(got, want):
    """max over rows of max |got - want| / max |want| (a row: one entry's
    g), a row of zeros taken as 1."""
    scale = want.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(scale > 0.0, scale, torch.ones_like(scale))
    return float(((got - want).abs() / scale).max())


def abel_bound_ms(args):
    """Least time of the Abel kernel's work: its float64 operations (the
    terms with lo_k < E_i, each a square root counted as 6 and 26 adds and
    multiplies) at the card's float64 rate, or its inputs and g moved once
    at the HBM rate."""
    x, b, c, d, ee = args
    lo = torch.cat([torch.zeros_like(x[..., :1]), x[..., :-1]], dim=-1)
    terms = int((lo[..., None, :] < ee[..., :, None]).sum())
    rows = ee.numel()
    nbytes = 8 * (x.numel() + b.numel() + c.numel() + d.numel() + 2 * rows)
    t_ops = terms * 32 / FP64_OPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes"), terms


def check_abel(P, V, A, E):
    """The Abel kernel against its plain version on the card at the path
    shapes and the edge rows: g within ``ABEL_RTOL`` of each row's
    largest |g| (only the summation order differs), every lane count the
    same bits; returns ``(timing rows of the path shapes by name, largest
    row error)``."""
    dev = torch.device("cuda")
    path_cases = abel_path_cases(P, V, E)
    errs = {}
    for name, args in path_cases + abel_edge_cases(dev):
        before = A.abel_g_rows.launches
        got = A.abel_g_rows(*args)
        want = A.abel_g_rows_plain(*args)
        sync()
        check(A.abel_g_rows.launches == before + 1,
              f"Abel {name}: {A.abel_g_rows.launches - before} launches")
        check(got.shape == want.shape and got.dtype == torch.float64,
              f"Abel {name}: shape {tuple(got.shape)} dtype {got.dtype}")
        check(bool(torch.isfinite(got).all()), f"Abel {name}: non-finite")
        err = errs[name] = abel_row_err(got, want)
        lead = A._check(*args)
        same = all(torch.equal(got, A._launch(*args, lead, log_s=s))
                   for s in range(6))
        print(f"Abel {name}: {tuple(got.shape)} on {args[0].shape[-1]} "
              f"knots  max row |kernel - plain| / max|g| = {err:.3e}, "
              f"every lane count the same bits: {same}")
        check(err <= ABEL_RTOL, f"Abel {name}: {err} > {ABEL_RTOL}")
        check(same, f"Abel {name}: the lane counts give different bits")
    del got, want
    rows = {}
    for name, args in path_cases:
        ms = cuda_ms(lambda: A.abel_g_rows(*args), 100)
        plain_ms = cuda_ms(lambda: A.abel_g_rows_plain(*args), 3)
        bound, bound_by, terms = abel_bound_ms(args)
        _, events, _ = kernel_profile(lambda: A.abel_g_rows(*args))
        dev_ms = sum(e.dur_us for e in events
                     if "abel_g_rows_kernel" in e.name) / 1e3
        shape = f"{'x'.join(map(str, args[4].shape))} on {args[0].shape[-1]}"
        print(f"Abel {name}: {shape} kernel {ms:.4f} ms (device "
              f"{dev_ms:.4f} ms, {ms / bound:.1f}x bound), plain "
              f"{plain_ms:.4f} ms, bound {bound:.5f} ms ({bound_by}, "
              f"{terms} terms)")
        rows[name] = {"path_shape": name, "shape": shape,
                      "max_row_err": errs[name], "ms": ms,
                      "device_ms": dev_ms, "plain_ms": plain_ms,
                      "bound_ms": bound, "bound_by": bound_by,
                      "terms": terms}
    return rows, max(errs.values())


def draw_path_cases(E):
    """The draw kernel's arguments on the datagen path, recorded from the
    program's eager body on the card: ``[(name, kind, args, r_a), ...]``,
    ``kind`` ``"collisionless"`` (args ``(uniforms, r_q, v_esc, joint)``)
    or ``"gas"`` (``(uniforms, r_q, grid_r, e_grid)``), for the batch of
    256 (cfg5c's counts: DM, stars, gas), the batch of 64 at ten times
    the counts, and the Osipkov-Merritt DM batch of 256."""
    from cluster_generator_tpu_torch.core import compiled as C

    dev, batches, scale = "cuda", (DATAGEN_BATCH, 64), (1, 10)

    real = {"collisionless": E.draw_collisionless, "gas": E.draw_gas}
    seen = []

    def record(kind):
        def call(*args):
            r_a = args[4] if len(args) > 4 else None
            seen.append((kind, args[:4], r_a))
            return real[kind](*args)
        return call

    gen = torch.Generator(device=dev).manual_seed(DATAGEN_SEED)
    M, c = E.sample_ensemble_params(gen, max(batches), device=dev)
    cases = []
    E.draw_collisionless = record("collisionless")
    E.draw_gas = record("gas")
    try:
        with C.eager():
            runs = [(f"datagen{'' if n == DATAGEN_BATCH else f'_b{n}'}",
                     n, {k: v * f for k, v in DATAGEN_COUNTS.items()}, None)
                    for n, f in zip(batches, scale)]
            runs.append(("datagen_om", batches[0],
                         dict(DATAGEN_COUNTS, gas=0, star=0), DATAGEN_R_A))
            for path, n, counts, r_a in runs:
                prog = E._datagen_full_batch_fn(
                    DATAGEN_POINTS, counts["dm"], counts["gas"],
                    counts["star"], r_a=r_a)
                prog.run(M[:n], c[:n], torch.Generator(
                    device=dev).manual_seed(DATAGEN_SEED + n))
                names = [sp for sp in ("dm", "star", "gas") if counts[sp]]
                check(len(seen) == len(names),
                      f"draws {path}: {len(seen)} calls, want {len(names)}")
                cases.extend((f"{path}_{sp}", kind, args, r_a)
                             for sp, (kind, args, r_a) in zip(names, seen))
                seen.clear()
    finally:
        E.draw_collisionless = real["collisionless"]
        E.draw_gas = real["gas"]
    return cases


def draw_edge_cases(dev):
    """Arguments that probe the draw kernel's edges on synthetic tables:
    uniforms at 0 and one ulp below 1, cos_theta at -1, a count no
    multiple of a block, a count under one block, one cluster, the
    fewest nodes (2 radius nodes, 2 quantiles, a 2-point grid), and rows
    that need several blocks of one cluster; each ``(name, kind, args,
    r_a)`` as :func:`draw_path_cases`, with an Osipkov-Merritt copy of
    each collisionless case."""
    gen = torch.Generator(device=dev).manual_seed(31)
    f32 = torch.float32
    below_one = float(torch.nextafter(torch.tensor(1.0, dtype=f32),
                                      torch.tensor(0.0, dtype=f32)))

    def rand(*shape):
        return torch.rand(shape, generator=gen, dtype=f32, device=dev)

    def edges(u, lo=0.0):
        """``u`` with its first entries at ``lo`` and one ulp below 1."""
        flat = u.view(-1)
        k = min(4, flat.numel())
        flat[:k] = torch.tensor([lo, below_one, lo, below_one][:k])
        return u

    def uniforms(B, n, kind):
        def direction():
            return (edges(2.0 * rand(B, n) - 1.0, lo=-1.0),
                    edges(rand(B, n)))

        if kind == "collisionless":
            return (edges(rand(B, n)), edges(rand(B, n)), edges(rand(B, n)),
                    direction(), direction())
        return edges(rand(B, n)), direction()

    def ascending(B, m, lo, hi):
        x = torch.cumsum(rand(B, m) + 0.05, dim=-1)
        x = (x - x[:, :1]) / (x[:, -1:] - x[:, :1])
        return (lo + (hi - lo) * x).to(f32).contiguous()

    def collisionless(B, n, rq, n_q):
        r_q = ascending(B, rq, 0.0, 5000.0)
        v_esc = torch.flip(ascending(B, rq, 0.1, 3.0), (-1,)).contiguous()
        joint = (torch.cumsum(rand(B, rq, n_q), dim=-1)
                 / n_q * v_esc[..., None]).contiguous()
        return uniforms(B, n, "collisionless"), r_q, v_esc, joint

    def gas(B, n, rq, n_grid):
        lg = torch.linspace(math.log(0.1), math.log(1e4), n_grid,
                            dtype=torch.float64, device=dev)
        grid_r = torch.exp(lg).to(f32).expand(B, n_grid).contiguous()
        r_q = ascending(B, rq, 0.1, 5000.0)
        e_grid = (1.0 + rand(B, n_grid)).contiguous()
        return uniforms(B, n, "gas"), r_q, grid_r, e_grid

    # name, clusters, particles, radius nodes, quantiles, grid points
    shapes = [("odd_n", 3, 1000, 300, 40, 64),
              ("under_a_block", 2, 100, 64, 16, 32),
              ("one_cluster", 1, 5000, 2048, 512, 512),
              ("fewest_nodes", 2, 513, 2, 2, 2),
              ("many_blocks", 2, 70_000, 2048, 512, 512)]
    cases = []
    for name, B, n, rq, n_q, n_grid in shapes:
        args = collisionless(B, n, rq, n_q)
        cases.append((f"{name}_collisionless", "collisionless", args, None))
        cases.append((f"{name}_om", "collisionless", args, DATAGEN_R_A))
        cases.append((f"{name}_gas", "gas", gas(B, n, rq, n_grid), None))
    return cases


def draw_same(got, want):
    """The kernel's outputs and the plain version's: the same bits (-0.0
    and NaN included)."""
    return all(torch.equal(g.contiguous().view(torch.int32),
                           w.contiguous().view(torch.int32))
               for g, w in zip(got, want))


def draw_err(got, want):
    """The largest |kernel - plain| over the outputs, in float64; a NaN
    on both sides counts as equal, on one side as infinite."""
    err = 0.0
    for g, w in zip(got, want):
        d = (g.double() - w.double()).abs()
        both = torch.isnan(g) & torch.isnan(w)
        d = torch.where(both, 0.0, d.nan_to_num(nan=math.inf))
        err = max(err, float(d.max()) if d.numel() else 0.0)
    return err


def draw_bytes(kind, args):
    """Bytes the draw must move: its uniforms read and outputs written
    once, its tables read once, the joint table two floats a particle."""
    uniforms, tables = args[0], args[1:]
    flat = [u for x in uniforms for u in (x if isinstance(x, tuple)
                                          else (x,))]
    n = flat[0].numel()
    outs = 6 if kind == "collisionless" else 4
    nbytes = 4 * n * (len(flat) + outs)
    if kind == "collisionless":
        r_q, v_esc, _ = tables
        nbytes += 4 * (r_q.numel() + v_esc.numel()) + 8 * n
    else:
        nbytes += 4 * sum(t.numel() for t in tables)
    return nbytes


def check_draws(E, D):
    """The draw kernel against its plain version on the card at the
    datagen path's shapes and the edge uniforms, the same bits on every
    path (isotropic and Osipkov-Merritt); returns the timing rows of the
    path shapes by name and the largest |kernel - plain| over every
    case."""
    dev = torch.device("cuda")
    path_cases = draw_path_cases(E)
    wrap = {"collisionless": D.draw_collisionless, "gas": D.draw_gas}
    plain = {"collisionless": D.draw_collisionless_plain,
             "gas": D.draw_gas_plain}
    max_err = 0.0
    for name, kind, args, r_a in path_cases + draw_edge_cases(dev):
        extra = (r_a,) if kind == "collisionless" else ()
        before = wrap[kind].launches
        got = wrap[kind](*args, *extra)
        want = plain[kind](*args, *extra)
        sync()
        check(wrap[kind].launches == before + 1,
              f"draws {name}: {wrap[kind].launches - before} launches")
        check(all(g.shape == w.shape and g.dtype == torch.float32
                  for g, w in zip(got, want)), f"draws {name}: shapes")
        same = draw_same(got, want)
        err = draw_err(got, want)
        max_err = max(max_err, err)
        print(f"draws {name}: {kind} {'x'.join(map(str, args[0][0].shape))}"
              f"{'' if r_a is None else f', r_a {r_a:g}'}, same bits: {same}"
              f", max |kernel - plain| {err:.3g}")
        check(same, f"draws {name}: the kernel's bits differ")
    del got, want
    rows = {}
    for name, kind, args, r_a in path_cases:
        extra = (r_a,) if kind == "collisionless" else ()
        ms = cuda_ms(lambda: wrap[kind](*args, *extra), 100)
        plain_ms = cuda_ms(lambda: plain[kind](*args, *extra), 3)
        bound = draw_bytes(kind, args) / HBM_BYTES_PER_S * 1e3
        _, events, _ = kernel_profile(lambda: wrap[kind](*args, *extra))
        dev_ms = sum(e.dur_us for e in events
                     if "draw_" in e.name and "_kernel" in e.name) / 1e3
        shape = "x".join(map(str, args[0][0].shape))
        print(f"draws {name}: {shape} kernel {ms:.4f} ms (device "
              f"{dev_ms:.4f} ms, {dev_ms / bound:.1f}x bound), plain "
              f"{plain_ms:.4f} ms, bound {bound:.5f} ms (bytes)")
        rows[name] = {"path_shape": name, "shape": shape, "ms": ms,
                      "device_ms": dev_ms, "plain_ms": plain_ms,
                      "bound_ms": bound, "bound_by": "bytes"}
    return rows, max_err


# ------------------------------------------------------------------ phase 4
def run_main_path(P, **switches):
    gen = torch.Generator(device="cuda").manual_seed(0)
    sync()
    t0 = time.perf_counter()
    parts, fields = P.merger_ic_fused(M200, CONC, CENTERS, VELOCITIES, R_MAX,
                                      N_GAS, N_DM, N_STAR, generator=gen,
                                      device="cuda", **switches)
    sync()
    return parts, fields, time.perf_counter() - t0


def stage_times(P):
    """Warm seconds of each of the four stages, synchronised: each stage is
    a program of its own, so the second of two runs is timed (the first
    captures)."""
    out = {}
    gen = torch.Generator(device="cuda").manual_seed(1)

    def clock(name, fn):
        sync()
        t0 = time.perf_counter()
        res = fn()
        sync()
        out[name] = time.perf_counter() - t0
        return res

    for _ in range(2):
        fields = clock("models", lambda: P.build_merger_models(
            M200, CONC, device="cuda"))
        tables = clock("speed_tables", lambda: P.build_speed_tables(fields))
        tables["radius"] = clock("radius_tables",
                                 lambda: P.build_radius_tables(fields, R_MAX))
        clock("draws", lambda: P.sample_merger_ic(
            fields, tables, CENTERS, VELOCITIES, R_MAX, N_GAS, N_DM, N_STAR,
            generator=gen))
    return out


def check_main_path(parts):
    counts = {"gas": sum(N_GAS), "dm": sum(N_DM), "star": sum(N_STAR)}
    for sp, n in counts.items():
        for name in ("particle_position", "particle_velocity",
                     "particle_mass"):
            t = parts[sp, name]
            check(t.shape[0] == n, f"{sp} {name}: {t.shape[0]} != {n}")
            check(t.dtype == torch.float32, f"{sp} {name}: {t.dtype}")
    bad = {f"{k[0]}/{k[1]}": int((~torch.isfinite(v)).sum())
           for k, v in parts.items()}
    print("non-finite values per output:", json.dumps(bad))
    check(all(v == 0 for v in bad.values()), f"non-finite outputs: {bad}")
    vx = parts["dm", "particle_velocity"][:, 0]
    means = [float(vx[:N_DM[0]].mean()), float(vx[N_DM[0]:].mean())]
    print(f"DM bulk vx per halo: {means[0]:.5f} {means[1]:.5f} "
          f"(want {VELOCITIES[0][0]} {VELOCITIES[1][0]})")
    for got, (want, _, _) in zip(means, VELOCITIES):
        check(abs(got - want) < 0.01, f"DM bulk vx {got} vs {want}")
    gv = parts["gas", "particle_velocity"]
    lo = min(v[0] for v in VELOCITIES) - 1e-5
    hi = max(v[0] for v in VELOCITIES) + 1e-5
    gx_min, gx_max = float(gv[:, 0].min()), float(gv[:, 0].max())
    print(f"gas vx range [{gx_min:.6f}, {gx_max:.6f}] (hull [{lo}, {hi}]); "
          f"max |gas vy|, |gas vz| {float(gv[:, 1:].abs().max()):.2e}")
    check(lo <= gx_min and gx_max <= hi, "gas vx outside the bulk hull")
    check(float(gv[:, 1:].abs().max()) < 1e-6, "gas vy/vz not ~0")


# ------------------------------------------------------------------ phase 5
def check_merger_switches(parts):
    """The merger IC drawn with r_a, tracers and potentials: everything
    finite, tracers massless and at rest, potentials negative, and the
    drawn DM of halo 1 radially biased outside r_a."""
    bad = {f"{k[0]}/{k[1]}": int((~torch.isfinite(v)).sum())
           for k, v in parts.items()}
    print("merger with r_a, tracers, potentials: non-finite values per "
          "output:", json.dumps(bad))
    check(all(v == 0 for v in bad.values()), f"non-finite outputs: {bad}")
    n_tr = sum(N_TRACER)
    tr_shape = tuple(parts["tracer", "particle_position"].shape)
    check(tr_shape == (n_tr, 3), f"tracer positions {tr_shape}")
    check(not bool(parts["tracer", "particle_mass"].any()),
          "tracers must have zero mass")
    check(not bool(parts["tracer", "particle_velocity"].any()),
          "tracers must be at rest")
    for sp, n in (("gas", sum(N_GAS)), ("dm", sum(N_DM)),
                  ("star", sum(N_STAR))):
        phi = parts[sp, "particle_potential"]
        check(phi.shape == (n,) and phi.dtype == torch.float32,
              f"{sp} potential: {tuple(phi.shape)} {phi.dtype}")
        check(bool((phi < 0).all()), f"{sp} potential not negative")
    check(("tracer", "particle_potential") not in parts,
          "tracers carry no potential")
    n1 = N_DM[0]
    c0 = torch.tensor(CENTERS[0], dtype=torch.float64, device="cuda")
    v0 = torch.tensor(VELOCITIES[0], dtype=torch.float64, device="cuda")
    pos = parts["dm", "particle_position"][:n1].double() - c0
    vel = parts["dm", "particle_velocity"][:n1].double() - v0
    beta = beta_profile(pos, vel, MERGER_R_A, "merger dm halo 1")
    check(len(beta) >= 3, "too few populated bins for the merger's beta")


# ------------------------------------------------------------------ phase 6
def beta_profile(pos, vel, r_a, label, edges=None):
    """Drawn anisotropy beta = 1 - <v_t^2> / (2 <v_r^2>) in log-radial
    bins against the Osipkov-Merritt form r^2 / (r^2 + r_a^2), within
    0.05 + 0.1 beta_OM (the JAX package's test bound).  ``pos``/``vel``:
    (..., 3) float64 about the halo's centre and bulk velocity.  Bins with
    fewer than 2000 particles are skipped; returns the checked bins."""
    if edges is None:
        edges = [100.0 * 60.0 ** (i / 6.0) for i in range(7)]  # 100..6000
    pos = pos.reshape(-1, 3)
    vel = vel.reshape(-1, 3)
    r = pos.norm(dim=1)
    v_r = (vel * pos).sum(dim=1) / r.clamp_min(1e-30)
    v_t2 = (vel * vel).sum(dim=1) - v_r * v_r
    out = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        m = (r >= lo) & (r < hi)
        n = int(m.sum())
        if n < 2000:
            continue
        got = 1.0 - float(v_t2[m].mean()) / (2.0 * float((v_r[m] ** 2).mean()))
        rmid = math.sqrt(lo * hi)
        want = rmid ** 2 / (rmid ** 2 + r_a ** 2)
        out.append({"r": round(rmid, 1), "n": n, "beta": round(got, 4),
                    "beta_om": round(want, 4)})
        check(abs(got - want) < 0.05 + 0.1 * want,
              f"{label}: beta {got:.3f} vs OM {want:.3f} at r~{rmid:.0f}")
    print(f"{label}: beta(r) drawn vs OM:", json.dumps(out))
    return out


def ks_statistic(r, rr, mm):
    """Kolmogorov-Smirnov distance of the radii ``r`` (n,) from the mass
    CDF ``mm / mm[-1]`` on the grid ``rr``."""
    from cluster_generator_tpu_torch.core.interp import interp

    n = r.shape[0]
    cdf = interp(torch.sort(r).values, rr, mm / mm[-1])
    i = torch.arange(1, n + 1, dtype=torch.float64, device=r.device)
    return float(torch.maximum((i / n - cdf).max(),
                               (cdf - (i - 1) / n).max()))


def datagen_qa(E, QA, M, c, out, r_a, label):
    """Physics QA of one batch's draws on the card, with the tolerances
    of ``QA_TOLERANCES``: every value finite; radii inside the model grid;
    collisionless speeds under the local escape speed; ``n * pmass``
    against the species' grid mass; gas energy against 1.5 P / rho at the
    particle's radius; KS distance of cluster 0's radii from the mass
    CDF; for an OM batch the pooled anisotropy profile."""
    from cluster_generator_tpu_torch.core.interp import interp

    tol = QA["cluster"]
    bad = E.nonfinite_counts(out)
    print(f"{label}: non-finite values per species and output:",
          json.dumps(bad))
    check(all(v == 0 for v in bad.values()), f"{label}: non-finite {bad}")
    f = E.build_ensemble(M, c, num_points=DATAGEN_POINTS, with_df=False,
                         device="cuda")
    rr = f["radius"]
    psi = -f["gravitational_potential"]
    report = {}
    for sp, mkey in (("dm", "dark_matter_mass"), ("star", "stellar_mass"),
                     ("gas", "gas_mass")):
        pos, second, pmass = out[sp]
        n = DATAGEN_COUNTS[sp]
        check(pos.shape == (M.shape[0], n, 3) and pos.dtype == torch.float32,
              f"{label} {sp}: pos {tuple(pos.shape)} {pos.dtype}")
        check(pmass.shape == (M.shape[0],), f"{label} {sp}: pmass shape")
        r = pos.double().norm(dim=-1)
        rfrac = float((r / rr[:, -1:]).max())
        zfrac = float((r == 0).double().mean())
        merr = float(((pmass.double() * n - f[mkey][:, -1]).abs()
                      / f[mkey][:, -1]).max())
        ks = ks_statistic(r[0], rr[0], f[mkey][0])
        rep = {"max_r_over_rmax": rfrac, "mass_rel_err": merr, "ks_d": ks}
        check(rfrac <= 1.0 + tol["radius_tol"],
              f"{label} {sp}: radius {rfrac:.7f} of r_max")
        check(zfrac <= QA["zero_row_tol"], f"{label} {sp}: {zfrac} zero radii")
        check(merr <= tol["mass_rtol"], f"{label} {sp}: mass off by {merr}")
        # the 1e-4 critical distance of the KS test, plus the quantile
        # table's own resolution
        ks_max = 2.23 / math.sqrt(n) + 1.0 / 2047
        check(ks < ks_max, f"{label} {sp}: KS distance {ks} >= {ks_max}")
        if sp == "gas":
            e_ref = interp(r, rr, 1.5 * f["pressure"] / f["density"])
            rel = float(((second.double() - e_ref).abs() / e_ref).max())
            rep["energy_rel_err"] = rel
            check(rel <= tol["energy_rtol"],
                  f"{label} gas: thermal energy off by {rel}")
            check(bool((second > 0).all()), f"{label} gas: energy <= 0")
        else:
            check(second.shape == pos.shape, f"{label} {sp}: vel shape")
            v = second.double().norm(dim=-1)
            frac = float((v / torch.sqrt(2.0 * interp(r, rr, psi))).max())
            rep["max_v_over_vesc"] = frac
            check(frac <= 1.0 + QA["speed_tol"],
                  f"{label} {sp}: speed {frac:.6f} of local v_esc")
            check(bool(second.any()), f"{label} {sp}: all-zero velocities")
            if r_a is not None:
                beta_profile(pos.double(), second.double(), r_a,
                             f"{label} {sp}")
        report[sp] = rep
    print(f"{label}: QA", json.dumps(report))


def run_datagen(E, K, S, D, QA, card):
    """The ensemble datagen path at full width; returns K1's launches on
    each of its three runs, the speed-CDF kernel's (one of each for
    every float32 speed table) and the draw kernel's (two collisionless
    and one gas a batch)."""
    counts = DATAGEN_COUNTS
    per_cluster = sum(counts.values())
    M, c = E.sample_ensemble_params(
        torch.Generator(device="cuda").manual_seed(DATAGEN_SEED),
        DATAGEN_CLUSTERS)
    kw = dict(batch_size=DATAGEN_BATCH, num_points=DATAGEN_POINTS,
              seed=DATAGEN_SEED, device="cuda")
    launches, cdf, draws = {}, {}, {}

    def stream(M, c, label, **extra):
        """Consume ``datagen_batches``; seconds until every batch is done,
        the batches' outputs and the peak memory; the launches of K1, of
        the speed-CDF kernel and of the draw kernel under ``label``."""
        torch.cuda.reset_peak_memory_stats()
        K.invert_cdf_rows.launches = S.speed_cdf_rows_f32.launches = 0
        D.draw_collisionless.launches = D.draw_gas.launches = 0
        sync()
        t0 = time.perf_counter()
        outs = list(E.datagen_batches(M, c, counts, **dict(kw, **extra)))
        sync()
        launches[label] = K.invert_cdf_rows.launches
        cdf[label] = S.speed_cdf_rows_f32.launches
        draws[label] = (D.draw_collisionless.launches,
                        D.draw_gas.launches)
        return (time.perf_counter() - t0, outs,
                torch.cuda.max_memory_allocated() / 2**30)

    def check_draw_launches(label, n_batches):
        """Two collisionless launches (DM, stars) and one gas launch a
        batch."""
        got = draws[label]
        print(f"{label}: draw kernel launches (collisionless, gas) {got} "
              f"over {n_batches} batches")
        check(got == (2 * n_batches, n_batches),
              f"{label}: draw kernel launches (collisionless, gas) {got}, "
              f"want {(2 * n_batches, n_batches)}")

    B = DATAGEN_BATCH
    first_s, outs, peak = stream(M[:B], c[:B], "datagen_first")
    print(f"datagen first batch ({B} clusters x {per_cluster} particles): "
          f"{first_s:.3f} s; K1 launches {launches['datagen_first']}, "
          f"speed-CDF kernel {cdf['datagen_first']}; peak memory "
          f"{peak:.2f} GiB [{card}]")
    check(launches["datagen_first"] == 2 and cdf["datagen_first"] == 2,
          f"launches per batch: K1 {launches['datagen_first']}, speed CDF "
          f"{cdf['datagen_first']}, want 2 each")
    check_draw_launches("datagen_first", 1)
    datagen_qa(E, QA, M[:B], c[:B], outs[0][1], None, "datagen batch 0")
    del outs

    total_s, outs, peak = stream(M, c, "datagen")
    n_batches = len(outs)
    check([b0 for b0, _ in outs] == list(range(0, DATAGEN_CLUSTERS, B)),
          f"batch offsets {[b0 for b0, _ in outs]}")
    print(f"datagen stream, warm: {n_batches} batches in {total_s:.3f} s = "
          f"{total_s / n_batches:.3f} s per batch, "
          f"{DATAGEN_CLUSTERS / total_s:.1f} clusters/s, "
          f"{DATAGEN_CLUSTERS * per_cluster / total_s:.4g} particles/s; K1 "
          f"launches {launches['datagen']} "
          f"({launches['datagen'] / n_batches:g} per batch); peak memory "
          f"{peak:.2f} GiB with {n_batches} batches of output held [{card}]")
    check(launches["datagen"] == 2 * n_batches == cdf["datagen"],
          f"launches: K1 {launches['datagen']}, speed CDF {cdf['datagen']}, "
          f"want {2 * n_batches} each")
    check_draw_launches("datagen", n_batches)
    for b0, out in outs:
        bad = E.nonfinite_counts(out)
        check(all(v == 0 for v in bad.values()),
              f"datagen batch {b0}: non-finite {bad}")
    b0, out = outs[-1]
    datagen_qa(E, QA, M[b0:b0 + B], c[b0:b0 + B], out, None,
               f"datagen batch {b0}")
    del outs, out

    Bo = DATAGEN_OM_BATCH
    om_s, outs, peak = stream(M[:Bo], c[:Bo], "datagen_om", batch_size=Bo,
                              anisotropy_radius=DATAGEN_R_A)
    print(f"datagen Osipkov-Merritt batch (r_a = {DATAGEN_R_A:g} kpc, {Bo} "
          f"clusters): {om_s:.3f} s, {Bo / om_s:.1f} clusters/s; K1 launches "
          f"{launches['datagen_om']}; peak memory {peak:.2f} GiB [{card}]")
    check(launches["datagen_om"] == 2 and cdf["datagen_om"] == 2,
          f"launches of the OM batch: K1 {launches['datagen_om']}, speed "
          f"CDF {cdf['datagen_om']}, want 2 each")
    check_draw_launches("datagen_om", len(outs))
    datagen_qa(E, QA, M[:Bo], c[:Bo], outs[0][1], DATAGEN_R_A,
               "datagen OM batch")
    return launches, cdf, {k: sum(v) for k, v in draws.items()}


# ------------------------------------------------------------------ phase 7
def class_profiles(cg, m200=CLASS_M200, conc=CLASS_CONC, **dev):
    """The canonical cluster's gas and total density profiles, through the
    calls a user makes: with no ``device`` the bisection for r500 and the
    mass quadrature run on the card and return 0-d tensors there."""
    r200 = cg.find_overdensity_radius(m200, 200.0, z=CLASS_Z)
    a = r200 / conc
    M = cg.snfw_total_mass(m200, r200, a)
    rhot, Mt = cg.snfw_density_profile(M, a), cg.snfw_mass_profile(M, a)
    r500, M500 = cg.find_radius_mass(Mt, z=CLASS_Z, delta=500.0, **dev)
    rhog = cg.rescale_profile_by_mass(
        cg.vikhlinin_density_profile(1.0, 100.0, r200, 1.0, 0.67, 3),
        cg.f_gas(M500) * M500, r500, **dev)
    return rhog, rhot


def build_class_model(cg, num_points=CLASS_POINTS, gravity="newtonian",
                      **dev):
    """Profiles and model; ``device="cpu"`` only for the comparison."""
    rhog, rhot = class_profiles(cg, **dev)
    return cg.ClusterModel.from_dens_and_tden(
        0.1, 1e4, rhog, rhot, stellar_density=0.02 * rhot,
        num_points=num_points, gravity=gravity, **dev)


def timed(fn):
    """``(result, seconds)`` of ``fn``, synchronised on both sides."""
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def class_species_qa(model, parts, sp, n, r_max):
    """Physics QA of one species' draws, as tensors on the card; returns
    the numbers it checked."""
    from cluster_generator_tpu_torch import sampling as S
    from cluster_generator_tpu_torch.core.interp import (
        cubic_spline, spline_eval_loguniform)

    bad = {name: int((~torch.isfinite(parts[sp, name])).sum())
           for name in parts.field_names[sp]}
    check(all(v == 0 for v in bad.values()), f"class {sp}: non-finite {bad}")
    pos = parts[sp, "particle_position"]
    vel = parts[sp, "particle_velocity"]
    mass = parts[sp, "particle_mass"]
    check(pos.shape == (n, 3) and vel.shape == (n, 3) and mass.shape == (n,),
          f"class {sp}: shapes {tuple(pos.shape)} {tuple(mass.shape)}")
    for name in parts.field_names[sp]:
        t = parts[sp, name]
        check(t.is_cuda and t.dtype == torch.float64,
              f"class {sp}/{name}: {t.device} {t.dtype}")
    r = pos.norm(dim=1)
    rep = {"nonfinite": sum(bad.values()),
           "max_r_over_rmax": float(r.max()) / r_max}
    check(rep["max_r_over_rmax"] <= 1.0, f"class {sp}: radius "
          f"{rep['max_r_over_rmax']:.9f} of r_max")
    mkey = {"gas": "gas_mass", "tracer": "gas_mass",
            "dm": "dark_matter_mass", "star": "stellar_mass"}[sp]
    dkey = {"dm": "dark_matter_density", "star": "stellar_density"}.get(sp)
    P, rr_ins, mtot = S._truncated_cdf(
        model["radius"], model[mkey],
        None if dkey is None else model[dkey], r_max)
    rep["ks_d"] = ks_statistic(r, rr_ins, P)
    check(rep["ks_d"] < CLASS_KS_MAX,
          f"class {sp}: KS distance {rep['ks_d']} >= {CLASS_KS_MAX}")
    if sp == "tracer":
        check(not bool(mass.any()) and not bool(vel.any()),
              "class tracers must be massless and at rest")
        return rep
    rep["mass_rel_err"] = abs(float(mass.sum()) - mtot) / mtot
    check(rep["mass_rel_err"] <= CLASS_MASS_RTOL,
          f"class {sp}: masses sum off by {rep['mass_rel_err']}")
    if sp == "gas":
        check(not bool(vel.any()), "class gas velocities must be zero")
        check(bool((parts[sp, "thermal_energy"] > 0).all())
              and bool((parts[sp, "density"] > 0).all()),
              "class gas: energy or density <= 0")
        return rep
    psi_sp = cubic_spline(model["radius"], -model["gravitational_potential"])
    psi = spline_eval_loguniform(psi_sp, r)
    rep["max_v_over_vesc"] = float((vel.norm(dim=1)
                                    / torch.sqrt(2.0 * psi)).max())
    check(rep["max_v_over_vesc"] <= 1.0 + CLASS_SPEED_TOL,
          f"class {sp}: speed {rep['max_v_over_vesc']:.7f} of local v_esc")
    if (sp, "particle_potential") in parts.fields:
        # the same spline at the same radius, up to the rounding of |pos|
        perr = float(((parts[sp, "particle_potential"] + psi) / psi)
                     .abs().max())
        rep["potential_rel_err"] = perr
        check(perr < 1e-9, f"class {sp}: potential off by {perr}")
    return rep


def jeans_check(model, parts, sigma):
    """The DM draws' radial velocity dispersion in 8 log bins against the
    Jeans profile ``sigma`` of ``compute_velocity_dispersion``, within 5%."""
    from cluster_generator_tpu_torch.core.interp import interp

    pos = parts["dm", "particle_position"]
    r = pos.norm(dim=1)
    v_r = (parts["dm", "particle_velocity"] * pos).sum(dim=1) / r
    s2 = interp(r, model["radius"], sigma) ** 2
    edges = [30.0 * (4000.0 / 30.0) ** (i / 8.0) for i in range(9)]
    out = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        m = (r >= lo) & (r < hi)
        got = math.sqrt(float((v_r[m] ** 2).mean()))
        want = math.sqrt(float(s2[m].mean()))
        out.append({"r": round(math.sqrt(lo * hi), 1), "n": int(m.sum()),
                    "sigma_r": round(got, 5), "jeans": round(want, 5)})
        check(abs(got - want) < 0.05 * want,
              f"class dm: sigma_r {got:.4f} vs Jeans {want:.4f} in "
              f"[{lo:.0f}, {hi:.0f}) kpc")
    print("class dm: sigma_r drawn vs Jeans:", json.dumps(out))


def class_device_agreement(cg, m_gpu):
    """The class model, its DFs and its DM speed table on the card against
    the same build on the CPU."""
    m_cpu = build_class_model(cg, device="cpu")
    worst = {}
    for k in m_cpu.keys():
        a, b = m_cpu[k], m_gpu[k].cpu()
        err = float(((a - b).abs() / (a.abs() + 1e-12 * a.abs().max())).max())
        worst[k] = err
        check(err < CLASS_FIELD_RTOL,
              f"class field {k}: card vs CPU {err} >= {CLASS_FIELD_RTOL}")
    print("class fields card vs CPU, max rel:",
          json.dumps({k: f"{v:.1e}" for k, v in worst.items()}))
    from cluster_generator_tpu_torch.virial import compute_df

    def rel(a, b):
        return float(((a - b).abs() / (a.abs() + 1e-9 * a.abs().max())).max())

    for name, v_cpu, v_gpu in (("dm", m_cpu.dm_virial, m_gpu.dm_virial),
                               ("star", m_cpu.star_virial,
                                m_gpu.star_virial)):
        b = v_gpu.df.cpu()
        err = rel(v_cpu.df, b)
        # the DF step alone: the CPU's DF of the card's own fields
        step = torch.flip(compute_df(
            v_gpu.ee.cpu(), torch.flip(v_gpu._augmented_density(),
                                       (0,)).cpu()), (0,))
        err_step = rel(step, b)
        print(f"class {name} DF card vs CPU: max rel {err:.2e} end to end "
              f"(limit {CLASS_DF_RTOL}), {err_step:.2e} from the same "
              f"fields (limit {CLASS_DF_STEP_RTOL})")
        check(err_step < CLASS_DF_STEP_RTOL and err < CLASS_DF_RTOL,
              f"class {name} DF: card vs CPU {err} (end to end), "
              f"{err_step} (same fields)")
    # the same builds with the profiles' floats kept on the host (every
    # function inline, as before the programs): how far lifting the floats
    # to 0-d tensor inputs moves the innermost DF on each device
    from cluster_generator_tpu_torch.core import compiled

    with compiled.inline():
        inline_df = {d: build_class_model(cg, device=d).dm_virial.df.cpu()
                     for d in ("cuda", "cpu")}
    lifted = {"cuda": m_gpu.dm_virial.df.cpu(), "cpu": m_cpu.dm_virial.df}
    print(f"class dm DF with the floats inline: card vs CPU "
          f"{rel(inline_df['cpu'], inline_df['cuda']):.2e}; lifted vs "
          f"inline: card {rel(inline_df['cuda'], lifted['cuda']):.2e}, "
          f"CPU {rel(inline_df['cpu'], lifted['cpu']):.2e}")
    diff = (m_gpu.dm_virial._speed_table()[1].cpu()
            - m_cpu.dm_virial._speed_table()[1]).abs()
    err, n_over = float(diff.max()), int((diff > TABLE_TOL).sum())
    print(f"class speed table card vs CPU: max |diff| {err:.3e}, entries > "
          f"{TABLE_TOL}: {n_over} of {diff.numel()}")
    # the flat-row entries, as for the merger's tables below; this grid's
    # DF carries 3x the roundoff of a 1000-point one (CLASS_DF_RTOL), so
    # more float32 CDF values round the other way: up to 1 entry in 1e4
    check(n_over <= diff.numel() // 10_000 and err < 4 * TABLE_TOL,
          f"class speed table: max {err}, {n_over} entries > {TABLE_TOL}")


def run_class_path(cg, K, S, V, card):
    """The single-cluster class path at full width; returns K1's launches
    over the phase (DM, stars, Osipkov-Merritt DM: 3) and the speed-CDF
    kernel's (as many)."""
    n = CLASS_COUNTS
    r_max = R_MAX
    torch.cuda.reset_peak_memory_stats()
    K.invert_cdf_rows.launches = S.speed_cdf_rows_f32.launches = 0
    r500, m500 = cg.find_radius_mass(
        cg.snfw_mass_profile(1.7e15, 560.0), z=CLASS_Z, delta=500.0)
    check(r500.is_cuda and m500.is_cuda and r500.ndim == 0
          and cg.mass_within(cg.snfw_density_profile(1.7e15, 560.0),
                             1300.0).is_cuda,
          "class solvers: floats in, but the result is not on the card")
    m, first_s = timed(lambda: build_class_model(cg))
    warm = []
    for _ in range(3):
        m, s = timed(lambda: build_class_model(cg))
        warm.append(s)
    check(all(v.is_cuda and v.dtype == torch.float64
              for v in m.fields.values()), "class model fields not on card")
    wall_ms, kern, busy_ms = kernel_profile(lambda: build_class_model(cg))
    print(f"class profiles + model build ({CLASS_POINTS} points): first "
          f"{first_s:.3f} s, "
          f"warm {[round(s, 4) for s in warm]} s, median "
          f"{statistics.median(warm):.4f} s; profiled once: {wall_ms:.1f} ms, "
          f"{len(kern)} kernel launches, device busy {busy_ms:.2f} ms = "
          f"{busy_ms / wall_ms:.1%} [{card}]")

    (hse, dm_chk, st_chk), chk_s = timed(lambda: (
        m.check_hse(), m.check_dm_virial()[1], m.check_star_virial()[1]))
    res = {"hse_max_abs": float(hse.abs().max()),
           "dm_virial_max": float(dm_chk.max()),
           "star_virial_max": float(st_chk.max()),
           "dm_virial_max_abs": float(dm_chk.abs().max()),
           "dm_df_min": float(m.dm_virial.df.min())}
    print(f"class checks (both DFs built, {chk_s:.3f} s):", json.dumps(res))
    check(res["hse_max_abs"] < CLASS_RESIDUAL, f"class HSE residual {res}")
    check(res["dm_virial_max"] < CLASS_RESIDUAL
          and res["star_virial_max"] < CLASS_RESIDUAL,
          f"class virial residual {res}")
    check(res["dm_df_min"] >= 0.0, f"class DM f(E) negative: {res}")
    check(m.dm_virial.df.is_cuda and m.star_virial.df.is_cuda,
          "class DFs not on the card")
    m.set_magnetic_field_from_beta(100.0)
    check(bool((m["magnetic_field_strength"] > 0).all()), "class B field")
    sigma = m.compute_velocity_dispersion("dark_matter")

    draws = {"gas": lambda: m.generate_gas_particles(n["gas"], r_max=r_max,
                                                     prng=1),
             "dm": lambda: m.generate_dm_particles(
                 n["dm"], r_max=r_max, compute_potential=True, prng=2),
             "star": lambda: m.generate_star_particles(n["star"],
                                                       r_max=r_max, prng=3),
             "tracer": lambda: m.generate_tracer_particles(
                 n["tracer"], r_max=r_max, prng=4)}
    parts, times, report = {}, {}, {}
    for sp, fn in draws.items():
        _, first = timed(fn)
        launched = K.invert_cdf_rows.launches
        owner = {"dm": m.dm_virial, "star": m.star_virial}.get(sp, m)
        held = owner._draw_tables
        parts[sp], again = timed(fn)
        times[sp] = {"first_s": round(first, 4), "warm_s": round(again, 4)}
        check(K.invert_cdf_rows.launches == launched,
              f"class {sp}: a second draw launched K1 again")
        check(owner._draw_tables is held,
              f"class {sp}: a second draw rebuilt its tables")
        report[sp] = class_species_qa(m, parts[sp], sp, n[sp], r_max)
    # (the tracers' first draw finds the gas draws' tables, which it shares)
    print(f"class draws ({sum(n.values())} particles), seconds:",
          json.dumps(times), f"[{card}]")
    print("class draws: QA", json.dumps(report))
    check(K.invert_cdf_rows.launches == 2
          and S.speed_cdf_rows_f32.launches == 2,
          f"class path: K1 launches {K.invert_cdf_rows.launches}, speed CDF "
          f"{S.speed_cdf_rows_f32.launches}, want 2 each (one per species)")
    check(m.dm_virial._speed_table()[1].shape == (256, 512),
          "class speed table shape")
    jeans_check(m, parts["dm"], sigma)

    total, sum_s = timed(lambda: parts["gas"] + parts["dm"] + parts["star"]
                         + parts["tracer"])
    check(total.num_particles == n, f"class sum: {total.num_particles}")
    before = total["star", "particle_position"][:4].clone()
    _, off_s = timed(lambda: total.add_offsets([1500.0, 0.0, 0.0],
                                               [0.3, 0.0, 0.0]))
    shift = total["star", "particle_position"][:4] - before
    check(bool((shift[:, 0] - 1500.0).abs().max() < 1e-9)
          and not bool(shift[:, 1:].any()), "class add_offsets")
    check(float(total["gas", "particle_velocity"][:, 0].min()) == 0.3,
          "class add_offsets velocity")
    print(f"class sum of four species {sum_s:.4f} s, add_offsets "
          f"{off_s:.4f} s")
    del total, parts

    om, om_s = timed(lambda: V.VirialEquilibrium(m, r_a=CLASS_R_A))
    p_om, om_draw_s = timed(lambda: om.generate_particles(
        CLASS_OM_COUNT, r_max=r_max, prng=5))
    check(K.invert_cdf_rows.launches == 3
          and S.speed_cdf_rows_f32.launches == 3,
          f"class OM: K1 launches {K.invert_cdf_rows.launches}, speed CDF "
          f"{S.speed_cdf_rows_f32.launches}, want 3 each")
    rep = class_species_qa(m, p_om, "dm", CLASS_OM_COUNT, r_max)
    print(f"class Osipkov-Merritt (r_a = {CLASS_R_A:g} kpc): DF {om_s:.3f} s, "
          f"{CLASS_OM_COUNT} draws {om_draw_s:.3f} s; QA", json.dumps(rep))
    beta = beta_profile(p_om["dm", "particle_position"],
                        p_om["dm", "particle_velocity"], CLASS_R_A,
                        "class OM dm")
    check(len(beta) >= 4, "too few populated bins for the class OM beta")
    del p_om
    launches = K.invert_cdf_rows.launches
    cdf = S.speed_cdf_rows_f32.launches

    # the other constructors and the MOND laws
    rhog, rhot = class_profiles(cg)
    temp = cg.vikhlinin_temperature_profile(6.0, 0.1, 2.0, 1.2, 900.0, 0.4,
                                            60.0, 1.9)
    kw = dict(num_points=CLASS_OTHER_POINTS, device="cuda")
    others = {
        "from_dens_and_temp": lambda: cg.ClusterModel.from_dens_and_temp(
            0.1, 1e4, rhog, temp, stellar_density=0.02 * rhot, **kw),
        "no_gas": lambda: cg.ClusterModel.no_gas(
            0.1, 1e4, rhot, stellar_density=0.02 * rhot, **kw),
        "aqual": lambda: build_class_model(
            cg, num_points=CLASS_OTHER_POINTS, gravity="aqual"),
        "emond": lambda: build_class_model(
            cg, num_points=CLASS_OTHER_POINTS, gravity="emond"),
    }
    rep = {}
    for name, fn in others.items():
        om_model, s = timed(fn)
        bad = sum(int((~torch.isfinite(v)).sum())
                  for v in om_model.fields.values())
        check(bad == 0, f"class {name}: {bad} non-finite field values")
        rep[name] = {"s": round(s, 4)}
        if "pressure" in om_model:
            rep[name]["hse_max_abs"] = float(om_model.check_hse().abs().max())
            check(rep[name]["hse_max_abs"] < CLASS_RESIDUAL,
                  f"class {name}: HSE residual {rep[name]}")
        else:
            rep[name]["dm_virial_max"] = float(
                om_model.check_dm_virial()[1].max())
            check(rep[name]["dm_virial_max"] < CLASS_RESIDUAL,
                  f"class {name}: virial residual {rep[name]}")
    print(f"class other constructors ({CLASS_OTHER_POINTS} points):",
          json.dumps(rep))

    with tempfile.TemporaryDirectory() as d:
        m.write_model_to_ascii(os.path.join(d, "model.ecsv"))
        m.write_model_to_binary(os.path.join(d, "model.dat"))
        sizes = [os.path.getsize(os.path.join(d, f))
                 for f in ("model.ecsv", "model.dat")]
    check(all(sz > 8 * CLASS_POINTS for sz in sizes), f"class writers {sizes}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"class path peak memory {peak:.2f} GiB; K1 launches {launches} "
          f"[{card}]")
    class_device_agreement(cg, m)
    return launches, cdf


# ------------------------------------------------------------------ phase 8
def max_rel(a, b):
    a = a.detach().cpu().to(torch.float64)
    b = b.detach().cpu().to(torch.float64)
    return float(((a - b).abs() / a.abs().clamp_min(1e-300)).max())


def device_agreement(P):
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    f_gpu = P.build_merger_models(M200, CONC, device=cuda)
    f_cpu = P.build_merger_models(M200, CONC, device=cpu)
    worst = {}
    for k in sorted(f_cpu):
        tol = DF_RTOL if k.endswith("_df") else FIELD_RTOL
        err = max_rel(f_cpu[k], f_gpu[k])
        worst[k] = err
        check(f_gpu[k].dtype == torch.float64, f"field {k}: {f_gpu[k].dtype}")
        check(err < tol, f"field {k}: card vs CPU max rel {err} >= {tol}")
    print("fields card vs CPU, max rel:",
          json.dumps({k: f"{v:.2e}" for k, v in worst.items()}))

    t_gpu = P.build_speed_tables(f_gpu)
    t_cpu = P.build_speed_tables(f_cpu)
    t_gpu["radius"] = P.build_radius_tables(f_gpu, R_MAX)
    t_cpu["radius"] = P.build_radius_tables(f_cpu, R_MAX)
    for k in ("dm", "star"):
        diff = (t_gpu[k].cpu() - t_cpu[k]).abs()
        err = float(diff.max())
        n_over = int((diff > TABLE_TOL).sum())
        print(f"speed table {k} card vs CPU: max |diff| {err:.3e}, "
              f"entries > {TABLE_TOL}: {n_over} of {diff.numel()}")
        # The card's log/exp/pow differ from the CPU's in the last bits;
        # the DF, a spline derivative, carries that as ~5e-9 relative, so a
        # float32 CDF value can round one ulp (6e-8) the other way.  Where
        # the CDF rises only ~3e-5 per bin, one ulp moves s by ~4e-6 to
        # 1e-5: a few entries in 1e5 may pass TABLE_TOL, none by 4x.
        check(n_over <= max(2, diff.numel() // 50_000)
              and err < 4 * TABLE_TOL,
              f"speed table {k}: max {err}, {n_over} entries > {TABLE_TOL}")
    for k in ("gas", "dm", "star"):
        err = max_rel(t_cpu["radius"][k], t_gpu["radius"][k])
        print(f"radius table {k} card vs CPU: max rel {err:.3e}")
        check(err < TABLE_TOL, f"radius table {k}: {err} >= {TABLE_TOL}")

    # a small draw from the same uniforms on both devices
    n = (20_000, 15_000)
    gen = torch.Generator().manual_seed(5)

    def u(m):
        return torch.rand(m, generator=gen, dtype=torch.float32)

    def iso(m):
        return (u(m) * 2.0 - 1.0, u(m))

    unif = {}
    for i in range(2):
        unif["gas", i] = (u(n[i]), iso(n[i]))
        for kind in ("dm", "star"):
            unif[kind, i] = (u(n[i]), u(n[i]), u(n[i]), iso(n[i]), iso(n[i]))

    def to(tree, dev):
        if isinstance(tree, tuple):
            return tuple(to(x, dev) for x in tree)
        return tree.to(dev)

    p_gpu = P.sample_merger_ic(f_gpu, t_gpu, CENTERS, VELOCITIES, R_MAX, n, n,
                               n, uniforms={k: to(v, cuda)
                                            for k, v in unif.items()})
    p_cpu = P.sample_merger_ic(f_cpu, t_cpu, CENTERS, VELOCITIES, R_MAX, n, n,
                               n, uniforms=unif)
    bulk = torch.tensor(VELOCITIES, dtype=torch.float64)
    bulk = torch.cat([bulk[i].expand(n[i], 3) for i in range(2)])
    vmax = float(bulk.abs().max())
    for key in sorted(p_cpu):
        a = p_cpu[key].to(torch.float64)
        b = p_gpu[key].cpu().to(torch.float64)
        sp, name = key
        if name == "particle_velocity" and sp == "gas":
            # mixed bulk velocities cancel near the midplane: absolute
            err = float((a - b).abs().max()) / vmax
            print(f"draw {sp}/{name} card vs CPU: max |diff| / max bulk "
                  f"{err:.2e}")
            check(err < 2e-5, f"draw {key}: {err}")
            continue
        if name == "particle_velocity":
            # speeds about the halo's bulk velocity; the speed row is a
            # Bernoulli pick u < w, and an f32 tie in w moves a particle
            # to the neighbouring radius-quantile row
            sa, sb = (a - bulk).norm(dim=1), (b - bulk).norm(dim=1)
            rel = (sa - sb).abs() / sa.clamp_min(1e-30)
            frac = float((rel > 1e-4).to(torch.float64).mean())
            print(f"draw {sp} speed card vs CPU: max rel "
                  f"{float(rel.max()):.2e}, share > 1e-4: {frac:.2e}")
            check(frac <= 1e-4, f"draw {key}: {frac} of speeds off > 1e-4")
            continue
        if a.ndim == 2:
            # per particle, relative to the row's size
            rel = (a - b).norm(dim=1) / a.norm(dim=1).clamp_min(1e-30)
        else:
            rel = (a - b).abs() / a.abs().clamp_min(1e-30)
        print(f"draw {sp}/{name} card vs CPU: max rel {float(rel.max()):.2e}")
        check(float(rel.max()) < 2e-5, f"draw {key}: {float(rel.max())}")


# ------------------------------------------------------------------ phase 9
def run_gradient(E):
    """d(central pressure)/dM200 through ``build_one_cluster`` on the card
    (256 points, no DF): autograd against a central difference.  The
    builder's program runs its eager body where M200 needs grad (a graph
    has no autograd tape); the differences replay it.  Returns the
    gradient."""
    dev = torch.device("cuda")
    conc = torch.tensor([GRAD_CONC], dtype=torch.float64, device=dev)

    def central_pressure(m):
        f = E.build_one_cluster(m, conc, num_points=256, with_df=False)
        return f["pressure"][..., 0].sum()

    m = torch.tensor([GRAD_M200], dtype=torch.float64, device=dev,
                     requires_grad=True)
    central_pressure(m).backward()
    grad = float(m.grad[0])
    with torch.no_grad():
        up = float(central_pressure(torch.full_like(m, GRAD_M200 + GRAD_EPS)))
        dn = float(central_pressure(torch.full_like(m, GRAD_M200 - GRAD_EPS)))
    fd = (up - dn) / (2.0 * GRAD_EPS)
    rel = abs(grad - fd) / abs(fd)
    print(f"gradient of the central pressure w.r.t. M200 on the card: "
          f"autograd {grad:.6e}, central difference {fd:.6e}, rel {rel:.2e} "
          f"(limit {GRAD_RTOL})")
    check(math.isfinite(grad) and rel < GRAD_RTOL,
          f"gradient {grad} vs central difference {fd}: rel {rel}")
    return grad


# ----------------------------------------------------------------- phase 10
def field_qa(f, g_rms, label, k_window=None):
    """Finite values, the rms against ``g_rms`` (unless None), the
    central-difference divergence over |g| / dx (a divergence-cleaned
    field), and, for ``k_window``, the log-log slope of the x component's
    power spectrum there."""
    gx, gy, gz = f.gx, f.gy, f.gz
    bad = sum(int((~torch.isfinite(g)).sum()) for g in (gx, gy, gz))
    check(bad == 0, f"{label}: {bad} non-finite values")
    rms = math.sqrt(sum(float(torch.sum(g * g, dtype=torch.float64))
                        for g in (gx, gy, gz)) / gx.numel())
    rep = {"nonfinite": bad, "rms": rms}
    if g_rms is not None:
        rep["rms_rel_err"] = abs(rms - g_rms) / g_rms
        check(rep["rms_rel_err"] < FIELD_RMS_RTOL,
              f"{label}: rms {rms} vs {g_rms}")
    if f.divergence_clean and not f.vector_potential:
        div = ((torch.roll(gx, -1, 0) - torch.roll(gx, 1, 0)) / (2 * f.dx)
               + (torch.roll(gy, -1, 1) - torch.roll(gy, 1, 1)) / (2 * f.dy)
               + (torch.roll(gz, -1, 2) - torch.roll(gz, 1, 2)) / (2 * f.dz))
        rep["div_over_grad"] = float(div.abs().max()) / (
            float(gx.abs().mean(dtype=torch.float64)) / f.dx)
        del div
        check(rep["div_over_grad"] < FIELD_DIV_TOL,
              f"{label}: divergence {rep['div_over_grad']}")
    if k_window is not None:
        W = torch.fft.rfftn(gx)
        P = (W.real ** 2 + W.imag ** 2).double()
        del W
        kx, ky, kz = (torch.as_tensor(a, device=f.device)
                      for a in f._compute_waves())
        kk = torch.sqrt(kx ** 2 + ky ** 2 + kz[..., :P.shape[-1]] ** 2)
        sel = (kk > k_window[0]) & (kk < k_window[1])
        lk, lp = torch.log(kk[sel]), torch.log(P[sel])
        lk = lk - lk.mean()
        rep["slope"] = float((lk * (lp - lp.mean())).sum() / (lk * lk).sum())
        del P, kk
        check(-4.5 < rep["slope"] < -3.0, f"{label}: slope {rep['slope']}")
    return rep


def make_field(F, cls, dims, seed, **kw):
    return getattr(F, cls)(FIELD_LE, FIELD_RE, (dims,) * 3, *FIELD_L,
                           FIELD_B_RMS, padding=0.0, prng=seed,
                           dtype=torch.float32, device="cuda", **kw)


def run_fields(F, card):
    """The constant-rms magnetic field at 512^3 and 1024^3 and its vector
    potential, float32, timed, with QA on the card (each a program: the
    first call at a size captures)."""
    from cluster_generator_tpu_torch.core import compiled as C

    torch.cuda.reset_peak_memory_stats()
    f, first_s = timed(lambda: make_field(F, "RandomMagneticField",
                                          FIELD_DIMS, FIELD_SEED))
    peak = torch.cuda.max_memory_allocated() / 2**30
    # between 2 k1 and k0 / 2 the spectrum's log slope runs from -2.9 to
    # -4.0 (-11/3 with the outer-scale bend and the Gaussian cutoff)
    k1, k0 = 2 * math.pi / FIELD_L[1], 2 * math.pi / FIELD_L[0]
    rep = field_qa(f, FIELD_B_RMS, f"field {FIELD_DIMS}^3",
                   (2 * k1, 0.5 * k0))
    del f
    warm = []
    for i in range(1, 4):
        f, s = timed(lambda: make_field(F, "RandomMagneticField", FIELD_DIMS,
                                        FIELD_SEED + i))
        del f
        warm.append(s)
    wall_ms, kern, busy_ms = kernel_profile(
        lambda: make_field(F, "RandomMagneticField", FIELD_DIMS, FIELD_SEED))
    print(f"RandomMagneticField {FIELD_DIMS}^3 float32: first {first_s:.4f} s, "
          f"warm {[round(s, 4) for s in warm]} s, median "
          f"{statistics.median(warm):.4f} s, peak memory {peak:.2f} GiB; "
          f"profiled once: {wall_ms:.1f} ms, {len(kern)} kernel launches, "
          f"device busy {busy_ms:.2f} ms = {busy_ms / wall_ms:.1%} [{card}]")
    print(f"field {FIELD_DIMS}^3 QA:", json.dumps(rep))

    # the 1024^3 program beside the 512^3 one: the peak it adds, what it
    # holds after the call beyond the field it returned (its noise buffer
    # and pool), its QA with that held, then its eager body's peak
    def big():
        return make_field(F, "RandomMagneticField", FIELD_BIG_DIMS,
                          FIELD_SEED)

    def held_beyond(f, base):
        sync()
        torch.cuda.empty_cache()
        return (torch.cuda.memory_reserved() - base - sum(
            g.numel() * g.element_size() for g in (f.gx, f.gy, f.gz))) / 2**30

    # a baseline: a card that holds no program, so that no release during
    # the call moves the memory held after it
    C.clear()
    sync()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved()
    (f, big_s), peak_big = peak_added(lambda: timed(big))
    held = held_beyond(f, base)
    rep = field_qa(f, FIELD_B_RMS, f"field {FIELD_BIG_DIMS}^3")
    del f
    sync()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved()
    with C.eager():
        (f, eager_s), peak_eager = peak_added(lambda: timed(big))
    held_eager = held_beyond(f, base)
    del f
    print(f"RandomMagneticField {FIELD_BIG_DIMS}^3 float32 program: "
          f"{big_s:.4f} s (first at this size: eager warm-up and capture), "
          f"peak memory added {peak_big:.2f} GiB, held after the call "
          f"beyond the field {held:.2f} GiB; its eager body {eager_s:.4f} "
          f"s, peak memory added {peak_eager:.2f} GiB, held after "
          f"{held_eager:.2f} GiB [{card}]; QA:", json.dumps(rep))

    torch.cuda.reset_peak_memory_stats()
    a, vp_first = timed(lambda: make_field(
        F, "RandomMagneticVectorPotential", FIELD_DIMS, FIELD_SEED))
    del a
    a, vp_s = timed(lambda: make_field(
        F, "RandomMagneticVectorPotential", FIELD_DIMS, FIELD_SEED + 1))
    peak = torch.cuda.max_memory_allocated() / 2**30
    rep = field_qa(a, None, f"vector potential {FIELD_DIMS}^3")
    del a
    print(f"RandomMagneticVectorPotential {FIELD_DIMS}^3 float32: first "
          f"{vp_first:.4f} s, again {vp_s:.4f} s, peak memory {peak:.2f} GiB "
          f"[{card}]; finite:", json.dumps(rep))
    curl_check(F)


def curl_check(F):
    """tests/test_fields.py's identity at 128^3, float64, on the card: the
    spectral curl of A equals the continuous-k projection of B on every
    non-Nyquist mode."""
    n = CURL_DIMS
    noise = torch.randn((3, n, n, n), dtype=torch.float64, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(5))
    kw = dict(padding=0.0, noise=noise, dtype=torch.float64, device="cuda")
    B = F.RandomMagneticField(FIELD_LE, FIELD_RE, (n,) * 3, 100.0, 500.0,
                              FIELD_B_RMS, **kw)
    A = F.RandomMagneticVectorPotential(FIELD_LE, FIELD_RE, (n,) * 3, 100.0,
                                        500.0, FIELD_B_RMS, **kw)
    kx, ky, kz = (torch.as_tensor(k, device="cuda")
                  for k in A._compute_waves())
    ah = [torch.fft.fftn(g) for g in (A.gx, A.gy, A.gz)]
    bh = [torch.fft.fftn(g) for g in (B.gx, B.gy, B.gz)]
    curl = [1j * (ky * ah[2] - kz * ah[1]), 1j * (kz * ah[0] - kx * ah[2]),
            1j * (kx * ah[1] - ky * ah[0])]
    curl = [torch.fft.fftn(torch.fft.ifftn(c).real) for c in curl]
    k2 = kx ** 2 + ky ** 2 + kz ** 2
    k2 = torch.where(k2 > 0, k2, 1.0)
    kb = (kx * bh[0] + ky * bh[1] + kz * bh[2]) / k2
    mask = torch.ones((n, n, n), dtype=torch.bool, device="cuda")
    mask[n // 2], mask[:, n // 2], mask[:, :, n // 2] = False, False, False
    scale = float(bh[0][mask].abs().max())
    err = max(float((c - (b - k * kb))[mask].abs().max()) / scale
              for c, b, k in zip(curl, bh, (kx, ky, kz)))
    print(f"vector potential {n}^3 float64: spectral curl A vs projected B, "
          f"max rel {err:.2e} (limit 1e-8)")
    check(err < 1e-8, f"curl A vs B: {err}")


# ----------------------------------------------------------------- phase 11
def scene_models(cg, halos, **dev):
    """Halos ``(M200, c)`` as class-path models with beta = 100 B fields
    (1000-point grids)."""
    models = []
    for m200, conc in halos:
        rhog, rhot = class_profiles(cg, m200, conc, **dev)
        m = cg.ClusterModel.from_dens_and_tden(
            0.1, 1e4, rhog, rhot, stellar_density=0.02 * rhot, **dev)
        m.set_magnetic_field_from_beta(RADIAL_BETA)
        models.append(m)
    return models


def merger_models(cg):
    """The merger's two halos as class-path models."""
    return scene_models(cg, zip(M200, CONC))


def radial_field(F, models, dims, device, noise=None, seed=3):
    return F.RadialRandomMagneticField(
        RADIAL_LE, RADIAL_RE, (dims,) * 3, *RADIAL_L, CENTERS[0], models[0],
        ctr2=CENTERS[1], profile2=models[1], padding=0.1, prng=seed,
        noise=noise, dtype=torch.float64, device=device)


def run_radial_field(cg, F, P, card):
    """A float64 radial magnetic field over the merger IC, attached to its
    gas; card against CPU for a small field and for the sampling."""
    models = merger_models(cg)
    torch.cuda.reset_peak_memory_stats()
    f, first_s = timed(lambda: radial_field(F, models, RADIAL_DIMS, "cuda"))
    f, again_s = timed(lambda: radial_field(F, models, RADIAL_DIMS, "cuda",
                                            seed=4))
    peak = torch.cuda.max_memory_allocated() / 2**30
    dims = tuple(int(n) for n in f.ddims)
    want = RADIAL_DIMS + 2 * math.ceil(0.05 * RADIAL_DIMS)   # 282
    check(dims == (want,) * 3 and f.gx.dtype == torch.float64,
          f"radial field grid {dims} {f.gx.dtype}")
    bad = sum(int((~torch.isfinite(g)).sum()) for g in (f.gx, f.gy, f.gz))
    check(bad == 0, f"radial field: {bad} non-finite values")
    print(f"RadialRandomMagneticField {dims[0]}^3 float64 (two halos): first "
          f"{first_s:.4f} s, again {again_s:.4f} s, peak memory {peak:.2f} "
          f"GiB [{card}]")

    parts, _, ic_s = run_main_path(P)
    _, attach_first = timed(lambda: P.attach_field_to_particles(parts, f))
    parts, attach_s = timed(lambda: P.attach_field_to_particles(parts, f))
    pos = parts["gas", "particle_position"]
    vals = parts["gas", "magnetic_field"]
    check(vals.shape == pos.shape and vals.dtype == torch.float32,
          f"attached field {tuple(vals.shape)} {vals.dtype}")
    inside = torch.ones(pos.shape[0], dtype=torch.bool, device=pos.device)
    for ax, c in enumerate((f.x, f.y, f.z)):
        c = c.to(pos.dtype)
        inside &= (pos[:, ax] >= c[0]) & (pos[:, ax] <= c[-1])
    n_bad = int((~torch.isfinite(vals)).sum())
    n_out = int((~inside).sum())
    out_nonzero = int(vals[~inside].ne(0).sum())
    print(f"attach_field_to_particles: {pos.shape[0]} gas particles of the "
          f"1e7 IC ({ic_s:.3f} s), first {attach_first:.4f} s, again "
          f"{attach_s:.4f} s [{card}]; non-finite {n_bad}, outside the grid "
          f"{n_out}, nonzero values outside {out_nonzero}")
    check(n_bad == 0 and out_nonzero == 0 and n_out > 0,
          "attached field: non-finite, or nonzero outside the grid")
    check(bool(vals[inside].ne(0).any(dim=1).all()),
          "attached field: a zero value inside the grid")

    cp = cg.ClusterParticles("gas", {
        ("gas", "particle_position"): pos,
        ("gas", "particle_velocity"): parts["gas", "particle_velocity"],
        ("gas", "particle_mass"): parts["gas", "particle_mass"]},
        device="cuda")
    _, map_s = timed(lambda: f.map_field_to_particles(cp, "gas"))
    mapped = cp["gas", "magnetic_field"]
    err = float((mapped - vals.double()).abs().max()) / float(
        vals.abs().max())
    print(f"map_field_to_particles onto ClusterParticles (float64): "
          f"{map_s:.4f} s; max |map - attach| / max |B| {err:.2e}")
    check(mapped.dtype == torch.float64 and err < TRILINEAR_TOL,
          f"map_field_to_particles vs attach: {err}")

    # the trilinear sampling, card against CPU, as attach runs it
    gen = torch.Generator().manual_seed(8)
    pts = (torch.rand((TRILINEAR_POINTS, 3), generator=gen) * 9000.0
           - 4500.0).to(torch.float32)
    from cluster_generator_tpu_torch.fields.grf import _trilinear

    g32 = torch.stack([f.gx, f.gy, f.gz]).to(torch.float32)
    xyz = [c.to(torch.float32) for c in (f.x, f.y, f.z)]
    on_card = _trilinear(*xyz, g32, pts.cuda()).cpu()
    on_cpu = _trilinear(*(c.cpu() for c in xyz), g32.cpu(), pts)
    terr = float((on_card - on_cpu).abs().max()) / float(g32.abs().max())
    print(f"trilinear at {TRILINEAR_POINTS} points, card vs CPU: max |diff| "
          f"/ max |B| {terr:.2e} (limit {TRILINEAR_TOL})")
    check(terr < TRILINEAR_TOL, f"trilinear card vs CPU {terr}")
    del parts, vals, cp, mapped, f, g32

    # a small float64 field from the same noise on both devices
    n = RADIAL_CPU_DIMS + 2 * math.ceil(0.05 * RADIAL_CPU_DIMS)
    noise = torch.randn((3, n, n, n), dtype=torch.float64,
                        generator=torch.Generator().manual_seed(9))
    worst = {}
    for name, make in (
            ("radial", lambda dev, z: radial_field(F, models, RADIAL_CPU_DIMS,
                                                  dev, noise=z)),
            ("vector_potential", lambda dev, z: F.RandomMagneticVectorPotential(
                RADIAL_LE, RADIAL_RE, (RADIAL_CPU_DIMS,) * 3, *RADIAL_L,
                FIELD_B_RMS, noise=z, dtype=torch.float64, device=dev))):
        a, b = make("cuda", noise.cuda()), make("cpu", noise)
        worst[name] = max(float((ga.cpu() - gb).abs().max())
                          / float(gb.abs().max())
                          for ga, gb in ((a.gx, b.gx), (a.gy, b.gy),
                                         (a.gz, b.gz)))
    print(f"{n}^3 float64 fields, card vs CPU from the same noise, max |diff| "
          f"/ max |g|:", json.dumps({k: f"{v:.2e}" for k, v in worst.items()}),
          f"(limit {RADIAL_CPU_RTOL})")
    check(all(v < RADIAL_CPU_RTOL for v in worst.values()),
          f"fields card vs CPU: {worst}")


# ----------------------------------------------------------------- phase 12
def scene_params(MG, n):
    return MG.sample_merger_scene_params(
        torch.Generator(device="cuda").manual_seed(SCENE_SEED), n)


def run_scenes(MG, K, S, D, card):
    """The merger-scene batches at cfg6; returns K1's launches on each of
    the three runs and the speed-CDF kernel's; the datagen's draw kernel
    must not launch."""
    p = scene_params(MG, SCENES)
    per_scene = sum(sum(v) for v in SCENE_COUNTS.values())
    launches, cdf = {}, {}

    def stream(n, label, **extra):
        sub = {k: v[:n] for k, v in p.items()}
        torch.cuda.reset_peak_memory_stats()
        K.invert_cdf_rows.launches = S.speed_cdf_rows_f32.launches = 0
        D.draw_collisionless.launches = D.draw_gas.launches = 0
        sync()
        t0 = time.perf_counter()
        outs = list(MG.merger_scene_batches(
            sub, SCENE_COUNTS, batch_size=SCENE_BATCH,
            num_points=SCENE_POINTS, r_max=R_MAX, seed=SCENE_SEED,
            device="cuda", **extra))
        sync()
        launches[label] = K.invert_cdf_rows.launches
        cdf[label] = S.speed_cdf_rows_f32.launches
        drawn = D.draw_collisionless.launches + D.draw_gas.launches
        check(drawn == 0, f"{label}: the datagen's draw kernel launched "
                          f"{drawn} times")
        return (time.perf_counter() - t0, outs,
                torch.cuda.max_memory_allocated() / 2**30)

    def qa(b0, out, label, r_a=None):
        sl = slice(b0, b0 + SCENE_BATCH)
        ctr, vel = MG.binary_scene_geometry(p["M200"][sl], p["d"][sl],
                                            p["b"][sl], p["v_rel"][sl])
        rep = MG.verify_scene_batch(out, p["M200"][sl], p["conc"][sl], ctr,
                                    vel, R_MAX, SCENE_COUNTS,
                                    num_points=SCENE_POINTS, r_a=r_a,
                                    strict=False)
        bad = rep.pop("nonfinite")
        print(f"{label}: non-finite values per output:", json.dumps(bad))
        print(f"{label}: QA", json.dumps(rep))
        check(not rep["violations"] and not any(bad.values()),
              f"{label}: {rep['violations'][:5]} {bad}")

    first_s, outs, peak = stream(SCENE_BATCH, "scenes_first")
    print(f"scene batch first ({SCENE_BATCH} binary scenes x {per_scene} "
          f"particles): {first_s:.3f} s; K1 launches "
          f"{launches['scenes_first']}; peak memory {peak:.2f} GiB [{card}]")
    check(launches["scenes_first"] == 2 and cdf["scenes_first"] == 2,
          f"launches per scene batch: K1 {launches['scenes_first']}, speed "
          f"CDF {cdf['scenes_first']}, want 2 each")
    qa(0, outs[0][1], "scene batch 0")
    del outs

    total_s, outs, peak = stream(SCENES, "scenes")
    n_b = len(outs)
    print(f"scene stream, warm: {n_b} batches in {total_s:.3f} s = "
          f"{total_s / n_b:.4f} s per batch, {SCENES / total_s:.1f} scenes/s, "
          f"{SCENES * per_scene / total_s:.4g} particles/s; K1 launches "
          f"{launches['scenes']} ({launches['scenes'] / n_b:g} per batch); "
          f"peak memory {peak:.2f} GiB with {n_b} batches of output held "
          f"[{card}]")
    check(launches["scenes"] == 2 * n_b == cdf["scenes"],
          f"launches: K1 {launches['scenes']}, speed CDF {cdf['scenes']}, "
          f"want {2 * n_b} each")
    for b0, out in outs:
        qa(b0, out, f"scene batch {b0}")
    del outs

    om_s, outs, peak = stream(SCENE_BATCH, "scenes_om",
                              anisotropy_radius=SCENE_R_A)
    print(f"scene Osipkov-Merritt batch (r_a = {SCENE_R_A:g} kpc): "
          f"{om_s:.3f} s; K1 launches {launches['scenes_om']}; peak memory "
          f"{peak:.2f} GiB [{card}]")
    check(launches["scenes_om"] == 2 and cdf["scenes_om"] == 2,
          f"launches of the OM batch: K1 {launches['scenes_om']}, speed CDF "
          f"{cdf['scenes_om']}, want 2 each")
    qa(0, outs[0][1], "scene OM batch", r_a=SCENE_R_A)
    return launches, cdf


# ------------------------------------------------------------ phases 13, 14
def ic_geometry(cg, n_halos):
    """Centers and bulk velocities of the two- or three-halo scene."""
    c1, c2 = cg.compute_centers_for_binary(IC_CENTER, IC_D, IC_B)
    centers = [c1, c2, THIRD_CENTER][:n_halos]
    velocities = [VELOCITIES[0], VELOCITIES[1], THIRD_VELOCITY][:n_halos]
    return centers, velocities


def ic_draws(I, models, counts, seed):
    """Each halo's particles about its own center, one generator per
    species and halo from ``seed``."""
    base = torch.Generator(device=models[0].device).manual_seed(seed)
    return [I.draw_halo_particles(m, {k: counts[k][i] for k in counts},
                                  R_MAX, generators=I.halo_generators(base))
            for i, m in enumerate(models)]


def ic_combine(PA, halos, models, centers, velocities):
    fn = (PA.combine_two_clusters if len(halos) == 2
          else PA.combine_three_clusters)
    return fn(*halos, *models, *centers, *velocities)


def ic_resample(PA, scene, models, centers, velocities):
    fn = (PA.resample_two_clusters if len(models) == 2
          else PA.resample_three_clusters)
    return fn(scene, *models, *centers, *velocities, [R_MAX] * len(models),
              passive_scalars=["metallicity"])


def ic_scene_density_qa(scene, models, centers):
    """The mixed gas density at ``IC_QA_POINTS`` particles against the sum
    of the halos' densities recomputed in float64 by scipy's not-a-knot
    spline on the host; returns the largest relative difference."""
    import numpy as np
    from scipy.interpolate import CubicSpline

    n = scene.num_particles["gas"]
    idx = torch.linspace(0, n - 1, IC_QA_POINTS,
                         device=scene.device).round().long()
    pos = scene["gas", "particle_position"][idx].cpu().numpy()
    got = scene["gas", "density"][idx].cpu().numpy()
    want = np.zeros(IC_QA_POINTS)
    for m, c in zip(models, centers):
        rr, dens = m["radius"].cpu().numpy(), m["density"].cpu().numpy()
        r = np.clip(np.linalg.norm(pos - np.asarray(c), axis=1), rr[0],
                    rr[-1])
        want += CubicSpline(rr, dens)(r)
    return float(np.max(np.abs(got - want) / want))


def ic_scene_qa(halos, scene, counts, centers, velocities, label):
    """Counts, finiteness and bulk velocities of a combined scene; returns
    the numbers it checked."""
    n_h = len(halos)
    rep = {"nonfinite": sum(int((~torch.isfinite(v)).sum())
                            for v in scene.fields.values())}
    check(rep["nonfinite"] == 0, f"{label}: non-finite values {rep}")
    for sp, total in IC_TOTALS.items():
        got = [h.num_particles.get(sp, 0) for h in halos]
        check(got == counts[sp], f"{label} {sp}: drawn {got} != pro-rated "
              f"{counts[sp]}")
        check(abs(sum(got) - total) <= n_h,
              f"{label} {sp}: {sum(got)} of {total} in all")
        check(scene.num_particles[sp] == sum(got),
              f"{label} {sp}: scene holds {scene.num_particles[sp]}")
    sig = 0.0
    for sp in ("dm", "star", "tracer"):
        v = scene[sp, "particle_velocity"]
        off = 0
        for n, want in zip(counts[sp], velocities):
            blk = v[off:off + n]
            off += n
            mean = blk.mean(dim=0)
            se = blk.std(dim=0) / math.sqrt(n)
            dev = (mean - torch.tensor(want, dtype=v.dtype,
                                       device=v.device)).abs()
            check(bool((dev <= IC_SIGMAS * se + 1e-12).all()),
                  f"{label} {sp}: bulk {mean.tolist()} vs {want} "
                  f"(se {se.tolist()})")
            if sp != "tracer":
                sig = max(sig, float((dev / se).max()))
    rep["bulk_velocity_max_sigmas"] = sig
    gv = scene["gas", "particle_velocity"]
    bulk = torch.tensor(velocities, dtype=gv.dtype, device=gv.device)
    out = ((gv < bulk.min(dim=0).values - 1e-12)
           | (gv > bulk.max(dim=0).values + 1e-12))
    rep["gas_velocity_outside_hull"] = int(out.any(dim=1).sum())
    check(rep["gas_velocity_outside_hull"] == 0,
          f"{label}: mixed gas velocities outside the bulk hull")
    return rep


def ic_gadget_qa(full, blocks, n_in, table, bg, centers, label):
    """Gadget IDs 1..N once each, MassTable as the float32 first mass,
    every background cell outside every halo."""
    import numpy as np

    ids = np.concatenate([b["ParticleIDs"] for b in blocks.values()])
    check(ids.dtype == np.uint32 and ids.size == sum(n_in.values())
          and np.array_equal(ids, np.arange(1, ids.size + 1,
                                            dtype=np.uint32)),
          f"{label}: Gadget IDs are not 1..N")
    for sp, slot in (("dm", 1), ("star", 4)):
        first = int(torch.nonzero(full._clip_to_box(sp, IC_BOX))[0])
        want = np.float64(np.float32(
            float(full[sp, "particle_mass"][first]) / 1e10))
        check(table[slot] == want and blocks[sp]["Masses"].dtype
              == np.float32, f"{label}: MassTable[{slot}] {table[slot]} "
              f"!= {want}")
    pos = bg["gas", "particle_position"]
    gap = min(float(((pos - torch.as_tensor(c, dtype=pos.dtype,
                                            device=pos.device)) ** 2)
                    .sum(dim=1).min().sqrt()) - R_MAX for c in centers)
    check(pos.shape[0] > 0 and gap > 0.0,
          f"{label}: a background cell within r_max ({gap} kpc)")
    return {"ids": int(ids.size), "mass_table": table.tolist(),
            "background_cells": int(pos.shape[0]),
            "background_min_gap_kpc": gap}


def run_ic_scene(cg, I, PA, CO, K, card, n_halos):
    """The IC scene of ``n_halos`` halos at 1.05e7 particles, every step
    first and warm; returns K1's launches over the phase (one per species
    and model: none on the second draw at the same r_max)."""
    import numpy as np
    from scipy.io import FortranFile

    label = f"IC scene {n_halos} halos"
    halos_def = list(zip(M200, CONC)) + [THIRD_HALO]
    torch.cuda.reset_peak_memory_stats()
    K.invert_cdf_rows.launches = 0
    models, model_s = timed(lambda: scene_models(cg, halos_def[:n_halos]))
    centers, velocities = ic_geometry(cg, n_halos)
    r_max = [R_MAX] * n_halos
    counts, count_s = timed(lambda: I.halo_particle_counts(
        models, r_max, IC_TOTALS))
    times = {"models": model_s, "counts": count_s}
    first, times["draws_first"] = timed(lambda: ic_draws(I, models, counts,
                                                         n_halos))
    launched = K.invert_cdf_rows.launches
    warm, times["draws_warm"] = timed(lambda: ic_draws(I, models, counts,
                                                       10 + n_halos))
    check(K.invert_cdf_rows.launches == launched,
          f"{label}: the second draw launched K1")
    scene, times["combine_first"] = timed(lambda: ic_combine(
        PA, first, models, centers, velocities))
    scene_b, times["combine_warm"] = timed(lambda: ic_combine(
        PA, warm, models, centers, velocities))
    rep = ic_scene_qa(first, scene, counts, centers, velocities, label)
    rep["density_max_rel_err"] = ic_scene_density_qa(scene, models, centers)
    check(rep["density_max_rel_err"] < IC_DENSITY_RTOL,
          f"{label}: mixed density vs scipy {rep['density_max_rel_err']}")

    for m in models:
        m.set_field("metallicity", torch.linspace(
            1.0, 0.1, m.num_elements, dtype=torch.float64, device="cuda"))
    for sc in (scene, scene_b):
        sc.set_field("gas", "metallicity",
                     torch.zeros(sc.num_particles["gas"], device="cuda"),
                     passive_scalar=True)
    mass0 = scene["gas", "particle_mass"].clone()
    _, times["resample_first"] = timed(lambda: ic_resample(
        PA, scene, models, centers, velocities))
    _, times["resample_warm"] = timed(lambda: ic_resample(
        PA, scene_b, models, centers, velocities))
    # the particles did not move: the resample finds the same density, so
    # the masses keep their values
    rep["resample_mass_max_rel_change"] = float(
        ((scene["gas", "particle_mass"] - mass0).abs() / mass0).max())
    z = scene["gas", "metallicity"]
    check(rep["resample_mass_max_rel_change"] < 1e-12
          and bool(torch.isfinite(z).all()) and float(z.min()) >= 0.1 - 1e-12
          and float(z.max()) <= 1.0 + 1e-12,
          f"{label}: resample {rep}, metallicity [{float(z.min())}, "
          f"{float(z.max())}]")
    del scene_b, warm, mass0

    def background():
        bg = CO._arepo_background(centers, r_max, IC_BOX, AREPO_NX, scene)
        return bg, scene + cg.ClusterParticles.from_fields(bg,
                                                           device="cuda")

    _, times["background_first"] = timed(background)
    (bg, full), times["background_warm"] = timed(background)
    _, times["gadget_blocks_first"] = timed(lambda: full.gadget_blocks(
        IC_BOX, code="arepo"))
    (blocks, n_in, table), times["gadget_blocks_warm"] = timed(
        lambda: full.gadget_blocks(IC_BOX, code="arepo"))
    rep.update(ic_gadget_qa(full, blocks, n_in, table, bg, centers, label))
    rep["gadget_bytes"] = sum(a.nbytes for b in blocks.values()
                              for a in b.values())
    del blocks, full, bg

    with tempfile.TemporaryDirectory() as d:
        fn = os.path.join(d, "halo_part.dat")

        def write():
            CO.write_amr_particles(scene, fn, ["dm"], {"dm": 1},
                                   format="fortran", in_cgs=True)

        _, times["fortran_dm_first"] = timed(write)
        _, times["fortran_dm_warm"] = timed(write)
        with FortranFile(fn, "r") as f:
            n = int(f.read_ints()[0])
            rec = f.read_reals().reshape(n, 7)
    want = torch.cat([scene["dm", "particle_position"]
                      * CO._cgs_factor("particle_position"),
                      scene["dm", "particle_velocity"]
                      * CO._cgs_factor("particle_velocity"),
                      (scene["dm", "particle_mass"]
                       * CO._cgs_factor("particle_mass"))[:, None]],
                     dim=1).cpu().numpy()
    check(n == scene.num_particles["dm"] and np.array_equal(rec, want),
          f"{label}: the Fortran record does not read back exactly")
    rep["fortran_dm_bytes"] = int(rec.nbytes)
    launches = K.invert_cdf_rows.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"{label} ({sum(IC_TOTALS.values())} particles, counts "
          f"{json.dumps(dict(counts))}), seconds:",
          json.dumps({k: round(v, 4) for k, v in times.items()}),
          f"[{card}]")
    print(f"{label}: QA", json.dumps(rep))
    print(f"{label}: peak memory {peak:.2f} GiB; K1 launches {launches} "
          f"[{card}]")
    check(launches == 2 * n_halos,
          f"{label}: K1 launches {launches}, want {2 * n_halos}")
    return launches


def ic_device_agreement(cg, I, PA, counts=IC_CPU_COUNTS):
    """The same particles (drawn on the CPU) through combine_two_clusters
    and resample_two_clusters on the card and on the CPU; returns max
    |card - CPU| / max |CPU| per stage and field."""
    models = scene_models(cg, zip(M200, CONC), device="cpu")
    centers, velocities = ic_geometry(cg, 2)
    for m in models:
        m.set_field("metallicity", torch.linspace(
            1.0, 0.1, m.num_elements, dtype=torch.float64))
    host = [h.to_numpy() for h in ic_draws(
        I, models, I.halo_particle_counts(models, [R_MAX] * 2, counts), 3)]
    out = {}
    for dev in ("cuda", "cpu"):
        halos = [cg.ClusterParticles.from_fields(
            {k: torch.from_numpy(v.copy()).to(dev) for k, v in h.items()},
            device=dev) for h in host]
        scene = ic_combine(PA, halos, models, centers, velocities)
        combined = {k: v.clone() for k, v in scene.fields.items()}
        scene.set_field("gas", "metallicity",
                        torch.zeros(scene.num_particles["gas"]),
                        passive_scalar=True)
        # relaxed: the gas moved, so the resample writes new values
        scene["gas", "particle_position"] = (
            scene["gas", "particle_position"] * 1.001)
        ic_resample(PA, scene, models, centers, velocities)
        out[dev] = {"combine": combined, "resample": scene.fields}
    errs = {}
    for stage, want in out["cpu"].items():
        for k, b in want.items():
            a = out["cuda"][stage][k]
            check(a.is_cuda, f"card vs CPU: {stage} {k} left the card")
            errs[f"{stage}/{k[0]}/{k[1]}"] = float(
                (a.cpu() - b).abs().max() / b.abs().max().clamp_min(1e-300))
    return errs


# -------------------------------------------------------------------- main
# ------------------------------------------------------------ phases 15-17
def copy_alone(tensors):
    """Seconds of one batch's copy to pinned host memory through the
    staging ring (best of three: the first two allocate its buffers)."""
    from cluster_generator_tpu_torch.core.staging import _Ring

    ring = _Ring(tensors[0].device)
    best = math.inf
    for _ in range(3):
        sync()
        t0 = time.perf_counter()
        ring.finish(ring.stage(tensors))
        best = min(best, time.perf_counter() - t0)
    return best


def count_syncs(fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("warn")``: the
    synchronizing calls it made, as ``{file:line: count}`` of the innermost
    frame in the port (else in this script) that made each; a sync made
    anywhere under a program call (a ``__call__`` of ``core/compiled.py``)
    has IN_PROGRAM appended to its key."""
    import traceback
    import warnings

    root = os.path.dirname(os.path.abspath(__file__))
    port = os.path.join(root, "cluster_generator_tpu_torch")
    compiled = os.path.join(port, "core", "compiled.py")
    where = {}

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        stack = traceback.extract_stack()[:-1]
        if any(f.name == "set_sync_debug_mode" for f in stack):
            return  # the first switch of the debug mode itself
        frames = ([f for f in stack if f.filename.startswith(port)]
                  or [f for f in stack if f.filename.startswith(root)]
                  or stack)
        key = f"{os.path.relpath(frames[-1].filename, root)}:" \
              f"{frames[-1].lineno}"
        if any(f.name == "__call__" and f.filename == compiled
               for f in stack):
            key += IN_PROGRAM
        where[key] = where.get(key, 0) + 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return where


def no_copy_ring():
    """The staging ring with its copies taken out: the same events, waits
    and schedule, no bytes moved (what the overlapped stream would take if
    the copies cost nothing)."""
    from cluster_generator_tpu_torch.core import staging

    class NoCopyRing(staging._Ring):
        def stage(self, tensors, ready=None):
            ready = self.ready() if ready is None else ready
            done = torch.cuda.Event()
            with torch.cuda.stream(self.stream):
                self.stream.wait_event(ready)
                done.record(self.stream)
            return None, [], [], done

        @staticmethod
        def finish(staged):
            staged[3].synchronize()
            return []

    return NoCopyRing


def interleaved(stream, compute, host_s, reps=7):
    """``reps`` turns, each running the batch programs alone, the stream
    with its copies taken out and the overlapped stream, the last two in
    alternating order (host-bound eager programs drift by ~5% between
    turns, more than a copy): the median seconds of each, the median of
    each turn's overlapped minus copy-free stream, the median host work
    and the programs' last output."""
    from cluster_generator_tpu_torch.core import staging

    plain, dry = staging._Ring, no_copy_ring()

    def copy_free():
        staging._Ring = dry
        try:
            return timed(lambda: stream(consume=False))[1]
        finally:
            staging._Ring = plain

    runs = {"compute": [], "no_copy": [], "wall": [], "host": [],
            "cost": []}
    for turn in range(reps):
        out, t = timed(compute)
        runs["compute"].append(t)
        if turn % 2:
            wall, host = timed(stream)[1], host_s[0]
            dry_s = copy_free()
        else:
            dry_s = copy_free()
            wall, host = timed(stream)[1], host_s[0]
        runs["no_copy"].append(dry_s)
        runs["wall"].append(wall)
        runs["host"].append(host)
        runs["cost"].append(wall - dry_s)
    return {k: statistics.median(v) for k, v in runs.items()}, out


def overlap_report(label, card, n_batches, med, copy_s, nbytes, syncs):
    """Print per batch the programs alone, the same stream with its copies
    taken out, the copy alone, the host's own work on a batch (the
    consumer's loop body), the overlapped stream's wall and what the copies
    cost it (the median of each turn's difference).  The overlap holds when
    the copies cost less than the copy alone."""
    per = {k: v / n_batches for k, v in med.items()}
    print(f"{label}: per batch programs alone {per['compute']:.4f} s, the "
          f"stream without its copies {per['no_copy']:.4f} s, copy alone "
          f"{copy_s:.4f} s ({nbytes / 1e9:.3f} GB at "
          f"{nbytes / copy_s / 1e9:.2f} GB/s to pinned memory), host work "
          f"{per['host']:.4f} s, overlapped stream {per['wall']:.4f} s "
          f"({n_batches} batches, medians of seven turns): the copies cost "
          f"{per['cost']:+.4f} s per batch; overlap "
          f"{'holds' if per['cost'] < copy_s else 'FAILS'} (cost < copy "
          f"alone); synchronizing calls in one stream: "
          f"{sum(syncs.values())} {json.dumps(syncs)} [{card}]")


def run_catalog(E, K, PA, card, n_clusters=CATALOG_CLUSTERS,
                batch=DATAGEN_BATCH, points=DATAGEN_POINTS,
                counts=DATAGEN_COUNTS, dev="cuda"):
    """The ensemble catalog's device stage at cfg5c: the batch program,
    the staging into pinned host memory, the writer's per-cluster split
    into the catalog's layout (no ``h5py``), first and warm; the verifier's
    checks on one batch against models rebuilt at once on the card; the
    particle bridge for one cluster.  Returns K1's launches in the warm
    stream."""
    label = f"catalog stream ({n_clusters} clusters of {counts})"
    M, c = E.sample_ensemble_params(
        torch.Generator(device=dev).manual_seed(CATALOG_SEED), n_clusters,
        device=dev)
    M_host, c_host = M.cpu().numpy(), c.cpu().numpy()
    _, _, prog = E._resolve_batch_fn(dict(counts), points)
    b0s = list(range(0, n_clusters, batch))
    bad = torch.zeros((), dtype=torch.int64, device=dev)

    def counted(Mb, cb, gen):
        # non-finite values counted on the card, read after the stream
        out = prog(Mb, cb, gen)
        for arrays in out.values():
            for a in arrays:
                bad.add_((~torch.isfinite(a)).sum())
        return out

    host_s = [0.0]

    def stream(fn=counted, consume=True):
        groups = 0
        host_s[0] = 0.0
        for b0, host in E._catalog_batches(M, c, fn, batch, CATALOG_SEED,
                                           b0s):
            if not consume:
                continue
            t0 = time.perf_counter()
            for _, attrs, data in E._cluster_records(
                    True, b0, M_host[b0:b0 + batch], c_host[b0:b0 + batch],
                    host):
                groups += len(data) > 0
            host_s[0] += time.perf_counter() - t0
        return groups

    torch.cuda.reset_peak_memory_stats()
    groups, first_s = timed(stream)
    K.invert_cdf_rows.launches = 0
    groups, warm_s = timed(stream)
    launches = K.invert_cdf_rows.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_bad = int(bad)
    print(f"{label}: first {first_s:.3f} s, warm {warm_s:.3f} s = "
          f"{n_clusters / warm_s:.1f} clusters/s; {groups} cluster records; "
          f"K1 launches {launches}; non-finite values {n_bad}; peak memory "
          f"{peak:.2f} GiB [{card}]")
    check(groups == n_clusters, f"{label}: {groups} records")
    check(launches == 2 * len(b0s),
          f"{label}: K1 launches {launches}, want {2 * len(b0s)}")
    check(n_bad == 0, f"{label}: {n_bad} non-finite values")

    def compute():
        for b0 in b0s:
            out = prog(M[b0:b0 + batch], c[b0:b0 + batch],
                       E._batch_generator(CATALOG_SEED, b0, M.device))
        return out

    med, out = interleaved(stream, compute, host_s)
    _, tensors = E._flat_outputs(out)
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    copy_s = copy_alone(tensors)
    del out, tensors
    syncs = count_syncs(stream)
    overlap_report(label, card, len(b0s), med, copy_s, nbytes, syncs)

    report = E._new_report()
    for b0, host in E._catalog_batches(M, c, prog, batch, CATALOG_SEED, [0]):
        items = [(i, E._record_dict(r)) for i, r in enumerate(
            E._cluster_records(True, b0, M_host[:batch], c_host[:batch],
                               host))]
        fields, rebuild_s = timed(lambda: E._rebuild_fields(
            M[:batch], c[:batch], points, "newtonian", dev))
        t0 = time.perf_counter()
        E._check_clusters(items, fields, report)
        check_s = time.perf_counter() - t0
        p = PA.ClusterParticles.from_fields(
            E._cluster_particle_fields(items[0][1]), device=dev)
    print(f"{label}: verify_catalog's checks on batch 0 ({batch} clusters, "
          f"models rebuilt at once in {rebuild_s:.3f} s, host checks "
          f"{check_s:.2f} s [{card}]):", json.dumps(report))
    check(report["n_clusters_checked"] == batch and not report["violations"],
          f"{label}: QA {report['violations'][:5]}")
    check(p.num_particles == dict(counts) and p.device.type == M.device.type
          and all(bool(torch.isfinite(v).all()) for v in p.fields.values()),
          f"{label}: catalog_to_particles gave {p}")
    print(f"{label}: catalog_to_particles' mapping of cluster 0: {p}")
    return launches


def run_merger_catalog(MG, K, PA, card, n_scenes=SCENES, batch=SCENE_BATCH,
                       points=SCENE_POINTS, counts=SCENE_COUNTS, dev="cuda"):
    """The merger catalog's device stage at cfg6: the scene-batch program,
    the staging, the per-scene split into the catalog's layout, first and
    warm; the verifier's checks on one batch against every halo rebuilt at
    once on the card; ``scene_to_particles``' mapping of one scene.
    Returns K1's launches in the warm stream."""
    from cluster_generator_tpu_torch.parallel.ensemble import _record_dict

    label = f"merger catalog stream ({n_scenes} binary scenes)"
    p = MG.sample_merger_scene_params(
        torch.Generator(device=dev).manual_seed(SCENE_SEED), n_scenes,
        device=dev)
    M, c, ctr, vel = MG._scene_inputs(p, torch.device(dev))
    host = [MG._host(a) for a in (M, c, ctr, vel)]
    counts = MG._normalize_counts(counts, 2)
    prog = MG._merger_batch_fn(points, counts["gas"], counts["dm"],
                               counts["star"], device=dev)
    r_max = torch.full((2,), R_MAX, dtype=torch.float64, device=dev)
    b0s = list(range(0, n_scenes, batch))
    bad = torch.zeros((), dtype=torch.int64, device=dev)

    def counted(*args):
        out = prog(*args)
        for a in out.values():
            bad.add_((~torch.isfinite(a)).sum())
        return out

    host_s = [0.0]

    def stream(fn=counted, consume=True):
        groups = 0
        host_s[0] = 0.0
        for b0, out in MG._scene_batches(fn, M, c, ctr, vel, r_max, batch,
                                         SCENE_SEED, b0s):
            if not consume:
                continue
            t0 = time.perf_counter()
            sl = slice(b0, b0 + batch)
            for _, attrs, data in MG._scene_records(
                    b0, *(a[sl] for a in host), out):
                groups += len(data) > 0
            host_s[0] += time.perf_counter() - t0
        return groups

    torch.cuda.reset_peak_memory_stats()
    groups, first_s = timed(stream)
    K.invert_cdf_rows.launches = 0
    groups, warm_s = timed(stream)
    launches = K.invert_cdf_rows.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_bad = int(bad)
    print(f"{label}: first {first_s:.3f} s, warm {warm_s:.3f} s = "
          f"{n_scenes / warm_s:.1f} scenes/s; {groups} scene records; K1 "
          f"launches {launches}; non-finite values {n_bad}; peak memory "
          f"{peak:.2f} GiB [{card}]")
    check(groups == n_scenes, f"{label}: {groups} records")
    check(launches == 2 * len(b0s),
          f"{label}: K1 launches {launches}, want {2 * len(b0s)}")
    check(n_bad == 0, f"{label}: {n_bad} non-finite values")

    def compute():
        for b0 in b0s:
            sl = slice(b0, b0 + batch)
            out = prog(M[sl], c[sl], ctr[sl], vel[sl], r_max,
                       MG._batch_generator(SCENE_SEED, b0, M.device))
        return out

    med, out = interleaved(stream, compute, host_s)
    tensors = list(out.values())
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    copy_s = copy_alone(tensors)
    del out, tensors
    syncs = count_syncs(stream)
    overlap_report(label, card, len(b0s), med, copy_s, nbytes, syncs)

    report = MG._merger_report()
    for b0, out in MG._scene_batches(prog, M, c, ctr, vel, r_max, batch,
                                     SCENE_SEED, [0]):
        items = [(i, _record_dict(r)) for i, r in enumerate(
            MG._scene_records(b0, *(a[:batch] for a in host), out))]
        fields, rebuild_s = timed(lambda: MG._rebuild_halos(
            host[0][:batch], host[1][:batch], points, "newtonian", dev))
        t0 = time.perf_counter()
        MG._check_scenes(items, fields, counts, r_max.cpu().numpy(), report)
        check_s = time.perf_counter() - t0
        parts = PA.ClusterParticles.from_fields(
            MG._scene_particle_fields(items[0][1], counts), device=dev)
    print(f"{label}: verify_merger_catalog's checks on batch 0 ({batch} "
          f"scenes, halos rebuilt at once in {rebuild_s:.3f} s, host checks "
          f"{check_s:.2f} s [{card}]):", json.dumps(report))
    check(report["n_scenes_checked"] == batch and not report["violations"],
          f"{label}: QA {report['violations'][:5]}")
    want = {sp: sum(n) for sp, n in counts.items() if sum(n)}
    check(parts.num_particles == want
          and all(bool(torch.isfinite(v).all())
                  for v in parts.fields.values()),
          f"{label}: scene_to_particles gave {parts}")
    print(f"{label}: scene_to_particles' mapping of scene 0: {parts}")
    return launches


def grid_picks(n_side):
    """16 chunks of an n_side^3 chunkmap as ``(index, (i, j, k))``: the 8
    corners first, then the two chunks that meet at the centre and 6 more
    spread through the box."""
    half = n_side // 2
    ijk = [(i, j, k) for i in (0, n_side - 1) for j in (0, n_side - 1)
           for k in (0, n_side - 1)]
    ijk += [(half - 1,) * 3, (half,) * 3]
    ijk += [(1, half, n_side - 2), (half, 1, 2), (n_side - 2, half - 1, 1),
            (2, n_side - 3, half), (half + 1, half - 2, n_side - 1),
            (n_side - 1, 2, half - 3)]
    return [((i * n_side + j) * n_side + k, (i, j, k)) for i, j, k in ijk]


def run_grid(cg, DS, card, dims=GRID_DIMS, chunk=GRID_CHUNK,
             batch=GRID_BATCH, points=CLASS_POINTS, dev="cuda"):
    """The chunked grid's painter over the class-path model (beta 100, bulk
    velocity GRID_VELOCITY): every field of the file, f8 then f4, through
    the painter's stream into host memory (no file), the density's three
    momentum copies scaled on the host as the writer scales them; each
    batch reduced to a checksum and the 16 picked chunks.  Checks those
    chunks against the same function on the CPU, the corners against the
    boundary value, finiteness; prints paint alone, copy alone and the
    overlapped stream per field."""
    import numpy as np

    from cluster_generator_tpu_torch.core.interp import (cubic_spline,
                                                          spline_eval)

    kw = {} if dev == "cuda" else {"device": dev}
    m = build_class_model(cg, num_points=points, **kw)
    m.set_magnetic_field_from_beta(GRID_BETA)
    n_side = dims // chunk
    starts = DS.construct_chunks([dims] * 3, chunk)[:, 0, :].T.astype(
        np.float64)
    deltas = np.full(3, GRID_BOX / dims)
    left = np.full(3, -GRID_BOX / 2.0)
    picked = grid_picks(n_side)
    picks = [p for p, _ in picked]
    # each corner chunk's outermost cell, in the z-first block layout
    corner_cells = [tuple(0 if a == 0 else -1 for a in (k, j, i))
                    for _, (i, j, k) in picked[:8]]
    out = {}
    for dtype in ("f8", "f4"):
        f32 = dtype == "f4"
        for name in GRID_FIELDS:
            y = DS.YTHDF5._model_field(m, name)
            sp = cubic_spline(m["radius"], y)
            factors = (list(GRID_VELOCITY) if name == "density" else [])
            label = f"grid {dims}^3 {dtype} {name}"
            sums, got, host_s = [], {}, [0.0]

            def stream():
                scratch = None
                host_s[0] = 0.0
                for i0, blocks in DS._paint_blocks(sp, starts, deltas, left,
                                                   chunk, batch=batch,
                                                   f32=f32):
                    t0 = time.perf_counter()
                    for fac in factors:
                        if scratch is None:
                            scratch = np.empty_like(blocks)
                        sums.append(float(np.multiply(blocks, fac,
                                                      out=scratch).sum()))
                    sums.append(float(blocks.sum(dtype=np.float64)))
                    for p in picks:
                        if i0 <= p < i0 + blocks.shape[0]:
                            got[p] = blocks[p - i0].copy()
                    host_s[0] += time.perf_counter() - t0

            torch.cuda.reset_peak_memory_stats()
            _, wall_s = timed(stream)
            peak = torch.cuda.max_memory_allocated() / 2**30
            n_batches = -(-starts.shape[0] // batch)
            host_per = host_s[0] / n_batches
            dstarts = torch.as_tensor(starts, device=y.device)

            def paint():
                for i0 in range(0, starts.shape[0], batch):
                    blk = DS._paint_batch(sp, dstarts[i0:i0 + batch], deltas,
                                          left, chunk, f32)
                return blk

            blk, paint_s = timed(paint)
            paint_s /= n_batches
            nbytes = blk.numel() * blk.element_size()
            copy_s = copy_alone([blk])
            del blk
            syncs = count_syncs(stream) if name == "density" else {}
            per = wall_s / n_batches
            bound = ("host-bound" if per < host_per + paint_s + copy_s
                     else "not overlapped")
            print(f"{label}: {n_batches} batches of {batch} chunks in "
                  f"{wall_s:.3f} s ({len(factors)} momentum copies on the "
                  f"host); per batch paint alone {paint_s:.4f} s, copy "
                  f"alone {copy_s:.4f} s ({nbytes / 1e9:.3f} GB at "
                  f"{nbytes / copy_s / 1e9:.2f} GB/s to pinned memory), host "
                  f"work {host_per:.4f} s, overlapped {per:.4f} s "
                  f"({(per - host_per) * 1e3:+.2f} ms over the host work: "
                  f"{bound}); peak memory {peak:.2f} GiB; synchronizing "
                  f"calls in one stream: {sum(syncs.values())} "
                  f"{json.dumps(syncs)} [{card}]")
            # the picked chunks against the same function on the CPU
            sp_cpu = cubic_spline(m["radius"].cpu(), y.cpu())
            ref = DS._paint_batch(sp_cpu, starts[picks], deltas, left, chunk,
                                  False).numpy()
            g = np.stack([got[p] for p in picks]).astype(np.float64)
            check(np.isfinite(g).all() and all(np.isfinite(sums)),
                  f"{label}: non-finite values")
            if f32:
                err = float((np.abs(g - ref) / np.abs(ref)).max())
                check(err <= GRID_F4_RTOL, f"{label}: f4 vs CPU {err}")
            else:
                # the picks hold the cells next to the centre, where every
                # profile peaks: their max is the field's
                err = float(np.abs(g - ref).max() / np.abs(ref).max())
                check(err <= GRID_F8_TOL, f"{label}: f8 vs CPU {err}")
            edge = float(spline_eval(sp, sp.x[-1:])[0])
            if f32:
                edge = float(np.float32(edge))
            corners = [got[p][cell] for p, cell in zip(picks, corner_cells)]
            check(all(v == edge for v in corners)
                  and abs(edge - float(y[-1])) <= 1e-6 * abs(float(y[-1])),
                  f"{label}: corners {corners[:2]} vs boundary {edge}")
            out[label] = err
    print(f"grid card vs CPU on {len(picks)} chunks (the 8 corners, the "
          f"centre), max |diff| / max (f8) or max relative (f4):",
          json.dumps({k: f"{v:.1e}" for k, v in out.items()}))
    return out


# ----------------------------------------------------------------- phase 18
def run_cli(card):
    """``cli.main(["info"])`` on the card names it and the count; a
    ``--aot-dir`` call exits 2 before it computes anything."""
    import contextlib
    import io

    from cluster_generator_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["info"])
    text = out.getvalue()
    name, n = torch.cuda.get_device_name(0), torch.cuda.device_count()
    check(rc == 0 and "backend=cuda" in text and f"devices={n}" in text
          and f"device {name} x{n}" in text, f"cli info: rc {rc}, {text!r}")
    err = io.StringIO()
    with tempfile.TemporaryDirectory() as d, contextlib.redirect_stderr(err):
        rc = cli.main(["datagen", "-n", "2", "--dm", "10", "--aot-dir", d,
                       "-o", os.path.join(d, "never.h5")])
        made = os.listdir(d)
    check(rc == 2 and "captures" in err.getvalue() and not made,
          f"cli datagen --aot-dir: rc {rc}, {err.getvalue()!r}, {made}")
    print("cli info on the card:", " | ".join(text.strip().splitlines()),
          f"[{card}]")
    print("cli datagen --aot-dir: exit 2 (refused: the programs are "
          "captured in the process)")


def run_native_grid(cg, DS, card, dims=GRID_DIMS, chunk=GRID_CHUNK,
                    batch=GRID_BATCH, points=CLASS_POINTS, dev="cuda"):
    """The native (host C++) painter against the card's on the class-path
    model's density over the 512^3 grid: every batch of both streams, as
    ``YTHDF5._add_field`` drives them, compared block for block; seconds
    per batch of each, and the card's paint alone."""
    import numpy as np

    from cluster_generator_tpu_torch.core.interp import cubic_spline
    from cluster_generator_tpu_torch.ops import native

    t0 = time.perf_counter()
    check(native.available(), "the native library does not build")
    build_s = time.perf_counter() - t0
    m = build_class_model(cg, num_points=points,
                          **({} if dev == "cuda" else {"device": dev}))
    sp = cubic_spline(m["radius"], m["density"])
    starts = DS.construct_chunks([dims] * 3, chunk)[:, 0, :].T.astype(
        np.float64)
    deltas = np.full(3, GRID_BOX / dims)
    left = np.full(3, -GRID_BOX / 2.0)
    n_batches = -(-starts.shape[0] // batch)

    def drain(blocks_iter):
        for _ in blocks_iter:
            pass

    _, native_s = timed(lambda: drain(DS._native_blocks(
        sp, starts, deltas, left, chunk, batch)))
    _, card_s = timed(lambda: drain(DS._paint_blocks(
        sp, starts, deltas, left, chunk, batch)))
    dstarts = torch.as_tensor(starts, device=sp.x.device)
    paint_ms = cuda_ms(lambda: DS._paint_batch(sp, dstarts[:batch], deltas,
                                               left, chunk), 5)
    worst, top, seen = 0.0, 0.0, 0
    for (i0, a), (j0, b) in zip(
            DS._native_blocks(sp, starts, deltas, left, chunk, batch),
            DS._paint_blocks(sp, starts, deltas, left, chunk, batch)):
        check(i0 == j0 and a.shape == b.shape, f"native batch {i0} vs {j0}")
        check(np.isfinite(a).all(), f"native batch {i0}: non-finite")
        worst = max(worst, float(np.abs(a - b).max()))
        top = max(top, float(np.abs(b).max()))
        seen += a.shape[0]
    check(seen == starts.shape[0], f"native painted {seen} chunks")
    err = worst / top
    print(f"native vs card painter, {dims}^3 density in {n_batches} batches "
          f"of {batch} {chunk}^3 chunks: max |diff| / max {err:.1e} (limit "
          f"{NATIVE_TOL}); per batch native (host C++, "
          f"{os.cpu_count()} cores) {native_s / n_batches:.4f} s, card "
          f"stream (paint + copy to pinned memory) {card_s / n_batches:.4f} "
          f"s, card paint alone {paint_ms / 1e3:.4f} s; library built or "
          f"loaded in {build_s:.1f} s [{card}]")
    check(err <= NATIVE_TOL, f"native vs card painter {err}")
    return err, native_s / n_batches, card_s / n_batches


def run_tooling(P, E, card, counts=(N_GAS, N_DM, N_STAR),
                batch=DATAGEN_BATCH, dev="cuda"):
    """``stage`` around one warm merger IC against CUDA events on the same
    run, ``trace`` around one datagen batch (the trace names K1),
    ``device_memory_stats``, ``nan_guard`` on the card and
    ``validate_model_fields`` on the merger's models."""
    from cluster_generator_tpu_torch.core import debug, profiling

    # stage: the host timer waits for the parts; the events bracket it
    times = profiling.StageTimes()
    gen = torch.Generator(device=dev).manual_seed(0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    sync()
    start.record()
    holder = []
    with profiling.stage("merger IC", holder, accumulate=times, log=False):
        holder.append(P.merger_ic_fused(
            M200, CONC, CENTERS, VELOCITIES, R_MAX, *counts, generator=gen,
            device=dev))
    end.record()
    sync()
    stage_s = times.times["merger IC"]
    event_s = start.elapsed_time(end) / 1e3
    del holder
    rel, absol = STAGE_TOL
    print(f"stage('merger IC') {stage_s:.4f} s, CUDA events around it "
          f"{event_s:.4f} s [{card}]")
    check(abs(stage_s - event_s) <= rel * event_s + absol,
          f"stage {stage_s} s vs events {event_s} s")

    # trace: one datagen batch at the cfg5c width
    M, c = E.sample_ensemble_params(
        torch.Generator(device=dev).manual_seed(DATAGEN_SEED), batch,
        device=dev)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        with profiling.trace(d) as prof:
            (_, out), = E.datagen_batches(M, c, DATAGEN_COUNTS,
                                          batch_size=batch,
                                          num_points=DATAGEN_POINTS,
                                          seed=DATAGEN_SEED, device=dev)
            sync()
        traced_s = time.perf_counter() - t0
        path = os.path.join(d, "trace.json")
        size = os.path.getsize(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    k1 = [e for e in events if e.get("cat") == "kernel"
          and K1_KERNEL in e.get("name", "")]
    n_kernels = sum(e.get("cat") == "kernel" for e in events)
    k1_us = sum(float(e.get("dur", 0.0)) for e in k1)
    print(f"trace of one datagen batch ({batch} clusters): "
          f"{traced_s:.3f} s with the profiler on, {size / 1e6:.1f} MB of "
          f"Chrome trace, {n_kernels} kernels, K1 {len(k1)} times "
          f"({k1_us:.1f} us) [{card}]")
    check(len(k1) == 2, f"the trace names K1 {len(k1)} times, want 2")
    check(sum(E.nonfinite_counts(out).values()) == 0,
          "traced datagen batch: non-finite values")
    del out, prof

    stats = profiling.device_memory_stats()
    alloc = stats["cuda:0"]["allocated_bytes.all.current"]
    peak = stats["cuda:0"]["allocated_bytes.all.peak"]
    print(f"device_memory_stats cuda:0: allocated {alloc / 2**20:.1f} MiB, "
          f"peak {peak / 2**30:.2f} GiB, {len(stats)} card(s)")
    check(set(stats) == {f"cuda:{i}" for i in range(
        torch.cuda.device_count())} and alloc > 0, f"memory stats {alloc}")

    x = torch.linspace(1.0, 2.0, 1 << 20, device=dev, dtype=torch.float64)
    with debug.nan_guard():
        clean = torch.log(x).sum()
        try:
            torch.log(x - 1.5)
        except FloatingPointError as e:
            caught = str(e)
        else:
            caught = ""
    check(bool(torch.isfinite(clean)) and "aten.log" in caught
          and torch.device(dev).type in caught,
          f"nan_guard on the card: {caught!r}")
    print(f"nan_guard on the card: {caught}")
    fields = P.build_merger_models(M200, CONC, device=dev)
    for h in range(len(M200)):
        problems = debug.validate_model_fields(
            {k: v[h] for k, v in fields.items()})
        check(problems == [], f"validate_model_fields, halo {h}: {problems}")
    return stage_s, event_s


# ----------------------------------------------------------------- phase 19
# the multi-device layer over torch.distributed; every size at full width
MD = {"dev": "cuda", "counts": (N_GAS, N_DM, N_STAR), "merger_points": 1000,
      "grid": FIELD_BIG_DIMS, "grid_small": 256,
      "datagen_batch": DATAGEN_BATCH, "datagen_points": DATAGEN_POINTS,
      "datagen_counts": DATAGEN_COUNTS, "scenes": SCENE_BATCH,
      "scene_points": SCENE_POINTS, "scene_counts": SCENE_COUNTS}
MD_SEED = 5                 # the sharded merger draw's seed
MD_GRF_TOL = 1e-5           # float32 field, world 4 vs world 1, of max |g|
MD_RTOL, MD_ATOL = 5e-7, 1e-6   # mesh batches, world 4 vs world 1
MD_TIMEOUT = 600.0          # seconds for one world's ranks


def _md_sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _md_timed(fn, dev):
    _md_sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _md_sync(dev)
    return out, time.perf_counter() - t0


def _md_counted(K, fn):
    """``fn()`` and the K1 launches it made."""
    before = K.invert_cdf_rows.launches
    out = fn()
    return out, K.invert_cdf_rows.launches - before


def _md_close(got, want):
    """max over elements of |got - want| - (atol + rtol |want|): <= 0 when
    the two agree at the mesh batches' bound."""
    return float(((got - want).abs() - (MD_ATOL + MD_RTOL * want.abs()))
                 .max())


def md_steps(rank, world, out, sz):
    """Phase 19 on this rank of an initialized world: K1 against its plain
    version on the rank's first batch, then (counting K1) the sharded merger
    draw against ``sample_merger_ic`` with the rank's generator, its Gadget
    blocks, the sharded field (world 1 at full size and small, world 4
    small, against the world-1 field), one pencil transpose's all-to-all by
    events, the cfg5c and cfg6 mesh batches (world 1 against no mesh, bit
    for bit; world 4 against world 1) and the dry run's steps.  Returns the
    rank's numbers."""
    import torch.distributed as dist

    from cluster_generator_tpu_torch import particles as PA
    from cluster_generator_tpu_torch import pipeline as P
    from cluster_generator_tpu_torch import virial as V
    from cluster_generator_tpu_torch.core import compiled as C
    from cluster_generator_tpu_torch.ops import cdf_inverse as K
    from cluster_generator_tpu_torch.ops import speed_cdf as SC
    from cluster_generator_tpu_torch.parallel import dryrun as DR
    from cluster_generator_tpu_torch.parallel import ensemble as E
    from cluster_generator_tpu_torch.parallel import export as EX
    from cluster_generator_tpu_torch.parallel import mergers as MG
    from cluster_generator_tpu_torch.parallel.fft import _all_to_all
    from cluster_generator_tpu_torch.parallel.fields import (
        sharded_gaussian_random_field)
    from cluster_generator_tpu_torch.parallel.mesh import (
        all_gather_rows, ens_rows, fold_in, make_mesh, mesh_device, sharded)

    me = make_mesh(world, 1, device_type=sz["dev"])   # ens: batches, grid
    mp = make_mesh(1, world, device_type=sz["dev"])   # part: the draw
    dev = mesh_device(me)
    cuda = dev.type == "cuda"
    res = {"rank": rank, "world": world, "backend": dist.get_backend()}
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    # the first DTensor of a process pays a one-time set-up; timed apart
    _, res["dtensor_setup_s"] = _md_timed(lambda: sharded(
        me, torch.zeros(1, device=dev), "ens", world), dev)

    # K1 against its plain version on the rank's rows of the first batch
    B = sz["datagen_batch"]
    counts = sz["datagen_counts"]
    M, c = E.sample_ensemble_params(
        torch.Generator(device=dev).manual_seed(DATAGEN_SEED), B, device=dev)
    lo, hi = ens_rows(me, B)
    prog = E._datagen_full_batch_fn(sz["datagen_points"], counts["dm"],
                                    counts["gas"], counts["star"])
    f = prog.models(M[lo:hi], c[lo:hi])
    errs = []
    for kw in prog.speed_table_inputs(f, prog.dfs(f)).values():
        n_q = kw.pop("n_q")
        cdf = V.speed_cdf_rows(**kw).to(torch.float32)
        cdf = cdf.reshape(-1, cdf.shape[-1]).contiguous()
        errs.append(float((K.invert_cdf_rows(cdf, n_q)
                           - K.invert_cdf_rows_plain(cdf, n_q)).abs().max()))
    res["k1_rows"] = int(cdf.shape[0])
    res["k1_err"] = max(errs)
    check(res["k1_err"] <= K1_TOL, f"rank {rank}: K1 vs plain {errs}")
    del f, cdf
    launches = 0

    # the sharded merger draw over 'part' at bench2h-1e7's counts
    fields = P.build_merger_models(M200, CONC, num_points=sz["merger_points"],
                                   device=dev)
    tables, n = _md_counted(K, lambda: P.build_speed_tables(fields))
    launches += n
    tables["radius"] = P.build_radius_tables(fields, [R_MAX] * 2)
    i = mp.get_local_rank("part")
    per = [tuple(n // world for n in cts) for cts in sz["counts"]]

    def draw_sharded():
        return P.sample_merger_ic_sharded(
            mp, fields, tables, CENTERS, VELOCITIES, [R_MAX] * 2, MD_SEED,
            *sz["counts"])

    def draw_plain():
        return P.sample_merger_ic(
            fields, tables, CENTERS, VELOCITIES, [R_MAX] * 2, *per,
            generator=fold_in(MD_SEED, i, dev))

    parts, res["draw_first_s"] = _md_timed(draw_sharded, dev)
    want = draw_plain()
    for k, v in want.items():
        check(torch.equal(parts[k].to_local(), v),
              f"rank {rank}: sharded draw {k} differs from sample_merger_ic")
    check(parts["gas", "particle_position"].shape[0] == sum(sz["counts"][0]),
          f"rank {rank}: sharded draw's global shape")
    del want
    times = {"sharded": [], "plain": []}
    for name in ("sharded", "plain", "plain", "sharded", "sharded", "plain"):
        fn = draw_sharded if name == "sharded" else draw_plain
        times[name].append(_md_timed(fn, dev)[1])
    res["draw_warm_s"] = statistics.median(times["sharded"])
    res["plain_warm_s"] = statistics.median(times["plain"])

    # its Gadget blocks with the collective ID offsets
    n_files, total, plan = EX._export_plan(parts, IC_BOX, [IC_BOX / 2] * 3)
    check(n_files == world and len(plan) == 1, f"rank {rank}: {n_files}")
    (shard, sp, id_offset, expect), = plan
    blocks, n_in, table = sp.gadget_blocks(IC_BOX, id_offset=id_offset)
    check(n_in == expect, f"rank {rank}: blocks {n_in} vs {expect}")
    res["npart_total"] = [int(x) for x in total]
    if world > 1:
        torch.save({"shard": shard, "blocks": blocks, "table": table,
                    "parts": {k: v.to_local().cpu()
                              for k, v in parts.items()}},
                   os.path.join(out, f"gadget{rank}.pt"))
    del parts, sp, blocks

    # the sharded field; world 1 also at full size
    box = FIELD_RE[0] - FIELD_LE[0]
    peaks = [torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else 0.0]
    grids = [sz["grid"], sz["grid_small"]] if world == 1 else [
        sz["grid_small"]]
    programs = {}

    def reserved_beyond(fields):
        # the memory the card holds (pools and workspaces included) beyond
        # ``fields``, in GiB
        _md_sync(dev)
        torch.cuda.empty_cache()
        return (torch.cuda.memory_reserved(dev) - sum(
            x.numel() * x.element_size() for x in fields)) / 2**30

    for n in grids:
        d = box / n
        # the grid before's workspace and programs are dropped by the
        # first call on this grid: what the card holds before and after

        def field():
            return sharded_gaussian_random_field(
                FIELD_SEED, (n,) * 3, (d,) * 3, *FIELD_L, me,
                g_rms=FIELD_B_RMS)

        def local_of(g):
            return [x.to_local() for x in g]

        held_before = reserved_beyond(()) if cuda else 0.0
        g, first = _md_timed(field, dev)
        firsts = local_of(g)
        held_after = reserved_beyond(firsts) if cuda else 0.0
        del g
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        g, warm = _md_timed(field, dev)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else 0.0
        local = local_of(g)
        # the capture call against the replay, and the stages' eager
        # bodies on the same seed and buffers against the replay; the eager
        # peak less the replay's field, held
        first_diff = tree_diff(firsts, local, f"grf{n} first")
        del firsts
        held = sum(x.numel() * x.element_size() for x in local) / 2**30
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        with C.eager():
            e, eager_s = _md_timed(field, dev)
        peak_eager = (torch.cuda.max_memory_allocated(dev) / 2**30 - held
                      if cuda else 0.0)
        stages = [p for p in C.programs() if p.key[0][0].startswith(
            "sharded_grf")]
        rep = {"first_s": first, "graph_warm_s": warm,
               "eager_warm_s": eager_s,
               "max_abs_diff": tree_diff(local, local_of(e), f"grf{n}"),
               "first_max_abs_diff": first_diff,
               "programs": sorted(p.key[0][0] for p in stages),
               "capture_s": sum(p.capture_s or 0.0 for p in stages),
               "pool_gib": sum(p.pool_bytes or 0 for p in stages) / 2**30,
               "workspace_gib": sum(w.nbytes() for w in C.workspaces())
               / 2**30,
               "workspaces": len(C.workspaces()),
               "held_before_gib": held_before,
               "held_after_first_gib": held_after,
               "graph_peak_gib": peak, "eager_peak_gib": peak_eager}
        del e
        check(rep["max_abs_diff"] == 0.0 and rep["first_max_abs_diff"] == 0.0
              and len(stages) == 3 and rep["workspaces"] == 1,
              f"rank {rank}: sharded field {n}^3 programs vs eager {rep}")
        programs[f"sharded field {n}^3 world {world} rank {rank}"] = rep
        whole = local if world == 1 else [all_gather_rows(me, x)
                                          for x in local]
        rms, div = DR.grf_checks(*whole, d)
        check(abs(rms - FIELD_B_RMS) / FIELD_B_RMS < FIELD_RMS_RTOL,
              f"rank {rank}: field {n}^3 rms {rms}")
        check(div < FIELD_DIV_TOL, f"rank {rank}: field {n}^3 div {div}")
        ref = os.path.join(out, f"grf{n}.pt")
        if world == 1 and n == sz["grid_small"]:
            torch.save(torch.stack(whole).cpu(), ref)
        elif world > 1:
            glo, ghi = ens_rows(me, n)
            want = torch.load(ref).to(dev)[:, glo:ghi]
            err = float((torch.stack(local) - want).abs().max()
                        / want.abs().max())
            check(err <= MD_GRF_TOL, f"rank {rank}: field vs world 1 {err}")
            res[f"grf{n}_vs_world1"] = err
        peaks.append(peak)
        res[f"grf{n}"] = {"first_s": first, "warm_s": warm, "peak_gib": peak,
                          "rms_rel_err": abs(rms - FIELD_B_RMS) / FIELD_B_RMS,
                          "div_over_grad": div}
        del g, local, whole, stages
        if cuda:   # with no field held
            rep["graph_host_launches"] = host_launches(field)
            with C.eager():
                rep["eager_host_launches"] = host_launches(field)
    # the ranks of a world on one card share it: a rank's make_room cannot
    # see what the others need
    C.clear()

    # one pencil transpose's all-to-all at the largest grid, by events
    n = grids[0]
    x = torch.zeros((world, n // world, n // world, n), dtype=torch.complex64,
                    device=dev)
    group = me.get_group("ens")
    _all_to_all(x, group)
    _md_sync(dev)
    reps = 3
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        y = _all_to_all(x, group)
    if cuda:
        end.record()
    _md_sync(dev)
    res["a2a_host_ms"] = (time.perf_counter() - t0) * 1e3 / reps
    res["a2a_ms"] = (start.elapsed_time(end) / reps if cuda
                     else res["a2a_host_ms"])
    res["a2a_bytes"] = x.numel() * x.element_size()
    del x, y

    # the cfg5c batch through datagen_batches over 'ens', gathered: the
    # batch program at the rank's rows (first: the capture), again, and
    # its eager body
    def mesh_batch(fn, pick):
        """``fn()`` (a batch over the mesh) first and again as programs,
        then eagerly: ``(first result, report)``, ``pick(result)`` the
        outputs compared; K1's launches of the program calls counted."""
        nonlocal mesh_launches
        before = C.programs()
        out, first = _md_timed(lambda: _md_counted(K, fn), dev)
        again, warm = _md_timed(lambda: _md_counted(K, fn), dev)
        mesh_launches += out[1] + again[1]
        with C.eager():
            eager, eager_s = _md_timed(fn, dev)
        made = [p for p in C.programs() if all(p is not q for q in before)]

        def local(t):
            return t.to_local() if hasattr(t, "to_local") else t

        rep = {"first_s": first, "graph_warm_s": warm,
               "eager_warm_s": eager_s,
               "max_abs_diff": tree_diff(
                   C.tree_map(local, pick(again[0])),
                   C.tree_map(local, pick(eager)), "mesh"),
               "first_max_abs_diff": tree_diff(
                   C.tree_map(local, pick(out[0])),
                   C.tree_map(local, pick(eager)), "mesh first"),
               "rows": [int(p.key[3][0][0][0]) for p in made],
               "capture_s": sum(p.capture_s or 0.0 for p in made),
               "pool_gib": sum(p.pool_bytes or 0 for p in made) / 2**30,
               "k1_nodes": sum(p.nodes.get(K.invert_cdf_rows, 0)
                                for p in made),
               "cdf_nodes": sum(p.nodes.get(SC.speed_cdf_rows_f32, 0)
                                for p in made)}
        check(rep["max_abs_diff"] == 0.0 and rep["first_max_abs_diff"] == 0.0
              and len(made) == 1
              and (not cuda or rep["k1_nodes"] == rep["cdf_nodes"] == 2),
              f"rank {rank}: mesh batch program vs eager {rep}")
        return out[0], rep

    mesh_launches = 0
    (_, out_d), programs[f"cfg5c mesh batch world {world} rank {rank}"] = \
        mesh_batch(lambda: next(E.datagen_batches(
            M, c, counts, batch_size=B, num_points=sz["datagen_points"],
            seed=DATAGEN_SEED, mesh=me)), lambda r: r[1])
    whole = C.tree_map(lambda t: all_gather_rows(me, t.to_local()), out_d)
    flat = E._flat_outputs(whole)[1]
    ref = os.path.join(out, "datagen_ref.pt")
    if world == 1:
        (_, plain_d), = E.datagen_batches(M, c, counts, batch_size=B,
                                          num_points=sz["datagen_points"],
                                          seed=DATAGEN_SEED, device=dev)
        want = E._flat_outputs(plain_d)[1]
        check(all(torch.equal(a, b) for a, b in zip(flat, want)),
              "world 1 mesh datagen batch differs from no mesh")
        torch.save([t.cpu() for t in want], ref)
    else:
        want = [t.to(dev) for t in torch.load(ref)]
        res["datagen_vs_world1"] = max(_md_close(a, b)
                                       for a, b in zip(flat, want))
        check(res["datagen_vs_world1"] <= 0.0,
              f"rank {rank}: datagen batch vs world 1")
    check(sum(E.nonfinite_counts(whole).values()) == 0,
          f"rank {rank}: non-finite datagen draws")
    del out_d, whole, flat, want

    # the cfg6 scene batch over 'ens', gathered
    S = sz["scenes"]
    sc = MG.sample_merger_scene_params(
        torch.Generator(device=dev).manual_seed(SCENE_SEED), S, device=dev)
    ctr, vel = MG.binary_scene_geometry(sc["M200"], sc["d"], sc["b"],
                                        sc["v_rel"])
    ctr, vel = (torch.as_tensor(a, dtype=torch.float64, device=dev)
                for a in (ctr, vel))
    fn = MG._merger_batch_fn(sz["scene_points"], *sz["scene_counts"].values(),
                             device=dev)
    r_max = torch.full((2,), R_MAX, dtype=torch.float64, device=dev)
    inputs = (sc["M200"], sc["conc"], ctr, vel)
    (local, rows), programs[f"cfg6 mesh batch world {world} rank {rank}"] \
        = mesh_batch(lambda: E._mesh_call(fn, me, inputs, (r_max,),
                                          E._batch_generator(SCENE_SEED, 0,
                                                             dev)),
                     lambda r: r[0])
    whole = E._gathered(me, local, rows)
    ref = os.path.join(out, "scenes_ref.pt")
    if world == 1:
        want = fn(*inputs, r_max, E._batch_generator(SCENE_SEED, 0, dev))
        check(all(torch.equal(whole[k], v) for k, v in want.items()),
              "world 1 mesh scene batch differs from no mesh")
        torch.save({k: v.cpu() for k, v in want.items()}, ref)
    else:
        want = {k: v.to(dev) for k, v in torch.load(ref).items()}
        res["scenes_vs_world1"] = max(_md_close(whole[k], v)
                                      for k, v in want.items())
        check(res["scenes_vs_world1"] <= 0.0,
              f"rank {rank}: scene batch vs world 1")
    check(all(bool(torch.isfinite(v).all()) for v in whole.values()),
          f"rank {rank}: non-finite scene draws")
    del local, whole, want

    # the dry run's steps at its sizes
    n_part = 2 if world % 2 == 0 else 1
    mesh_dr = make_mesh(world // n_part, n_part, device_type=sz["dev"])
    steps, n = _md_counted(K, lambda: DR.dryrun_step(mesh_dr, None))
    launches += n
    res["dryrun_s"] = steps
    res["launches"] = launches
    res["mesh_launches"] = mesh_launches
    res["programs"] = programs
    res["pool_gib"] = sum(p.pool_bytes or 0 for p in C.programs()) / 2**30
    peaks.append(torch.cuda.max_memory_allocated(dev) / 2**30
                 if cuda else 0.0)
    res["peak_gib"] = max(peaks)
    return res


def md_rank(rank, world, backend, store, out, sz):
    """One process of phase 19: its card (``cuda:0`` for every rank of a
    gloo world on one card), its process group, :func:`md_steps`."""
    import torch.distributed as dist

    if sz["dev"] == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count()
                              if backend == "nccl" else 0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        res = md_steps(rank, world, out, sz)
        torch.save(res, os.path.join(out, f"{backend}{world}.{rank}.pt"))
    finally:
        dist.destroy_process_group()


def md_world(world, backend, out, sz):
    """Start ``world`` ranks of :func:`md_rank` with
    ``torch.multiprocessing`` and wait for them; a rank that fails or
    outlasts ``MD_TIMEOUT`` fails the phase.  Returns each rank's
    numbers."""
    import torch.multiprocessing as mp

    store = os.path.join(out, f"store_{backend}{world}")
    t0 = time.perf_counter()
    ctx = mp.start_processes(md_rank, args=(world, backend, store, out, sz),
                             nprocs=world, join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=1.0):
            if time.perf_counter() - t0 > MD_TIMEOUT:
                raise SmokeFailure(f"{backend} world {world} outlasted "
                                   f"{MD_TIMEOUT} s")
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
        raise SmokeFailure(f"{backend} world {world}: a rank failed: {e}")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    codes = [p.exitcode for p in ctx.processes]
    check(codes == [0] * world, f"{backend} world {world}: exit codes {codes}")
    wall = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(out, f"{backend}{world}.{r}.pt"))
             for r in range(world)]
    return ranks, wall


def md_gadget_union(PA, EX, out, world, dev):
    """The world's sharded Gadget blocks against the blocks of the same
    particles written as one file: every dataset but the IDs equal, species
    by species in shard order, and the IDs a permutation of 1..N."""
    import numpy as np

    shards = sorted((torch.load(os.path.join(out, f"gadget{r}.pt"),
                                weights_only=False) for r in range(world)),
                    key=lambda s: s["shard"])
    keys = list(shards[0]["parts"])
    fields = {(k[0], EX._PIPE_TO_CONTAINER.get(k[1], k[1])):
              torch.cat([s["parts"][k] for s in shards]).to(dev)
              for k in keys}
    species = list(dict.fromkeys(k[0] for k in keys))
    whole = PA.ClusterParticles(species, fields)
    for sp in species:  # the shift _export_plan gives each shard
        whole.fields[sp, "particle_position"] = (
            whole.fields[sp, "particle_position"]
            + whole._coerce((sp, "particle_position"), [IC_BOX / 2] * 3))
    one, n_one, table = whole.gadget_blocks(IC_BOX, id_offset=0)
    ids = []
    for sp in species:
        for name, want in one[sp].items():
            got = np.concatenate([s["blocks"][sp][name] for s in shards])
            if name == "ParticleIDs":
                ids.append(got)
                continue
            check(np.array_equal(got, want),
                  f"sharded Gadget {sp}/{name} differs from one file's")
    ids = np.concatenate(ids).astype(np.int64)
    check(np.array_equal(np.sort(ids), np.arange(1, ids.size + 1)),
          "sharded Gadget IDs are not 1..N")
    check(all(np.array_equal(s["table"], table) for s in shards),
          "sharded Gadget mass tables")
    return n_one


def run_multidevice(card, sz=MD):
    """Phase 19: (a) world 1 on NCCL at full width, (b) world 4 on gloo
    with every rank on ``cuda:0`` (the real decomposition with P = 4; the
    transport goes through the host), (c) world 4 on NCCL where the
    machine has four cards.  Returns K1's launches per world and rank."""
    from cluster_generator_tpu_torch import particles as PA
    from cluster_generator_tpu_torch.parallel import export as EX

    import gc

    dev = torch.device(sz["dev"])
    launches, programs = {}, {}
    worlds = [(1, "nccl" if dev.type == "cuda" else "gloo"), (4, "gloo")]
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if n_cards:
        # the ranks share the card with this process: hand back its cache
        gc.collect()
        torch.cuda.empty_cache()
        print(f"before the ranks start, this process holds "
              f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB of the card")
    if n_cards >= 4:
        worlds.append((4, "nccl"))
    with tempfile.TemporaryDirectory() as out:
        for world, backend in worlds:
            ranks, wall = md_world(world, backend, out, sz)
            label = f"{backend} world {world}"
            for r in ranks:
                tag = f"{backend}{world}_rank{r['rank']}"
                launches[f"multidevice_{tag}"] = r["launches"]
                launches[f"mesh_programs_{tag}"] = r["mesh_launches"]
                programs.update({f"{k} ({backend})": v
                                 for k, v in r["programs"].items()})
                print(f"{label} rank {r['rank']}: " + json.dumps(
                    {k: v for k, v in r.items()
                     if k not in ("rank", "world", "backend")},
                    default=float) + f" [{card}]")
            print(f"{label}: {wall:.1f} s wall for {world} process(es), "
                  "start-up included; K1 launches per rank "
                  f"{[r['launches'] for r in ranks]} [{card}]")
            if world > 1:
                n = md_gadget_union(PA, EX, out, world, dev)
                check(sum(n.values()) == sum(ranks[0]["npart_total"]),
                      f"{label}: blocks {n} vs {ranks[0]['npart_total']}")
                print(f"{label}: the union of the sharded Gadget blocks "
                      f"equals one file's ({sum(n.values())} particles)")
    if n_cards < 4:
        print(f"multi-device (c) world 4 on NCCL: not run, the machine has "
              f"{n_cards} card(s) and NCCL takes one card per rank")
    check(all(n > 0 for n in launches.values()),
          f"a rank never launched K1: {launches}")
    return launches, programs


# ----------------------------------------------------------------- phase 20
EXAMPLE_TIMEOUT = 900.0     # seconds for one example
EXAMPLE_RESIDUAL = 1e-4     # single_cluster's HSE and virial residuals


def run_example(root, cwd, name, dev, scale, ranks=None):
    """One script of ``examples_torch/`` in ``cwd``; its standard output.
    ``ranks``: start it under ``torchrun`` as a world of that size."""
    cmd = [os.path.join(root, "examples_torch", name), "--device", dev]
    if ranks:
        cmd = ["-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", str(ranks)] + cmd
    env = dict(os.environ, CG_EXAMPLE_SCALE=str(scale), PYTHONPATH=root)
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable] + cmd, cwd=cwd, env=env,
                         capture_output=True, text=True,
                         timeout=EXAMPLE_TIMEOUT)
    check(res.returncode == 0,
          f"examples_torch/{name} exited {res.returncode}: "
          f"{res.stderr[-3000:]}")
    print(f"examples_torch/{name} ({time.perf_counter() - t0:.1f} s, start-up "
          f"included): " + " | ".join(res.stdout.strip().splitlines()[-3:]))
    return res.stdout


def run_examples(card, root, dev="cuda", scale=1):
    """Phase 20 (b): the five examples at ``CG_EXAMPLE_SCALE=scale`` on
    ``dev`` in a temporary directory, with the checks of the CPU tests
    (tests/test_torch_examples.py); ``multichip_export`` as a world of one
    (NCCL on the card).  They write and read HDF5, so without ``h5py``
    one line says why they were not run."""
    import importlib.util
    import re

    if importlib.util.find_spec("h5py") is None:
        print("examples_torch: not run, this machine has no h5py and each of "
              "the five examples writes or reads HDF5 (the CPU tests run them)")
        return
    with tempfile.TemporaryDirectory() as cwd:
        out = run_example(root, cwd, "single_cluster.py", dev, scale)
        for what in ("HSE residual", "virial residual"):
            got = float(re.search(what + r": (\S+)", out).group(1))
            check(got < EXAMPLE_RESIDUAL, f"single_cluster {what} {got}")
        out = run_example(root, cwd, "binary_merger.py", dev, scale)
        check(all(os.path.exists(os.path.join(cwd, fn))
                  for fn in ("merger_ic.h5", "merger_B.h5")),
              "binary_merger wrote no merger_ic.h5 / merger_B.h5")
        out = run_example(root, cwd, "ensemble.py", dev, scale)
        check("every f(E) >= 0: True" in out and "violations: 0" in out,
              "ensemble: a negative f(E) or a QA violation")
        out = run_example(root, cwd, "train_on_catalog.py", dev, scale)
        check("improved" in out and "NOT improved" not in out,
              "train_on_catalog: the loss did not improve")
        out = run_example(root, cwd, "multichip_export.py", dev, scale,
                          ranks=1)
        check("wrote 1 Gadget shard files" in out and "reassembled" in out
              and os.path.exists(os.path.join(cwd, "merger_ic.0.h5")),
              "multichip_export: no shard file or no reassembly")
    print(f"examples_torch: the five examples passed on {dev} [{card}]")


# ----------------------------------------------------------------- phase 21
# the captured programs at full width: bench2h-1e7, datagen-cfg5c batch 256,
# scenes-cfg6 batch 64; each replay has parameters and a seed of its own
COMPILED = {
    "merger": {"n": (N_GAS, N_DM, N_STAR), "points": 1000},
    "datagen": {"batch": DATAGEN_BATCH, "points": DATAGEN_POINTS,
                "counts": DATAGEN_COUNTS, "remainder": 64},
    "scenes": {"batch": SCENE_BATCH, "points": SCENE_POINTS,
               "counts": SCENE_COUNTS, "remainder": 16},
    "replays": 3,
}
COMPILED_Z = 0.3            # the merger's second redshift
COMPILED_SEED = 100         # replay k draws from seed COMPILED_SEED + k


def tree_diff(a, b, where="out"):
    """max |a - b| over two output trees of one structure (a particle
    container by its fields); 0 only where every tensor is equal bit for
    bit (shapes and types too)."""
    if hasattr(a, "fields"):
        a, b = dict(a.fields), dict(b.fields)
    if isinstance(a, dict):
        check(set(a) == set(b), f"{where}: keys {set(a) ^ set(b)}")
        return max((tree_diff(a[k], b[k], f"{where}/{k}") for k in a),
                   default=0.0)
    if isinstance(a, (tuple, list)):
        return max((tree_diff(x, y, f"{where}/{i}")
                    for i, (x, y) in enumerate(zip(a, b))), default=0.0)
    check(a.shape == b.shape and a.dtype == b.dtype,
          f"{where}: {tuple(a.shape)} {a.dtype} vs {tuple(b.shape)} "
          f"{b.dtype}")
    if torch.equal(a, b):
        return 0.0
    d = float((a.double() - b.double()).abs().nan_to_num(math.inf).max())
    return d if d > 0 else math.inf   # NaN at the same place, or -0 vs 0


def host_diff(host, want):
    """max |host - want| of a staged numpy array and a tensor; 0 only
    where they are equal bit for bit."""
    w = want.cpu().numpy()
    if host.shape == w.shape and host.dtype == w.dtype and (
            host.tobytes() == w.tobytes()):
        return 0.0
    if host.shape != w.shape:
        return math.inf
    return float(abs(host.astype("f8") - w.astype("f8")).max()) or math.inf


def host_launches(fn):
    """The calls that put work on a stream (kernels, graphs, copies) the
    host makes in ``fn()``, from the profiler's CUDA runtime events
    (``portbench.yardstick.trace.host_launches``; 0: the profiler recorded
    none)."""
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    events = yard_trace.events_of(prof)
    return yard_trace.host_launches(events, (-math.inf, math.inf))


def program_of(C, name, before):
    """The memoized program called ``name`` that ``before`` (a list of
    programs) did not hold."""
    new = new_programs(C, before).get(name, [])
    check(len(new) == 1, f"{name}: {len(new)} new programs, want 1")
    return new[0]


def new_programs(C, before):
    """The memoized programs that ``before`` did not hold, by name."""
    out = {}
    for p in C.programs():
        if all(p is not q for q in before):
            out.setdefault(p.key[0][0], []).append(p)
    return out


def compare_program(C, K, label, name, graph, eager, n_cases, card):
    """The common checks of phase 21 on one program: the first call (the
    eager warm-up, then the capture) and ``n_cases - 1`` replays, each
    against the eager body on the same inputs and seed, bit for bit, with
    the launches of K1 and of the speed-CDF kernel counted per call (two
    of each, two graph nodes of each); an earlier replay's outputs
    unchanged after the later ones; no sync in a warm call and no program
    released by the warm calls.  ``graph(k)`` / ``eager(k)`` run case k.
    Returns the report."""
    from cluster_generator_tpu_torch.ops import speed_cdf as S

    before = C.programs()
    K.invert_cdf_rows.launches = S.speed_cdf_rows_f32.launches = 0
    first = graph(0)
    first_k1 = K.invert_cdf_rows.launches
    prog = program_of(C, name, before)
    check(first_k1 == 2 and S.speed_cdf_rows_f32.launches == 2,
          f"{label}: first call launched K1 {first_k1} times, the speed-CDF "
          f"kernel {S.speed_cdf_rows_f32.launches}")
    rep = {"k1": first_k1,
           "k1_nodes": prog.nodes.get(K.invert_cdf_rows, 0),
           "cdf_nodes": prog.nodes.get(S.speed_cdf_rows_f32, 0),
           "max_abs_diff": [tree_diff(first, eager(0), label)]}
    check(prog.graph is not None and rep["k1_nodes"] == rep["cdf_nodes"] == 2,
          f"{label}: graph {prog.graph}, nodes {prog.nodes}")
    del first
    held, snap = None, None
    released = C.releases
    for k in range(1, n_cases):
        K.invert_cdf_rows.launches = S.speed_cdf_rows_f32.launches = 0
        out = graph(k)
        sync()
        check(K.invert_cdf_rows.launches == 2
              and S.speed_cdf_rows_f32.launches == 2,
              f"{label}: replay {k} launched K1 "
              f"{K.invert_cdf_rows.launches} times, the speed-CDF kernel "
              f"{S.speed_cdf_rows_f32.launches}")
        rep["k1"] += K.invert_cdf_rows.launches
        rep["max_abs_diff"].append(tree_diff(out, eager(k), label))
        if held is None:
            held, snap = out, C.tree_map(torch.clone, out)
        del out
    rep["held_after_replays"] = tree_diff(held, snap, label)
    del held, snap
    check(max(rep["max_abs_diff"]) == 0.0 and rep["held_after_replays"] == 0,
          f"{label}: graph vs eager {rep['max_abs_diff']}, held "
          f"{rep['held_after_replays']}")
    rep["syncs_warm_call"] = count_syncs(lambda: graph(1))
    check(rep["syncs_warm_call"] == {},
          f"{label}: a warm call synchronized: {rep['syncs_warm_call']}")
    # a warm replay that fits releases nothing
    rep["releases_warm"] = C.releases - released
    check(rep["releases_warm"] == 0,
          f"{label}: warm calls released {rep['releases_warm']} programs")
    print(f"{label}: max |graph - eager| over {n_cases} calls "
          f"{max(rep['max_abs_diff'])}; K1 nodes {rep['k1_nodes']}; no "
          f"sync and no release in a warm call [{card}]")
    return rep


def run_compiled(P, E, MG, K, card, dev="cuda", sz=COMPILED):
    """Phase 21: the three batch programs of the main paths as captured
    CUDA graphs at full width (bench2h-1e7, datagen-cfg5c batch 256,
    scenes-cfg6 batch 64).  For each: the first call and ``replays``
    replays with parameters and seeds of their own against the eager body,
    bit for bit; the merger again at another ``z`` (the same program);
    the batch streams (``datagen_batches``, ``merger_scene_batches``, with
    a remainder batch, and the catalogs' ``stream_to_host`` stage), every
    batch held or staged against its eager body after the later ones ran;
    no sync in a warm call; K1's launches per call.  Returns K1's launches
    by path."""
    import numpy as np

    from cluster_generator_tpu_torch.core import compiled as C

    # a clean memo: each program's first call in this phase is its
    # capture
    C.clear()
    n_cases = sz["replays"] + 1
    f64 = dict(dtype=torch.float64, device=dev)
    reports, launches = {}, {}

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    # the merger IC: case k moves the masses, concentrations, centers,
    # bulk velocities and r_max
    n_gas, n_dm, n_star = sz["merger"]["n"]
    statics = dict(n_gas=n_gas, n_dm=n_dm, n_star=n_star, n_tracer=None,
                   num_points=sz["merger"]["points"], dtype=torch.float32,
                   compute_potential=False, r_a=None, gravity="newtonian")

    cases = [(torch.tensor([M200[0] * (1 + 0.2 * k),
                            M200[1] * (1 - 0.1 * k)], **f64),
              torch.tensor([CONC[0] + 0.5 * k, CONC[1] - 0.3 * k], **f64),
              torch.tensor(CENTERS, **f64) * (1 + 0.1 * k),
              torch.tensor(VELOCITIES, **f64) * (1 - 0.2 * k),
              torch.tensor([R_MAX - 200.0 * k, R_MAX + 100.0 * k], **f64))
             for k in range(n_cases)]

    def merger_case(k):
        return cases[k]

    def merger_graph(k, z=0.1):
        return P.merger_ic_fused(*merger_case(k), n_gas, n_dm, n_star,
                                 num_points=statics["num_points"], z=z,
                                 generator=gen(COMPILED_SEED + k),
                                 device=dev)

    def merger_eager(k, z=0.1):
        u = P.merger_uniforms(gen(COMPILED_SEED + k), (), n_gas, n_dm, n_star,
                              device=dev)
        return P._merger_ic(*merger_case(k), torch.tensor(z, **f64), u,
                            **statics)

    reports["merger"] = compare_program(
        C, K, f"compiled merger IC ({sum(map(sum, sz['merger']['n']))} "
        "particles)", "merger_ic_fused", merger_graph, merger_eager, n_cases,
        card)
    launches["compiled_merger"] = reports["merger"]["k1"]
    # z is an input, as the JAX package traces it: another z replays the
    # same program (phase 22 sweeps four)
    before = C.programs()
    K.invert_cdf_rows.launches = 0
    z_first = merger_graph(1, COMPILED_Z)
    z_replay = merger_graph(2, COMPILED_Z)
    launches["compiled_merger"] += K.invert_cdf_rows.launches
    check(len(C.programs()) == len(before),
          f"z = {COMPILED_Z} made a program of its own")
    z_diffs = [tree_diff(z_first, merger_eager(1, COMPILED_Z), "z first")]
    z_diffs.append(tree_diff(z_replay, merger_eager(2, COMPILED_Z),
                             "z replay"))
    z_moved = tree_diff(z_first, merger_graph(1), "z moved")
    print(f"compiled merger IC at z = {COMPILED_Z}: the same program "
          f"replayed; max |graph - eager| {z_diffs}; max |z={COMPILED_Z}"
          f" - z=0.1| {z_moved:.3g} [{card}]")
    check(max(z_diffs) == 0.0 and z_moved > 0, f"z: {z_diffs}, {z_moved}")
    reports["merger"]["z_max_abs_diff"] = z_diffs
    del z_first, z_replay

    # the datagen batch: case k is batch k of an ensemble
    d = sz["datagen"]
    B = d["batch"]
    prog = E._datagen_full_batch_fn(d["points"], d["counts"]["dm"],
                                    d["counts"]["gas"], d["counts"]["star"])
    M, c = E.sample_ensemble_params(gen(DATAGEN_SEED), n_cases * B,
                                    device=dev)

    def datagen_graph(k):
        sl = slice(k * B, (k + 1) * B)
        return prog(M[sl], c[sl], gen(COMPILED_SEED + k))

    def datagen_eager(k, rows=None, g=None):
        sl = rows or slice(k * B, (k + 1) * B)
        n = M[sl].shape[0]
        g = g or gen(COMPILED_SEED + k)
        return prog.run(M[sl], c[sl], None, prog.uniforms(n, g, M.device))

    reports["datagen"] = compare_program(
        C, K, f"compiled datagen batch ({B} x {sum(d['counts'].values())})",
        "datagen", datagen_graph, datagen_eager, n_cases, card)
    launches["compiled_datagen"] = reports["datagen"]["k1"]

    # the stream: batch k held while batches k+1... replay, a remainder
    n_stream = 2 * B + d["remainder"]
    before = C.programs()
    K.invert_cdf_rows.launches = 0
    outs = list(E.datagen_batches(M[:n_stream], c[:n_stream], d["counts"],
                                  batch_size=B, num_points=d["points"],
                                  seed=DATAGEN_SEED, device=dev))
    launches["compiled_datagen"] += K.invert_cdf_rows.launches
    program_of(C, "datagen", before)   # the remainder's
    def stream_want(b0):
        return datagen_eager(None, slice(b0, min(b0 + B, n_stream)),
                             E._batch_generator(DATAGEN_SEED, b0, M.device))

    diffs = [tree_diff(out, stream_want(b0)) for b0, out in outs]
    del outs
    K.invert_cdf_rows.launches = 0
    hosts = [(b0, C.tree_map(np.copy, host)) for b0, host in
             E._catalog_batches(M[:n_stream], c[:n_stream], prog, B,
                                DATAGEN_SEED, list(range(0, n_stream, B)))]
    launches["compiled_datagen"] += K.invert_cdf_rows.launches
    staged = []
    for b0, host in hosts:
        want = stream_want(b0)
        staged.append(max(host_diff(h, w) for sp in want
                          for h, w in zip(host[sp], want[sp])))
    del hosts
    print(f"compiled datagen stream ({n_stream} clusters, batches of {B}, "
          f"a remainder of {d['remainder']} with a program of its own): max "
          f"|held - eager| per batch {diffs}; through stream_to_host "
          f"{staged} [{card}]")
    check(max(diffs) == 0.0 and max(staged) == 0.0,
          f"datagen stream: {diffs} {staged}")
    reports["datagen"]["stream_max_abs_diff"] = diffs
    reports["datagen"]["staged_max_abs_diff"] = staged
    del prog

    # the scene batch: case k is batch k of an ensemble of scenes
    s = sz["scenes"]
    B = s["batch"]
    params = MG.sample_merger_scene_params(gen(SCENE_SEED), n_cases * B,
                                           device=dev)
    Ms, cs, ctr, vel = MG._scene_inputs(params, torch.device(dev))
    counts = MG._normalize_counts(s["counts"], Ms.shape[1])
    bf = MG._merger_batch_fn(s["points"], counts["gas"], counts["dm"],
                             counts["star"], device=dev)
    r_max = torch.full((Ms.shape[1],), R_MAX, **f64)

    def rows(sl):
        return Ms[sl], cs[sl], ctr[sl], vel[sl], r_max

    def scenes_graph(k):
        return bf(*rows(slice(k * B, (k + 1) * B)), gen(COMPILED_SEED + k))

    def scenes_eager(k, sl=None, g=None):
        sl = sl or slice(k * B, (k + 1) * B)
        g = g or gen(COMPILED_SEED + k)
        return bf.run(*rows(sl), None,
                      bf.uniforms(Ms[sl].shape[0], g, Ms.device))

    reports["scenes"] = compare_program(
        C, K, f"compiled scene batch ({B} x "
        f"{sum(sum(v) for v in s['counts'].values())})", "scene_batch",
        scenes_graph, scenes_eager, n_cases, card)
    launches["compiled_scenes"] = reports["scenes"]["k1"]
    n_stream = 2 * B + s["remainder"]
    K.invert_cdf_rows.launches = 0
    outs = list(MG.merger_scene_batches(
        {k: v[:n_stream] for k, v in params.items()}, s["counts"],
        batch_size=B, num_points=s["points"], r_max=R_MAX, seed=SCENE_SEED,
        device=dev))
    launches["compiled_scenes"] += K.invert_cdf_rows.launches

    def scene_want(b0):
        return scenes_eager(None, slice(b0, min(b0 + B, n_stream)),
                            E._batch_generator(SCENE_SEED, b0, Ms.device))

    diffs = [tree_diff(out, scene_want(b0)) for b0, out in outs]
    del outs
    K.invert_cdf_rows.launches = 0
    hosts = [(b0, C.tree_map(np.copy, host)) for b0, host in
             MG._scene_batches(bf, *rows(slice(0, n_stream)), B,
                               SCENE_SEED, list(range(0, n_stream, B)))]
    launches["compiled_scenes"] += K.invert_cdf_rows.launches
    staged = [max(host_diff(host[k], w) for k, w in scene_want(b0).items())
              for b0, host in hosts]
    del hosts
    print(f"compiled scene stream ({n_stream} scenes, batches of {B}, a "
          f"remainder of {s['remainder']}): max |held - eager| per batch "
          f"{diffs}; through stream_to_host {staged} [{card}]")
    check(max(diffs) == 0.0 and max(staged) == 0.0,
          f"scene stream: {diffs} {staged}")
    reports["scenes"]["stream_max_abs_diff"] = diffs
    reports["scenes"]["staged_max_abs_diff"] = staged
    print("compiled programs:", json.dumps(reports, default=str))
    return launches


# ----------------------------------------------------------------- phase 22
# the class path and the staged merger path as programs: the class set-up
# at CLASS_POINTS, the OM, QUMOND and EMOND models, bench2h-1e7's four stages
PROGRAMS = {"points": CLASS_POINTS, "merger": {"n": (N_GAS, N_DM, N_STAR),
                                               "points": 1000},
            "replays": 3, "z": (0.05, 0.1, 0.2, 0.3)}
PROGRAMS_SEED = 200         # case k of the staged draws uses seed + k


def class_case(cg, V, k, gravity="newtonian", part="setup", dev="cuda",
               points=CLASS_POINTS):
    """Case k of the class path, with masses and concentrations of its own:
    the profiles (``class_profiles``) and ``from_dens_and_tden``; for
    ``part="setup"`` both DFs and both speed tables too, for ``"om"`` the
    Osipkov-Merritt DF and speed table."""
    rhog, rhot = class_profiles(cg, CLASS_M200 * (1.0 + 0.15 * k),
                                CLASS_CONC + 0.4 * k, device=dev)
    m = cg.ClusterModel.from_dens_and_tden(
        0.1, 1e4, rhog, rhot, stellar_density=0.02 * rhot,
        num_points=points, gravity=gravity, device=dev)
    out = {"fields": dict(m.fields)}
    if part == "setup":
        for sp, v in (("dm", m.dm_virial), ("star", m.star_virial)):
            out[f"{sp}_df"] = v.df
            out[f"{sp}_table"] = v._speed_table()[1]
    elif part == "om":
        v = V.VirialEquilibrium(m, r_a=CLASS_R_A)
        out["om_df"] = v.df
        out["om_table"] = v._speed_table()[1]
    return out


def programs_used(C, stamp):
    """The memoized programs looked up (made or replayed) since ``stamp``
    (a value of ``compiled._STAMP``)."""
    return [p for p in C.programs() if p.stamp > stamp]


def compare_programs(C, K, label, graph, eager, n_cases, k1, card,
                     syncs_outside=False, k1_program=None):
    """Phases 22-23's checks on one path of programs: the first call (each
    program's eager warm-up and capture) and ``n_cases - 1`` warm calls
    with parameters of their own, each against ``eager`` (the same calls
    under ``compiled.eager()``) bit for bit; ``k1`` K1 launches per call,
    nodes of the programs the call used (with ``k1_program``: of that
    program alone), and as many launches and nodes of the speed-CDF
    kernel (one of each for every float32 speed table, in the same
    program); no new program in a warm call; no sync in a warm call
    (with ``syncs_outside``: none under a program call, for a path whose
    host checks, logs and seeds sit between its programs; the others
    named); eager and graph warm wall, host launches, device busy; the
    programs used and made, their capture seconds, pool growth and static
    bytes.  Returns ``(report, the first call's output)``."""
    from cluster_generator_tpu_torch.ops import speed_cdf as S

    stamp = next(C._STAMP)
    before = C.programs()
    K.invert_cdf_rows.launches = S.speed_cdf_rows_f32.launches = 0
    first, first_s = timed(lambda: graph(0))
    first_cdf = S.speed_cdf_rows_f32.launches
    used = programs_used(C, stamp)
    made = [p for p in used if all(p is not q for q in before)]
    nodes = {p.key[0][0]: p.nodes.get(K.invert_cdf_rows, 0) for p in used
             if p.nodes.get(K.invert_cdf_rows, 0)}
    unpaired = {p.key[0][0]: dict(p.nodes) for p in used
                if p.nodes.get(K.invert_cdf_rows, 0)
                != p.nodes.get(S.speed_cdf_rows_f32, 0)}
    rep = {"programs": sorted(p.key[0][0] for p in used),
           "made": sorted(p.key[0][0] for p in made),
           "first_s": first_s, "k1": K.invert_cdf_rows.launches,
           "k1_nodes": nodes,
           "capture_s": sum(p.capture_s or 0.0 for p in made),
           "pool_bytes": sum(p.pool_bytes or 0 for p in made),
           "static_bytes": sum(p.static_bytes or 0 for p in used),
           "max_abs_diff": [tree_diff(first, eager(0), label)]}
    # (programs of one key serve both species: the DM and stellar tables
    # of one model are one program, replayed for the second)
    check(rep["k1"] == k1 == first_cdf
          and bool(nodes) == (k1 > 0) and not unpaired
          and (k1_program is None or set(nodes) <= {k1_program})
          and all(p.graph is not None for p in used),
          f"{label}: first call K1 {rep['k1']}, speed CDF {first_cdf}, "
          f"K1 nodes {nodes}, programs "
          f"{rep['programs']}, nodes unpaired {unpaired}")
    released = C.releases
    for k in range(1, n_cases):
        K.invert_cdf_rows.launches = S.speed_cdf_rows_f32.launches = 0
        before = C.programs()
        out = graph(k)
        sync()
        check(K.invert_cdf_rows.launches == k1
              == S.speed_cdf_rows_f32.launches
              and not new_programs(C, before),
              f"{label}: warm call {k} launched K1 "
              f"{K.invert_cdf_rows.launches} times, the speed-CDF kernel "
              f"{S.speed_cdf_rows_f32.launches}, made "
              f"{list(new_programs(C, before))}")
        rep["k1"] += K.invert_cdf_rows.launches
        rep["max_abs_diff"].append(tree_diff(out, eager(k), label))
        del out
    check(max(rep["max_abs_diff"]) == 0.0,
          f"{label}: graph vs eager {rep['max_abs_diff']}")
    syncs = count_syncs(lambda: graph(1))
    rep["syncs_warm_call"] = syncs
    inside = {k: v for k, v in syncs.items()
              if not syncs_outside or k.endswith(IN_PROGRAM)}
    check(not inside, f"{label}: a warm call synchronized: {inside}")
    for side, fn in (("eager", eager), ("graph", graph)):
        walls = [timed(lambda: fn(1))[1] for _ in range(3)]
        rep[f"{side}_warm_s"] = statistics.median(walls)
        rep[f"{side}_host_launches"] = host_launches(lambda: fn(1))
        wall_ms, kern, busy = kernel_profile(lambda: fn(1))
        rep[f"{side}_busy_ms"], rep[f"{side}_kernels"] = busy, len(kern)
        rep[f"{side}_busy_share"] = busy / wall_ms
    # warm calls that fit release nothing
    rep["releases_warm"] = C.releases - released
    check(rep["releases_warm"] == 0,
          f"{label}: warm calls released {rep['releases_warm']} programs")
    print(f"{label}: first call {first_s:.3f} s (captures "
          f"{rep['capture_s']:.3f} s of {rep['made']}), programs "
          f"{rep['programs']}, warm eager {rep['eager_warm_s']:.4f} s / "
          f"graph {rep['graph_warm_s']:.4f} s, host launches per warm call "
          f"{rep['eager_host_launches']} / {rep['graph_host_launches']}, "
          f"device busy (profiled) {rep['eager_busy_ms']:.2f} / "
          f"{rep['graph_busy_ms']:.2f} ms in {rep['eager_kernels']} / "
          f"{rep['graph_kernels']} kernels, pool growth at capture "
          f"{rep['pool_bytes'] / 2**30:.3f} GiB, static buffers "
          f"{rep['static_bytes'] / 2**30:.3f} GiB; syncs {syncs}; max "
          f"|graph - eager| over {n_cases} calls "
          f"{max(rep['max_abs_diff'])}; K1 per call {k1}, nodes {nodes} "
          f"[{card}]")
    return rep, first


def run_class_programs(cg, P, V, E, K, card, grad, dev="cuda", sz=PROGRAMS):
    """Phase 22: the class path and the staged merger path as captured
    programs.  For each of the class set-up (profiles, model, both DFs,
    both speed tables), the Osipkov-Merritt DF and table, the QUMOND and
    EMOND models and bench2h-1e7's four merger stages: the first call and
    ``replays`` warm calls with parameters of their own against the eager
    bodies, bit for bit (:func:`compare_programs`).  Then F3 (a changed
    MOND ``a0`` after a QUMOND capture: a new program, a moved result equal
    to the eager body), F4 (a ``z`` sweep of ``merger_ic_fused``: one
    program) and phase 9's gradient again (equal to ``grad``, the eager
    calls it made counted).  Returns K1's launches by path."""
    from cluster_generator_tpu_torch.core import compiled as C
    from cluster_generator_tpu_torch.core.config import cgparams

    # a clean memo: each program's first call in this phase is its
    # capture, whose seconds and pool are measured
    C.clear()
    n_cases = sz["replays"] + 1
    f64 = dict(dtype=torch.float64, device=dev)
    reports, launches = {}, {}

    def eager(fn):
        def run(k):
            with C.eager():
                return fn(k)
        return run

    for label, kw, k1 in (("setup", {}, 2),
                          ("om", dict(part="om"), 1),
                          ("qumond", dict(gravity="qumond", part="model"), 0),
                          ("emond", dict(gravity="emond", part="model"), 0)):
        def graph(k, kw=kw):
            return class_case(cg, V, k, dev=dev, points=sz["points"], **kw)
        reports[label], _ = compare_programs(
            C, K, f"class {label} programs ({sz['points']} points)", graph,
            eager(graph), n_cases, k1, card, syncs_outside=True)
        launches[f"class_programs_{label}"] = reports[label]["k1"]
    launches = {k: v for k, v in launches.items() if v}

    # F3: a changed a0 after the QUMOND capture is a new program
    old = cgparams["gravity"]["mond"]["a0_m_s2"]
    before = C.programs()
    base = class_case(cg, V, 1, "qumond", "model", dev, sz["points"])
    cgparams["gravity"]["mond"]["a0_m_s2"] = 2.0 * old
    try:
        moved = class_case(cg, V, 1, "qumond", "model", dev, sz["points"])
        made = new_programs(C, before)
        with C.eager():
            want = class_case(cg, V, 1, "qumond", "model", dev, sz["points"])
    finally:
        cgparams["gravity"]["mond"]["a0_m_s2"] = old
    f3 = {"programs": {k: len(v) for k, v in made.items()},
          "moved": tree_diff(base, moved, "a0 moved"),
          "max_abs_diff": tree_diff(moved, want, "a0")}
    print(f"F3 on the card: QUMOND at a0 = {2 * old:g} m/s^2 after the "
          f"capture at {old:g}: new programs {f3['programs']}, result moved "
          f"{f3['moved']:.3g}, max |graph - eager| {f3['max_abs_diff']} "
          f"[{card}]")
    check(f3["programs"].get("build_from_dens_and_tden") == 1
          and f3["moved"] > 0 and f3["max_abs_diff"] == 0.0, f"F3: {f3}")
    reports["f3"] = f3
    del base, moved, want

    # the staged merger path: the four stages at bench2h-1e7
    n_gas, n_dm, n_star = sz["merger"]["n"]
    cases = [(torch.tensor([M200[0] * (1 + 0.2 * k),
                            M200[1] * (1 - 0.1 * k)], **f64),
              torch.tensor([CONC[0] + 0.5 * k, CONC[1] - 0.3 * k], **f64),
              torch.tensor(CENTERS, **f64) * (1 + 0.1 * k),
              torch.tensor(VELOCITIES, **f64) * (1 - 0.2 * k),
              torch.tensor([R_MAX - 200.0 * k, R_MAX + 100.0 * k], **f64))
             for k in range(n_cases)]

    def staged(k):
        M, c, ctr, vel, r_max = cases[k]
        fields = P.build_merger_models(M, c, num_points=sz["merger"]["points"],
                                       device=dev)
        tables = P.build_speed_tables(fields)
        tables["radius"] = P.build_radius_tables(fields, r_max)
        gen = torch.Generator(device=dev).manual_seed(PROGRAMS_SEED + k)
        return P.sample_merger_ic(fields, tables, ctr, vel, r_max, n_gas,
                                  n_dm, n_star, generator=gen), fields

    reports["staged"], _ = compare_programs(
        C, K, f"staged merger programs ({sum(map(sum, sz['merger']['n']))} "
        "particles)", staged, eager(staged), n_cases, 2, card)
    launches["staged_merger"] = reports["staged"]["k1"]

    # F4: a z sweep of merger_ic_fused replays one program
    before = C.programs()
    K.invert_cdf_rows.launches = 0
    outs, diffs = {}, []
    statics = dict(n_gas=n_gas, n_dm=n_dm, n_star=n_star, n_tracer=None,
                   num_points=sz["merger"]["points"], dtype=torch.float32,
                   compute_potential=False, r_a=None, gravity="newtonian")
    for z in sz["z"]:
        gen = torch.Generator(device=dev).manual_seed(PROGRAMS_SEED)
        outs[z] = P.merger_ic_fused(*cases[1], n_gas, n_dm, n_star, z=z,
                                    num_points=statics["num_points"],
                                    generator=gen, device=dev)
        u = P.merger_uniforms(
            torch.Generator(device=dev).manual_seed(PROGRAMS_SEED), (),
            n_gas, n_dm, n_star, device=dev)
        diffs.append(tree_diff(outs[z], P._merger_ic(
            *cases[1], torch.tensor(z, **f64), u, **statics), f"z={z}"))
    launches["z_sweep"] = K.invert_cdf_rows.launches
    made = new_programs(C, before)
    zs = list(sz["z"])
    moved = [tree_diff(outs[a], outs[b], "z moved")
             for a, b in zip(zs[:-1], zs[1:])]
    f4 = {"programs": {k: len(v) for k, v in made.items()},
          "max_abs_diff": diffs, "moved": moved}
    print(f"F4 on the card: merger_ic_fused at z = {zs}: programs made "
          f"{f4['programs']}, max |graph - eager| {diffs}, neighbouring z "
          f"apart by {[f'{m:.3g}' for m in moved]} [{card}]")
    check(f4["programs"] == {"merger_ic_fused": 1} and max(diffs) == 0.0
          and min(moved) > 0, f"F4: {f4}")
    reports["f4"] = f4
    del outs

    # phase 9's gradient: the builders run eagerly where M200 needs grad
    calls = C.eager_calls
    again = run_gradient(E)
    print(f"phase 9's gradient again: {again!r} (phase 9: {grad!r}); eager "
          f"program calls for grad {C.eager_calls - calls} [{card}]")
    check(again == grad and C.eager_calls > calls,
          f"gradient {again} vs {grad}, eager calls {C.eager_calls - calls}")
    reports["gradient"] = {"grad": again, "eager_calls":
                           C.eager_calls - calls}
    print("class and staged programs:", json.dumps(reports, default=str))
    return launches


# ----------------------------------------------------------------- phase 23
# the class path's draws and the IC scene's gas mixing as programs:
# class-4096-1e7 (each species fresh and with its tables held) and
# ic-scene-2h-1e7 / -3h- (draws + combine, combine alone, resample)
DRAWS = {"points": CLASS_POINTS, "counts": CLASS_COUNTS, "om": CLASS_OM_COUNT,
         "ic": IC_TOTALS, "halos": (2, 3), "replays": 3}
DRAWS_SEED = 300            # case k draws from seed DRAWS_SEED + k


def draw_model(cg, k, points, dev):
    """Case k of the class draws: the canonical model with an ``M200`` and
    ``c`` of its own, its DFs and its host copy of the radii made."""
    rhog, rhot = class_profiles(cg, CLASS_M200 * (1.0 + 0.15 * k),
                                CLASS_CONC + 0.4 * k, device=dev)
    m = cg.ClusterModel.from_dens_and_tden(
        0.1, 1e4, rhog, rhot, stellar_density=0.02 * rhot, num_points=points,
        device=dev)
    m.dm_virial, m.star_virial, m._host_field("radius")  # noqa: B018
    return m


def fresh_copy(cg, V, m):
    """A model of ``m``'s fields and DFs with no draw table, no speed table
    and ``m``'s host copies (as a model read from a file holds them): its
    first draw builds every table, as a new model's does."""
    c = cg.ClusterModel(m.num_elements, dict(m.fields), gravity=m.gravity,
                        device=m.device)
    c._host_fields = dict(m._host_fields)
    c._dm_virial = V.VirialEquilibrium(c, "dark_matter", df=m.dm_virial.df)
    c._star_virial = V.VirialEquilibrium(c, "stellar", df=m.star_virial.df)
    return c


def run_draw_programs(cg, I, PA, V, K, card, dev="cuda", sz=DRAWS):
    """Phase 23: the class path's draws and the IC scene's gas mixing as
    captured programs.  class-4096-1e7: each species (gas, tracers, DM with
    potentials, stars, Osipkov-Merritt DM) on a fresh model (the tables'
    program, K1 inside for the collisionless ones, and the draw's) and
    again with its tables held (the draw's program alone); the IC scenes
    of 2 and 3 halos at 1.05e7 particles: draws and combine on fresh
    models, combine alone, resample with a passive scalar.  Each first
    and ``replays`` warm calls on models of other masses and
    concentrations against the eager bodies, bit for bit
    (:func:`compare_programs`), with phases 7 and 13's QA on the first
    call's particles; the syncs left outside the programs named.  Returns
    K1's launches by path."""
    from cluster_generator_tpu_torch import sampling as S
    from cluster_generator_tpu_torch.core import compiled as C

    # a clean memo: each program's first call in this phase is its
    # capture, whose seconds and pool are measured
    C.clear()
    n_cases = sz["replays"] + 1
    n, r_max = sz["counts"], R_MAX
    reports, launches = {}, {}

    def eager(fn):
        def run(k):
            with C.eager():
                return fn(k)
        return run

    def gen(k):
        return torch.Generator(device=dev).manual_seed(DRAWS_SEED + k)

    def compare(label, graph, k1, reference=None, strict=True):
        """:func:`compare_programs` with K1 in the draw-table program;
        ``strict``: no sync at all in a warm call."""
        return compare_programs(C, K, label, graph, reference or eager(graph),
                                n_cases, k1, card, syncs_outside=not strict,
                                k1_program="_collisionless_tables_program")

    models = [draw_model(cg, k, sz["points"], dev) for k in range(n_cases)]
    oms = [V.VirialEquilibrium(m, r_a=CLASS_R_A) for m in models]

    def copy(k, sp):
        """What case k's draw of ``sp`` is made on, with no table held: a
        fresh copy of the model, for OM its virial object."""
        c = fresh_copy(cg, V, models[k])
        if sp == "om":
            return V.VirialEquilibrium(c, "dark_matter", r_a=CLASS_R_A,
                                       df=oms[k].df)
        return c

    def species_draw(sp, obj):
        if sp == "om":
            return lambda g: obj.generate_particles(sz["om"], r_max=r_max,
                                                    prng=g)
        if sp == "dm":
            return lambda g: obj.generate_dm_particles(
                n["dm"], r_max=r_max, compute_potential=True, prng=g)
        fn = getattr(obj, f"generate_{sp}_particles")
        return lambda g: fn(n[sp], r_max=r_max, prng=g)

    qa = {}
    for sp in ("gas", "tracer", "dm", "star", "om"):
        k1 = 0 if sp in ("gas", "tracer") else 1
        count = sz["om"] if sp == "om" else n[sp]

        def fresh(k, sp=sp):
            return species_draw(sp, copy(k, sp))(gen(k))

        rep, first = compare(f"class {sp} draw on a fresh model ({count} "
                             f"particles, {sz['points']} points)", fresh, k1)
        reports[f"{sp}_fresh"] = rep
        launches[f"draw_programs_{sp}"] = rep["k1"]
        short = "dm" if sp == "om" else sp
        qa[sp] = class_species_qa(models[0], first, short, count, r_max)
        if sp == "dm":
            jeans_check(models[0], first, models[0]
                        .compute_velocity_dispersion("dark_matter"))
        if sp == "om":
            check(len(beta_profile(first["dm", "particle_position"],
                                   first["dm", "particle_velocity"],
                                   CLASS_R_A, "class OM dm draw program"))
                  >= 4, "too few populated bins for the OM beta")
        del first
        # the tables held: a copy per case, its tables built once (by the
        # programs, and under eager() for the reference)
        held = {side: [copy(k, sp) for k in range(n_cases)]
                for side in ("graph", "eager")}
        for k in range(n_cases):
            species_draw(sp, held["graph"][k])(gen(k))
            with C.eager():
                species_draw(sp, held["eager"][k])(gen(k))

        def again(k, sp=sp, side="graph"):
            return species_draw(sp, held[side][k])(gen(k))

        def again_eager(k, sp=sp):
            with C.eager():
                return again(k, sp, "eager")

        reports[f"{sp}_held"], _ = compare(
            f"class {sp} draw, tables held ({count} particles)", again, 0,
            again_eager)
        del held
    print("class draw programs: QA", json.dumps(qa))

    # the syncs left outside: generate_particle_radii's float of mtot (and
    # its copy of a grid given as a tensor)
    m = models[0]
    for form, grid in (("tensor", m["radius"]),
                       ("array", m._host_field("radius"))):
        syncs = count_syncs(lambda: S.generate_particle_radii(
            grid, m["gas_mass"], 1000, r_max=r_max, prng=gen(0),
            device=dev))
        reports[f"particle_radii_{form}_syncs"] = syncs
        print(f"generate_particle_radii, grid as a {form}: syncs {syncs} "
              f"[{card}]")
    del models, oms, m

    for n_halos in sz["halos"]:
        C.clear()   # a clean memo: the scene's captures are measured
        reports[f"ic_{n_halos}"], launches[f"draw_programs_ic_{n_halos}"] = \
            run_ic_programs(cg, I, PA, V, compare, card, n_halos, n_cases,
                            sz["ic"], dev)
    print("draw and gas-mixing programs:", json.dumps(reports, default=str))
    return {k: v for k, v in launches.items() if v}


def offsets_and_sum(PA, halos, centers, velocities):
    """The eager part of ``particles._combine`` before the gas mixing:
    every species moved to its halo, the containers summed."""
    parts = [PA.ClusterParticles.from_fields(dict(h.fields)) for h in halos]
    for p, c, v in zip(parts, centers, velocities):
        p.add_offsets(c, [0.0] * 3, ptypes=["gas"])
        p.add_offsets(c, v, ptypes=[t for t in p.particle_types
                                    if t != "gas"])
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def in_class(C, n):
    """A count other than ``n`` in ``n``'s capacity class."""
    m = n - 1 if n > 1 and C.capacity(n - 1) == C.capacity(n) else n + 1
    check(C.capacity(m) == C.capacity(n), f"no other count in {n}'s class")
    return m


def ic_classes_check(I, PA, models, counts, centers, velocities, label):
    """A warm scene whose counts are new but inside the classes captured
    (draws and combine): no capture; and, with the classes off, the
    exact-count programs give its particles bit for bit."""
    from cluster_generator_tpu_torch.core import compiled as C

    moved = {sp: [in_class(C, n) for n in v] for sp, v in counts.items()}

    def scene():
        halos = ic_draws(I, models, moved, DRAWS_SEED + 50)
        return ic_combine(PA, halos, models, centers, velocities)

    before = C.captures
    warm = scene()
    sync()
    captured = C.captures - before
    classes, C.CAPACITY_CLASSES = C.CAPACITY_CLASSES, 0
    try:
        exact = scene()
    finally:
        C.CAPACITY_CLASSES = classes
    diff = tree_diff(warm, exact, f"{label}: classes against exact counts")
    rep = {"counts": moved, "captured": captured, "max_abs_diff": diff}
    print(f"{label}: a warm scene of counts new inside their classes "
          f"captured {captured} programs; against the exact-count programs "
          f"max |diff| {diff}")
    check(captured == 0 and diff == 0.0, f"{label}: classes {rep}")
    return rep


def run_ic_programs(cg, I, PA, V, compare, card, n_halos, n_cases, totals,
                    dev):
    """The IC scene of ``n_halos`` halos in phase 23 (``compare``: its
    :func:`compare_programs`); returns its report and K1's launches."""
    label = f"IC scene {n_halos} halos"
    halos_def = (list(zip(M200, CONC)) + [THIRD_HALO])[:n_halos]
    centers, velocities = ic_geometry(cg, n_halos)
    cases = []
    for k in range(n_cases):
        ms = scene_models(cg, [(m200 * (1.0 + 0.1 * k), c + 0.3 * k)
                               for m200, c in halos_def], device=dev)
        for m in ms:
            m.dm_virial, m.star_virial  # noqa: B018
            m.set_field("metallicity", torch.linspace(
                1.0, 0.1, m.num_elements, dtype=torch.float64, device=dev))
        # the counts' host copies, made once per model
        I.halo_particle_counts(ms, [R_MAX] * n_halos, totals)
        cases.append(ms)
    reports, k1 = {}, 0
    # the counts, from the models' host copies: no read from the card
    counts = I.halo_particle_counts(cases[0], [R_MAX] * n_halos, totals)
    ms = [fresh_copy(cg, V, m) for m in cases[1]]
    syncs = count_syncs(lambda: I.halo_particle_counts(
        ms, [R_MAX] * n_halos, totals))
    _, count_s = timed(lambda: I.halo_particle_counts(
        ms, [R_MAX] * n_halos, totals))
    reports["counts"] = {"s": count_s, "syncs": syncs}
    print(f"{label}: halo_particle_counts {count_s:.5f} s, syncs {syncs} "
          f"[{card}]")
    check(not syncs, f"{label}: the counts synchronized: {syncs}")

    def setup(k):
        # case k draws case 0's counts: the shapes of the first call
        ms = [fresh_copy(cg, V, m) for m in cases[k]]
        halos = ic_draws(I, ms, counts, DRAWS_SEED + k)
        return halos + [ic_combine(PA, halos, ms, centers, velocities)]

    # (halo_generators reads each halo's seeds: syncs outside the programs)
    reports["setup"], first = compare(
        f"{label}: draws and combine on fresh models "
        f"({sum(totals.values())} particles)", setup, 2 * n_halos,
        strict=False)
    k1 += reports["setup"]["k1"]
    *halos, scene = first
    rep = ic_scene_qa(halos, scene, counts, centers, velocities, label)
    rep["density_max_rel_err"] = ic_scene_density_qa(scene, cases[0],
                                                     centers)
    check(rep["density_max_rel_err"] < IC_DENSITY_RTOL,
          f"{label}: mixed density vs scipy {rep['density_max_rel_err']}")
    del first, scene
    reports["classes"] = ic_classes_check(I, PA, cases[1], counts, centers,
                                          velocities, label)
    drawn = [ic_draws(I, cases[k], counts, DRAWS_SEED + k)
             for k in range(n_cases)]

    def combine(k):
        halos = [PA.ClusterParticles.from_fields(dict(h.fields))
                 for h in drawn[k]]
        return ic_combine(PA, halos, cases[k], centers, velocities)

    reports["combine"], scenes = compare(f"{label}: combine", combine, 0)
    del scenes
    eager_part = host_launches(lambda: offsets_and_sum(
        PA, drawn[1], centers, velocities))
    reports["combine"]["offsets_and_sum_host_launches"] = eager_part
    print(f"{label}: combine's eager part (add_offsets, __add__) "
          f"{eager_part} host launches per call [{card}]")
    scenes = [combine(k) for k in range(n_cases)]
    for sc in scenes:
        sc.set_field("gas", "metallicity",
                     torch.zeros(sc.num_particles["gas"], device=dev),
                     passive_scalar=True)

    def resample(k):
        sc = PA.ClusterParticles.from_fields(dict(scenes[k].fields))
        for name in ("particle_mass", "density", "thermal_energy",
                     "particle_velocity", "metallicity"):
            sc.fields["gas", name] = sc.fields["gas", name].clone()
        sc.passive_scalars = ["metallicity"]
        return ic_resample(PA, sc, cases[k], centers, velocities)

    reports["resample"], out = compare(
        f"{label}: resample with a passive scalar (a copy of the gas "
        "columns first)", resample, 0)
    mass0 = scenes[0]["gas", "particle_mass"]
    rep["resample_mass_max_rel_change"] = float(
        ((out["gas", "particle_mass"] - mass0).abs() / mass0).max())
    z = out["gas", "metallicity"]
    check(rep["resample_mass_max_rel_change"] < 1e-12
          and bool(torch.isfinite(z).all()) and float(z.min()) >= 0.1 - 1e-12
          and float(z.max()) <= 1.0 + 1e-12,
          f"{label}: resample {rep}, metallicity [{float(z.min())}, "
          f"{float(z.max())}]")
    reports["qa"] = rep
    print(f"{label} programs: QA", json.dumps(rep))
    return reports, k1


# ----------------------------------------------------------------- phase 24
# the last programs: the 512^3 float32 field and its vector potential, the
# 282^3 float64 radial field over the merger and its sampling at the 5e6
# gas of bench2h-1e7, one painter batch of 64 chunks of 64^3, f8 and f4
LAST = {"field": FIELD_DIMS, "radial": RADIAL_DIMS, "grid": GRID_DIMS,
        "chunk": GRID_CHUNK, "batch": GRID_BATCH, "replays": 3}
LAST_SEED = 400             # case k of a field uses seed LAST_SEED + k


def peak_added(fn):
    """``(fn(), GiB its peak adds to the memory allocated before it)``."""
    sync()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    sync()
    return out, (torch.cuda.max_memory_allocated() - base) / 2**30


def run_last_programs(cg, F, P, DS, K, card, md, dev="cuda", sz=LAST):
    """Phase 24: the fields, the trilinear sampling and the painter as
    captured programs.  Each first (the capture) and ``replays`` warm
    calls with seeds, positions or chunks of their own against the eager
    bodies (``compiled.eager()``) bit for bit (:func:`compare_programs`:
    capture seconds, host launches per warm call, pool growth, static
    bytes, syncs under a program call), with the peak memory a warm call
    adds, graph and eager.  ``md``: phase 19's program reports of the
    mesh batches and the sharded field per rank, printed again here.
    Returns the reports."""
    import numpy as np

    from cluster_generator_tpu_torch.core import compiled as C
    from cluster_generator_tpu_torch.core.interp import cubic_spline

    # a clean memo: each program's first call in this phase is its
    # capture, whose seconds and pool are measured
    C.clear()
    n_cases = sz["replays"] + 1
    reports = {}

    def eager(fn):
        def run(k):
            with C.eager():
                return fn(k)
        return run

    def compare(label, name, graph):
        rep, first = compare_programs(C, K, label, graph, eager(graph),
                                      n_cases, 0, card, syncs_outside=True)
        del first
        check(dev != "cuda" or rep["programs"] == [name],
              f"{label}: programs {rep['programs']}, want [{name}]")
        for side, fn in (("graph", graph), ("eager", eager(graph))):
            _, rep[f"{side}_peak_added_gib"] = peak_added(lambda: fn(1))
        print(f"{label}: peak memory a warm call adds, graph "
              f"{rep['graph_peak_added_gib']:.3f} GiB / eager "
              f"{rep['eager_peak_added_gib']:.3f} GiB [{card}]")
        return rep

    def comps(f):
        return f.gx, f.gy, f.gz

    for cls in ("RandomMagneticField", "RandomMagneticVectorPotential"):
        n = sz["field"]
        reports[cls] = compare(
            f"{cls} {n}^3 float32 program", "_constant_rms_field",
            lambda k, cls=cls: comps(
                make_field(F, cls, n, LAST_SEED + k)))

    models = merger_models(cg)
    grid = sz["radial"] + 2 * math.ceil(0.05 * sz["radial"])   # padding
    reports["radial"] = compare(
        f"RadialRandomMagneticField {grid}^3 float64 program "
        "(two halos)", "_radial_field", lambda k: comps(radial_field(
            F, models, sz["radial"], dev, seed=LAST_SEED + k)))
    field = radial_field(F, models, sz["radial"], dev, seed=LAST_SEED)
    parts, _, _ = run_main_path(P)
    pos = parts["gas", "particle_position"]
    del parts
    moved = [pos * (1.0 + 0.02 * k) for k in range(n_cases)]
    reports["attach"] = compare(
        f"attach_field_to_particles program ({pos.shape[0]} gas, "
        f"{grid}^3)", "_trilinear",
        lambda k: P.attach_field_to_particles(
            {("gas", "particle_position"): moved[k]}, field)[
                "gas", "magnetic_field"])
    del field, moved, pos

    m = build_class_model(cg, device=dev)
    m.set_magnetic_field_from_beta(GRID_BETA)
    sp = cubic_spline(m["radius"], m["density"])
    dims, chunk, b = sz["grid"], sz["chunk"], sz["batch"]
    starts = torch.as_tensor(DS.construct_chunks([dims] * 3, chunk)[
        :, 0, :].T.astype(np.float64), device=dev)
    deltas = torch.full((3,), GRID_BOX / dims, dtype=torch.float64,
                        device=dev)
    left = torch.full((3,), -GRID_BOX / 2.0, dtype=torch.float64,
                      device=dev)
    for f32 in (False, True):
        reports[f"paint_{'f4' if f32 else 'f8'}"] = compare(
            f"painter program {'f4' if f32 else 'f8'} ({b} chunks of "
            f"{chunk}^3, {dims}^3 grid)", "_paint_program",
            lambda k, f32=f32: DS._paint_batch(
                sp, starts[k * b:(k + 1) * b], deltas, left, chunk, f32))
    for name, rep in md.items():
        print(f"phase 19's {name}: " + json.dumps(rep, default=float)
              + f" [{card}]")
    check(all(v == 0.0 for rep in md.values() for k, v in rep.items()
              if k.endswith("max_abs_diff")),
          f"phase 19's programs vs eager: {md}")
    print("last programs:", json.dumps(reports, default=str))
    return reports


# ----------------------------------------------------------------- phase 25
# every path in one process with no compiled.clear() between its steps, under
# a memory cap set from the sequence's need under JAX's memory model
# (scripts/memory_sequence_torch.py), then warm replays that fit


# the headroom under the cap before eager-after-sharded at the parent commit
# 27fc595, whose eager steps made no room: it ran out of memory there
# (PERF.md section 6)
PARENT_EAGER_HEADROOM_GIB = 1.93


def run_memory_sequence(K, card, root):
    """Phase 25: ``scripts/memory_sequence_torch.py``'s steps (class,
    merger, datagen, the 512^3 and 1024^3 fields, the class path and the
    merger joined by the package's eager ``ClusterParticles.__add__``, the
    sharded 1024^3 field on a world of one over NCCL in this process,
    ``eager-after-sharded``: eager only, steps 1-2's particles joined five
    times over, moved and cut into Gadget blocks, datagen and merger
    again),
    each first alone on a clean card under ``compiled.eager()`` (its eager
    peak and its outputs, the reference), then in turn with every output
    kept and no ``compiled.clear()``, under
    ``torch.cuda.set_per_process_memory_fraction`` at the script's
    ``MARGIN`` times the largest of (outputs kept before a step + its eager peak):
    every step runs, each bit for bit its alone run; per step the programs
    released and recaptured and the memory held after it; the eager step
    releases the sharded field's workspace, reruns nothing and launches no
    kernel of the port; then three warm calls each of the merger and the
    datagen batch, which release nothing.  Returns K1's launches in the
    sequence."""
    sys.path.insert(0, os.path.join(root, "scripts"))
    import memory_sequence_torch as MS

    from cluster_generator_tpu_torch.core import compiled as C

    total = torch.cuda.get_device_properties(0).total_memory
    with tempfile.TemporaryDirectory() as d, MS.world_of_one(d) as mesh:
        seq = MS.steps(mesh)
        # (alone() and sequence() each start from a clean card: a baseline)
        refs = MS.alone(seq)
        need = MS.need(seq, refs)
        fraction = min(1.0, MS.MARGIN * need / total)
        print(f"memory sequence: card {total / 2**30:.2f} GiB, need under "
              f"JAX's model {need / 2**30:.2f} GiB, cap {fraction:.4f} of "
              f"the card [{card}]")
        torch.cuda.set_per_process_memory_fraction(fraction)
        try:
            K.invert_cdf_rows.launches = 0
            per_step = {}

            def report(line):
                rec = json.loads(line)
                per_step[rec["step"]] = (rec, K.invert_cdf_rows.launches)
                print(f"memory sequence step: {line} [{card}]")

            records, oom = MS.sequence(seq, refs, report)
            launches = K.invert_cdf_rows.launches
            check(oom is None, f"memory sequence: {oom} ran out of memory")
            warm = {}
            for step in seq[-2:]:
                step.fn({})   # a replay (or a capture after a release) first
                released, walls = C.releases, []
                for _ in range(3):
                    _, s = timed(lambda: step.fn({}))
                    walls.append(s)
                warm[step.name] = {"warm_s": walls,
                                   "released": C.releases - released}
        finally:
            torch.cuda.set_per_process_memory_fraction(1.0)
    names = [s.name for s in seq]
    eager = names.index("eager-after-sharded")
    rec, k1_after = per_step["eager-after-sharded"]
    host, sum_bytes, peak = refs["eager-after-sharded"]
    kept_before = per_step[names[eager - 1]][0]["outputs_kept_gib"]
    print(f"memory sequence eager-after-sharded: "
          f"{MS.JOIN_REPEATS * MS.PARTICLES_PER_JOIN:.3g} particles, sum "
          f"{sum_bytes / 2**30:.2f} GiB, Gadget blocks "
          f"{host[-1].numel() / 2**30:.2f} GiB, eager peak alone "
          f"{peak / 2**30:.2f} GiB; headroom before it "
          f"{rec['headroom_before_gib']:.2f} GiB here, "
          f"{fraction * total / 2**30 - kept_before:.2f} under JAX's "
          f"model, {PARENT_EAGER_HEADROOM_GIB} at the parent commit "
          f"27fc595; released {rec['released']}, reruns {rec['retries']}, "
          f"workspaces held after {rec['workspaces_held']} [{card}]")
    k1_before = per_step[names[eager - 1]][1]
    check(rec["released"] >= 1 and rec["workspaces_held"] == 0,
          f"eager-after-sharded kept the sharded field's workspace {rec}")
    check(rec["retries"] == 0 and rec["captures"] == 0
          and k1_after == k1_before,
          f"eager-after-sharded reran, captured or launched K1 {rec}")
    print(f"memory sequence warm calls under the cap: {json.dumps(warm)} "
          f"[{card}]")
    check(all(r["equal_to_alone"] for r in records),
          f"memory sequence: a step differs from its alone run {records}")
    check(sum(r["released"] for r in records) > 0,
          "memory sequence: nothing was released, the cap tested nothing")
    check(all(w["released"] == 0 for w in warm.values()),
          f"memory sequence: a warm call released programs {warm}")
    check(launches > 0, "memory sequence: K1 never launched")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import cluster_generator_tpu_torch as cg
    from cluster_generator_tpu_torch import fields as F
    from cluster_generator_tpu_torch import pipeline as P
    from cluster_generator_tpu_torch import virial as V
    from cluster_generator_tpu_torch.core import compiled as C
    from cluster_generator_tpu_torch.ops import abel as A
    from cluster_generator_tpu_torch.ops import build
    from cluster_generator_tpu_torch.ops import cdf_inverse as K
    from cluster_generator_tpu_torch.ops import draw_particles as D
    from cluster_generator_tpu_torch.ops import speed_cdf as S
    from cluster_generator_tpu_torch.parallel import ensemble as E
    from cluster_generator_tpu_torch.parallel import mergers as MG
    from cluster_generator_tpu_torch.parallel.qa import QA_TOLERANCES as QA

    print("python", sys.version.split()[0], "torch", torch.__version__,
          "cuda", torch.version.cuda)
    card = nvidia_smi_line()
    print("card (nvidia-smi name, power.limit):", card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    built = build.build_all()
    print(f"built {built} in {time.perf_counter() - t0:.1f} s")

    k1, k1_err = check_k1(P, K, V, E)
    speed, speed_err = check_speed_cdf(P, V, S, E)
    abel, abel_err = check_abel(P, V, A, E)
    draws, draws_err = check_draws(E, D)

    # launches of the speed-CDF kernel on the main paths, one beside each
    # of K1's: each float32 speed table launches both once; and of the
    # Abel kernel, one per DF (DM and stars)
    launches, cdf_launches, abel_launches = {}, {}, {}
    K.invert_cdf_rows.launches = S.speed_cdf_rows_f32.launches = 0
    A.abel_g_rows.launches = 0
    D.draw_collisionless.launches = D.draw_gas.launches = 0
    parts, _, first_s = run_main_path(P)
    launches["merger"] = K.invert_cdf_rows.launches
    cdf_launches["merger"] = S.speed_cdf_rows_f32.launches
    abel_launches["merger"] = A.abel_g_rows.launches
    draw_launches = {"merger": D.draw_collisionless.launches
                     + D.draw_gas.launches}
    print(f"main path first run: {first_s:.3f} s; K1 launches "
          f"{launches['merger']}, speed-CDF kernel {cdf_launches['merger']}, "
          f"Abel kernel {abel_launches['merger']}")
    check(launches["merger"] == 2 and cdf_launches["merger"] == 2
          and abel_launches["merger"] == 2,
          f"the merger path launched K1 {launches['merger']} times, the "
          f"speed-CDF kernel {cdf_launches['merger']}, the Abel kernel "
          f"{abel_launches['merger']}, want 2 each")
    check(draw_launches["merger"] == 0,
          f"the merger path launched the datagen's draw kernel "
          f"{draw_launches['merger']} times")
    check_main_path(parts)
    del parts
    warm = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        parts, _, s = run_main_path(P)
        del parts
        warm.append(s)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"main path warm runs: {[round(s, 4) for s in warm]} s, median "
          f"{statistics.median(warm):.4f} s, peak memory {peak:.2f} GiB "
          f"[{card}]")
    stages = stage_times(P)
    print("warm stage seconds:", json.dumps(
        {k: round(v, 4) for k, v in stages.items()}))

    K.invert_cdf_rows.launches = S.speed_cdf_rows_f32.launches = 0
    A.abel_g_rows.launches = 0
    D.draw_collisionless.launches = D.draw_gas.launches = 0
    parts, _, om_s = run_main_path(P, r_a=MERGER_R_A, n_tracer=N_TRACER,
                                   compute_potential=True)
    launches["merger_switches"] = K.invert_cdf_rows.launches
    cdf_launches["merger_switches"] = S.speed_cdf_rows_f32.launches
    abel_launches["merger_switches"] = A.abel_g_rows.launches
    draw_launches["merger_switches"] = (D.draw_collisionless.launches
                                        + D.draw_gas.launches)
    print(f"merger with r_a = {MERGER_R_A:g} kpc, {sum(N_TRACER)} tracers and "
          f"potentials: {om_s:.3f} s; K1 launches "
          f"{launches['merger_switches']}, speed-CDF kernel "
          f"{cdf_launches['merger_switches']}, Abel kernel "
          f"{abel_launches['merger_switches']} [{card}]")
    check(launches["merger_switches"] == 2
          and cdf_launches["merger_switches"] == 2
          and abel_launches["merger_switches"] == 2,
          f"launches: K1 {launches['merger_switches']}, speed CDF "
          f"{cdf_launches['merger_switches']}, Abel "
          f"{abel_launches['merger_switches']}, want 2 each")
    check(draw_launches["merger_switches"] == 0,
          f"the merger with switches launched the datagen's draw kernel "
          f"{draw_launches['merger_switches']} times")
    check_merger_switches(parts)
    del parts

    k1_by, cdf_by, draws_by = run_datagen(E, K, S, D, QA, card)
    launches.update(k1_by)
    cdf_launches.update(cdf_by)
    draw_launches.update(draws_by)
    launches["class"], cdf_launches["class"] = run_class_path(cg, K, S, V,
                                                              card)
    k1_by, cdf_by = run_scenes(MG, K, S, D, card)
    launches.update(k1_by)
    cdf_launches.update(cdf_by)
    draw_launches.update({label: 0 for label in k1_by})
    check(all(n > 0 for n in launches.values()),
          f"a path never launched K1: {launches}")

    device_agreement(P)
    grad = run_gradient(E)
    run_fields(F, card)
    run_radial_field(cg, F, P, card)

    from cluster_generator_tpu_torch import codes as CO
    from cluster_generator_tpu_torch import ics as I
    from cluster_generator_tpu_torch import particles as PA

    for n_halos in (2, 3):
        launches[f"ic_scene_{n_halos}"] = run_ic_scene(cg, I, PA, CO, K,
                                                       card, n_halos)
    errs = ic_device_agreement(cg, I, PA)
    print(f"IC scene card vs CPU ({sum(IC_CPU_COUNTS.values())} particles "
          "per halo, combine and resample), max |diff| / max |CPU|:",
          json.dumps({k: f"{v:.1e}" for k, v in errs.items()}),
          f"(limit {IC_CPU_RTOL})")
    check(all(v < IC_CPU_RTOL for v in errs.values()),
          f"IC scene card vs CPU: {errs}")

    from cluster_generator_tpu_torch import data_structures as DS

    launches["catalog"] = run_catalog(E, K, PA, card)
    launches["merger_catalog"] = run_merger_catalog(MG, K, PA, card)
    run_grid(cg, DS, card)

    run_cli(card)
    run_native_grid(cg, DS, card)
    K.invert_cdf_rows.launches = S.speed_cdf_rows_f32.launches = 0
    run_tooling(P, E, card)
    launches["tooling"] = K.invert_cdf_rows.launches
    cdf_launches["tooling"] = S.speed_cdf_rows_f32.launches
    check(launches["tooling"] == 4 and cdf_launches["tooling"] == 4,
          f"the tooling phase launched K1 {launches['tooling']} times, the "
          f"speed-CDF kernel {cdf_launches['tooling']}, want 4 each (merger "
          "IC 2, datagen batch 2)")
    check(all(n > 0 for n in launches.values()),
          f"a path never launched K1: {launches}")

    # the ranks are other processes on this card, whose needs make_room
    # cannot see: the memoized programs go first
    C.clear()
    md_launches, md_programs = run_multidevice(card)
    launches.update(md_launches)

    root = os.path.dirname(os.path.abspath(__file__))
    run_examples(card, root)
    launches.update(run_compiled(P, E, MG, K, card))
    launches.update(run_class_programs(cg, P, V, E, K, card, grad))
    launches.update(run_draw_programs(cg, I, PA, V, K, card))
    run_last_programs(cg, F, P, DS, K, card, md_programs)
    launches["memory_sequence"] = run_memory_sequence(K, card, root)

    # one entry per kernel; its numbers are those of the shape where it is
    # bound by bytes (the ensemble batch's DM rows), every path shape is in
    # "shapes", and "launches" sums the runs of the main paths (the scene
    # batches' DM rows have the same shape, the IC scenes' rows the class
    # path's): K1's of every phase, the speed-CDF kernel's of phases 4-7,
    # 12 and 18, where each is checked against K1's
    top = k1["datagen_dm"]
    kernels = [{
        "name": "invert_cdf_rows",
        "route": "cuda",
        "source": "cluster_generator_tpu_torch/ops/csrc/invert_cdf_rows.cu",
        "replaces": "cluster_generator_tpu/ops/pallas_kernels.py:80",
        "launches": sum(launches.values()),
        "launches_by_path": launches,
        "max_abs_err": k1_err,
        "ms": top["ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
        "library_ms": top["library_ms"],
        "shape": top["shape"], "shapes": list(k1.values()),
    }, {
        "name": "speed_cdf_rows",
        "route": "cuda",
        "source": "cluster_generator_tpu_torch/ops/csrc/speed_cdf_rows.cu",
        "replaces": None,
        "launches": sum(cdf_launches.values()),
        "launches_by_path": cdf_launches,
        "max_abs_err": speed_err,
        **{k: speed["datagen_dm"][k] for k in
           ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "shape")},
        "shapes": list(speed.values()),
    }, {
        "name": "abel_g_rows",
        "route": "cuda",
        "source": "cluster_generator_tpu_torch/ops/csrc/abel_g_rows.cu",
        "replaces": None,
        "launches": sum(abel_launches.values()),
        "launches_by_path": abel_launches,
        "max_row_err": abel_err,
        **{k: abel["datagen_dm"][k] for k in
           ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "shape")},
        "shapes": list(abel.values()),
    }, {
        "name": "draw_particles",
        "route": "cuda",
        "source": "cluster_generator_tpu_torch/ops/csrc/draw_particles.cu",
        "replaces": None,
        "launches": sum(draw_launches.values()),
        "launches_by_path": draw_launches,
        "max_abs_err": draws_err,
        **{k: draws["datagen_dm"][k] for k in
           ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "shape")},
        "shapes": list(draws.values()),
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
