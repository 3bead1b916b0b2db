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
4. drive the first main path, ``merger_ic_fused``, at the full
   1e7-particle binary-merger workload: one first run and three warm runs,
   then check counts, dtypes, finiteness, bulk velocities and that the
   path launched every kernel;
5. the same call once with Osipkov-Merritt anisotropy, tracers and
   particle potentials, at the same counts;
6. drive the second main path, ``datagen_batches``, at the ensemble
   product's defaults (batches of 256 clusters, a 512-point grid, 1e5
   particles per cluster over three species): one first batch, a stream
   of 512 clusters, one Osipkov-Merritt batch.  Every batch must launch
   K1 twice, hold no non-finite value and pass the physics QA of the
   draws (radius, local escape speed, mass budget, gas energy, KS of the
   radii, and for the OM batch the anisotropy profile);
7. drive the third main path, the single-cluster class API
   (``ClusterModel.from_dens_and_tden`` on a 4096-point grid, the
   hydrostatic and virial checks, ``generate_*_particles`` for 1.05e7
   particles, ``VirialEquilibrium(r_a=...)``, the other constructors and
   the MOND laws), with its physics QA on the card, K1's launches (one
   per species and model, none for a second draw) and card against CPU
   for the fields, the DFs and the speed table;
8. build the merger's models, tables and a small draw with the same
   uniforms on the card and on the CPU and compare them;
9. the gradient of the central pressure with respect to M200 through the
   whole model build (the implicit gradient of r500 included) against a
   central difference;
10. the random fields: the 512^3 float32 divergence-free magnetic field
    (first run, three warm runs, peak memory) with its rms, divergence and
    spectrum checks, once at 1024^3, the vector potential with the curl
    check at 128^3;
11. a float64 radial magnetic field over the merger IC (two class-path
    models, 282^3 with padding) attached to the 5e6 gas particles of the
    1e7-particle IC and mapped onto a ``ClusterParticles``; card against
    CPU for a 64^3 field and for the trilinear sampling;
12. the fourth main path, the merger-scene batches at cfg6 (256 binary
    scenes of 1e5 particles, batches of 64, a 512-point grid): first
    batch, the warm stream, one Osipkov-Merritt batch, each with K1's
    launches and the physics QA of the scene catalog on the card;
13. print one JSON line of kernel numbers;
14. print the card's name and power limit, then the last line
    ``{"ok": true, "device": {...}}``.

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

# H100 SXM published peaks (NVIDIA data sheet), for the kernels' bounds
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

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
# DFs, card vs CPU: f(E) is the derivative of a spline of an Abel sum, which
# turns the fields' ~5e-15 into ~5e-9 on a 1000-point grid and, the knots
# being 4x closer, ~1.5e-8 on this one
CLASS_DF_RTOL = 5e-8

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

K1_TOL = 0.0        # kernel vs plain version: bit-identical
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


def kernel_profile(fn):
    """``fn`` once under ``torch.profiler``: ``(wall ms, the kernels' device
    events, device busy ms)``.  The profiler slows the host, so the busy
    share it gives is a lower bound of the unprofiled one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return wall * 1e3, kern, busy_us(kern) / 1e3


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
    nbytes = 4 * n_rows * (n_s + n_q)
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


def k1_path_cases(P, V, E):
    """K1's inputs on the four main paths, built by the port on the card:
    ``[(name, float32 CDF rows, n_q), ...]`` for the merger's DM and star
    tables (two halos), the ensemble batch's (256 clusters), the class
    path's (one cluster on a 4096-point grid, 256 rows per species) and
    the scene batch's (64 scenes of two halos)."""
    import cluster_generator_tpu_torch as cg
    from cluster_generator_tpu_torch.parallel import mergers as MG

    cases = class_cdf_cases(V, build_class_model(cg))
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
    for path, per_species in inputs.items():
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
    """Warm seconds of each of the four stages, synchronised."""
    out = {}
    gen = torch.Generator(device="cuda").manual_seed(1)

    def clock(name, fn):
        sync()
        t0 = time.perf_counter()
        res = fn()
        sync()
        out[name] = time.perf_counter() - t0
        return res

    fields = clock("models", lambda: P.build_merger_models(M200, CONC,
                                                           device="cuda"))
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


def run_datagen(E, K, QA, card):
    """The ensemble datagen path at full width; returns K1's launches on
    each of its three runs."""
    counts = DATAGEN_COUNTS
    per_cluster = sum(counts.values())
    M, c = E.sample_ensemble_params(
        torch.Generator(device="cuda").manual_seed(DATAGEN_SEED),
        DATAGEN_CLUSTERS)
    kw = dict(batch_size=DATAGEN_BATCH, num_points=DATAGEN_POINTS,
              seed=DATAGEN_SEED, device="cuda")
    launches = {}

    def stream(M, c, **extra):
        """Consume ``datagen_batches``; seconds until every batch is done
        and the batches' outputs."""
        torch.cuda.reset_peak_memory_stats()
        K.invert_cdf_rows.launches = 0
        sync()
        t0 = time.perf_counter()
        outs = list(E.datagen_batches(M, c, counts, **dict(kw, **extra)))
        sync()
        return (time.perf_counter() - t0, outs, K.invert_cdf_rows.launches,
                torch.cuda.max_memory_allocated() / 2**30)

    B = DATAGEN_BATCH
    first_s, outs, launches["datagen_first"], peak = stream(M[:B], c[:B])
    print(f"datagen first batch ({B} clusters x {per_cluster} particles): "
          f"{first_s:.3f} s; K1 launches {launches['datagen_first']}; peak "
          f"memory {peak:.2f} GiB [{card}]")
    check(launches["datagen_first"] == 2,
          f"K1 launches per batch {launches['datagen_first']}, want 2")
    datagen_qa(E, QA, M[:B], c[:B], outs[0][1], None, "datagen batch 0")
    del outs

    total_s, outs, launches["datagen"], peak = stream(M, c)
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
    check(launches["datagen"] == 2 * n_batches,
          f"K1 launches {launches['datagen']}, want {2 * n_batches}")
    for b0, out in outs:
        bad = E.nonfinite_counts(out)
        check(all(v == 0 for v in bad.values()),
              f"datagen batch {b0}: non-finite {bad}")
    b0, out = outs[-1]
    datagen_qa(E, QA, M[b0:b0 + B], c[b0:b0 + B], out, None,
               f"datagen batch {b0}")
    del outs, out

    Bo = DATAGEN_OM_BATCH
    om_s, outs, launches["datagen_om"], peak = stream(
        M[:Bo], c[:Bo], batch_size=Bo, anisotropy_radius=DATAGEN_R_A)
    print(f"datagen Osipkov-Merritt batch (r_a = {DATAGEN_R_A:g} kpc, {Bo} "
          f"clusters): {om_s:.3f} s, {Bo / om_s:.1f} clusters/s; K1 launches "
          f"{launches['datagen_om']}; peak memory {peak:.2f} GiB [{card}]")
    check(launches["datagen_om"] == 2,
          f"K1 launches of the OM batch {launches['datagen_om']}, want 2")
    datagen_qa(E, QA, M[:Bo], c[:Bo], outs[0][1], DATAGEN_R_A,
               "datagen OM batch")
    return launches


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
    for name, v_cpu, v_gpu in (("dm", m_cpu.dm_virial, m_gpu.dm_virial),
                               ("star", m_cpu.star_virial,
                                m_gpu.star_virial)):
        a, b = v_cpu.df, v_gpu.df.cpu()
        err = float(((a - b).abs() / (a.abs() + 1e-9 * a.abs().max())).max())
        print(f"class {name} DF card vs CPU: max rel {err:.2e}")
        check(err < CLASS_DF_RTOL,
              f"class {name} DF: card vs CPU {err} >= {CLASS_DF_RTOL}")
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


def run_class_path(cg, K, V, card):
    """The single-cluster class path at full width; returns K1's launches
    over the phase (DM, stars, Osipkov-Merritt DM: 3)."""
    n = CLASS_COUNTS
    r_max = R_MAX
    torch.cuda.reset_peak_memory_stats()
    K.invert_cdf_rows.launches = 0
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
    check(K.invert_cdf_rows.launches == 2,
          f"class path: K1 launches {K.invert_cdf_rows.launches}, want 2 "
          "(one per species)")
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
    check(K.invert_cdf_rows.launches == 3,
          f"class OM: K1 launches {K.invert_cdf_rows.launches}, want 3")
    rep = class_species_qa(m, p_om, "dm", CLASS_OM_COUNT, r_max)
    print(f"class Osipkov-Merritt (r_a = {CLASS_R_A:g} kpc): DF {om_s:.3f} s, "
          f"{CLASS_OM_COUNT} draws {om_draw_s:.3f} s; QA", json.dumps(rep))
    beta = beta_profile(p_om["dm", "particle_position"],
                        p_om["dm", "particle_velocity"], CLASS_R_A,
                        "class OM dm")
    check(len(beta) >= 4, "too few populated bins for the class OM beta")
    del p_om
    launches = K.invert_cdf_rows.launches

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
    return launches


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
    (256 points, no DF): autograd against a central difference."""
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
    potential, float32, timed, with QA on the card."""
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

    torch.cuda.reset_peak_memory_stats()
    f, big_s = timed(lambda: make_field(F, "RandomMagneticField",
                                        FIELD_BIG_DIMS, FIELD_SEED))
    peak_big = torch.cuda.max_memory_allocated() / 2**30
    rep = field_qa(f, FIELD_B_RMS, f"field {FIELD_BIG_DIMS}^3")
    del f
    print(f"RandomMagneticField {FIELD_BIG_DIMS}^3 float32: {big_s:.4f} s "
          f"(first at this size), peak memory {peak_big:.2f} GiB [{card}]; "
          "QA:", json.dumps(rep))

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
def merger_models(cg):
    """The merger's two halos as class-path models with beta = 100 B
    fields."""
    models = []
    for m200, conc in zip(M200, CONC):
        rhog, rhot = class_profiles(cg, m200, conc)
        m = cg.ClusterModel.from_dens_and_tden(
            0.1, 1e4, rhog, rhot, stellar_density=0.02 * rhot)
        m.set_magnetic_field_from_beta(RADIAL_BETA)
        models.append(m)
    return models


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


def run_scenes(MG, K, card):
    """The merger-scene batches at cfg6; returns K1's launches on each of
    the three runs."""
    p = scene_params(MG, SCENES)
    per_scene = sum(sum(v) for v in SCENE_COUNTS.values())
    launches = {}

    def stream(n, **extra):
        sub = {k: v[:n] for k, v in p.items()}
        torch.cuda.reset_peak_memory_stats()
        K.invert_cdf_rows.launches = 0
        sync()
        t0 = time.perf_counter()
        outs = list(MG.merger_scene_batches(
            sub, SCENE_COUNTS, batch_size=SCENE_BATCH,
            num_points=SCENE_POINTS, r_max=R_MAX, seed=SCENE_SEED,
            device="cuda", **extra))
        sync()
        return (time.perf_counter() - t0, outs, K.invert_cdf_rows.launches,
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

    first_s, outs, launches["scenes_first"], peak = stream(SCENE_BATCH)
    print(f"scene batch first ({SCENE_BATCH} binary scenes x {per_scene} "
          f"particles): {first_s:.3f} s; K1 launches "
          f"{launches['scenes_first']}; peak memory {peak:.2f} GiB [{card}]")
    check(launches["scenes_first"] == 2,
          f"K1 launches per scene batch {launches['scenes_first']}, want 2")
    qa(0, outs[0][1], "scene batch 0")
    del outs

    total_s, outs, launches["scenes"], peak = stream(SCENES)
    n_b = len(outs)
    print(f"scene stream, warm: {n_b} batches in {total_s:.3f} s = "
          f"{total_s / n_b:.4f} s per batch, {SCENES / total_s:.1f} scenes/s, "
          f"{SCENES * per_scene / total_s:.4g} particles/s; K1 launches "
          f"{launches['scenes']} ({launches['scenes'] / n_b:g} per batch); "
          f"peak memory {peak:.2f} GiB with {n_b} batches of output held "
          f"[{card}]")
    check(launches["scenes"] == 2 * n_b,
          f"K1 launches {launches['scenes']}, want {2 * n_b}")
    for b0, out in outs:
        qa(b0, out, f"scene batch {b0}")
    del outs

    om_s, outs, launches["scenes_om"], peak = stream(
        SCENE_BATCH, anisotropy_radius=SCENE_R_A)
    print(f"scene Osipkov-Merritt batch (r_a = {SCENE_R_A:g} kpc): "
          f"{om_s:.3f} s; K1 launches {launches['scenes_om']}; peak memory "
          f"{peak:.2f} GiB [{card}]")
    check(launches["scenes_om"] == 2,
          f"K1 launches of the OM batch {launches['scenes_om']}, want 2")
    qa(0, outs[0][1], "scene OM batch", r_a=SCENE_R_A)
    return launches


# -------------------------------------------------------------------- main
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import cluster_generator_tpu_torch as cg
    from cluster_generator_tpu_torch import fields as F
    from cluster_generator_tpu_torch import pipeline as P
    from cluster_generator_tpu_torch import virial as V
    from cluster_generator_tpu_torch.ops import build
    from cluster_generator_tpu_torch.ops import cdf_inverse as K
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

    launches = {}
    K.invert_cdf_rows.launches = 0
    parts, _, first_s = run_main_path(P)
    launches["merger"] = K.invert_cdf_rows.launches
    print(f"main path first run: {first_s:.3f} s; K1 launches "
          f"{launches['merger']}")
    check(launches["merger"] == 2,
          f"the merger path launched K1 {launches['merger']} times, want 2")
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

    K.invert_cdf_rows.launches = 0
    parts, _, om_s = run_main_path(P, r_a=MERGER_R_A, n_tracer=N_TRACER,
                                   compute_potential=True)
    launches["merger_switches"] = K.invert_cdf_rows.launches
    print(f"merger with r_a = {MERGER_R_A:g} kpc, {sum(N_TRACER)} tracers and "
          f"potentials: {om_s:.3f} s; K1 launches "
          f"{launches['merger_switches']} [{card}]")
    check(launches["merger_switches"] == 2,
          f"K1 launches {launches['merger_switches']}, want 2")
    check_merger_switches(parts)
    del parts

    launches.update(run_datagen(E, K, QA, card))
    launches["class"] = run_class_path(cg, K, V, card)
    launches.update(run_scenes(MG, K, card))
    check(all(n > 0 for n in launches.values()),
          f"a path never launched K1: {launches}")

    device_agreement(P)
    run_gradient(E)
    run_fields(F, card)
    run_radial_field(cg, F, P, card)

    # one entry per kernel; its numbers are those of the shape where it is
    # bound by bytes (the ensemble batch's DM rows), every path shape is in
    # "shapes", and "launches" sums the runs of the main paths (the scene
    # batches' DM rows have the same shape)
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
