#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:

1. print the card (``nvidia-smi``) and switch TF32 off;
2. build every CUDA kernel under ``cluster_generator_tpu_torch/ops/csrc``
   (one ``nvcc`` per source, all started together);
3. hold each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, and time kernel, plain version and a
   library yardstick;
4. drive the main path, ``merger_ic_fused``, at the full 1e7-particle
   binary-merger workload: one first run and three warm runs, then check
   counts, dtypes, finiteness, bulk velocities and that the main path
   launched every kernel;
5. build the models, tables and a small draw with the same uniforms on the
   card and on the CPU and compare them;
6. print one JSON line of kernel numbers;
7. print the card's name and power limit, then the last line
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

K1_TOL = 5e-6       # kernel vs plain version, max |difference| in s
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


def check_k1(P, K, V):
    """K1 against its plain version on the card; returns the timing rows."""
    dev = torch.device("cuda")
    fields = P.build_merger_models(M200, CONC, device=dev)
    cases = []
    for kind, kw in P.speed_table_inputs(fields).items():
        n_q = kw.pop("n_q")
        cdf = V.speed_cdf_rows(**kw)
        cdf = cdf.to(torch.float32).reshape(-1, cdf.shape[-1]).contiguous()
        cases.append((kind, cdf, n_q))
    gen = torch.Generator(device=dev).manual_seed(17)
    cases.append(("ragged_17x256", random_cdf(17, 256, gen, dev), 128))
    cases.append(("ragged_17x1024", random_cdf(17, 1024, gen, dev), 512))
    ident = torch.linspace(0.0, 1.0, 64, device=dev).expand(3, 64)
    cases.append(("identity", ident.contiguous(), 33))
    flat = torch.tensor([[0.0, 0.2, 0.2, 0.2, 0.5, 0.5, 1.0, 1.0]],
                        device=dev)
    cases.append(("flat_bins", flat, 15))

    rows = {}
    for name, cdf, n_q in cases:
        got = K.invert_cdf_rows(cdf, n_q)
        want = K.invert_cdf_rows_plain(cdf, n_q)
        sync()
        check(got.shape == (cdf.shape[0], n_q) and got.dtype == torch.float32,
              f"K1 {name}: shape {tuple(got.shape)} dtype {got.dtype}")
        check(bool(torch.isfinite(got).all()), f"K1 {name}: non-finite")
        err = float((got - want).abs().max())
        print(f"K1 {name}: {tuple(cdf.shape)} -> {n_q}  max|kernel - plain| "
              f"= {err:.3e}")
        check(err < K1_TOL, f"K1 {name}: max |kernel - plain| {err} "
              f">= {K1_TOL}")
        if name == "identity":
            q = torch.linspace(0.0, 1.0, n_q, device=dev)
            ierr = float((got - q).abs().max())
            check(ierr < 1e-6, f"K1 identity row off by {ierr}")
        if name == "flat_bins":
            # q = 1 lands in the right-closed last bin, at s_{n_s-2}
            top = float(torch.tensor(6.0) * torch.tensor(1.0 / 7.0))
            check(float(got[0, -1]) == top,
                  f"K1 q=1 gave {float(got[0, -1])}, want {top}")
        if name in ("dm", "star"):
            lib = searchsorted_lerp(cdf, n_q)
            lerr = float((lib - want).abs().max())
            ms = cuda_ms(lambda: K.invert_cdf_rows(cdf, n_q), 200)
            plain_ms = cuda_ms(lambda: K.invert_cdf_rows_plain(cdf, n_q), 5)
            lib_ms = cuda_ms(lambda: searchsorted_lerp(cdf, n_q), 200)
            bound, bound_by = k1_bound_ms(cdf.shape[0], cdf.shape[1], n_q)
            print(f"K1 {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"searchsorted+lerp {lib_ms:.4f} ms (max|lib - plain| "
                  f"{lerr:.1e}), bound {bound:.5f} ms ({bound_by})")
            rows[name] = {"shape": f"{cdf.shape[0]}x{cdf.shape[1]}->{n_q}",
                          "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": bound, "bound_by": bound_by,
                          "library_ms": lib_ms}
    return rows


# ------------------------------------------------------------------ phase 4
def run_main_path(P):
    gen = torch.Generator(device="cuda").manual_seed(0)
    sync()
    t0 = time.perf_counter()
    parts, fields = P.merger_ic_fused(M200, CONC, CENTERS, VELOCITIES, R_MAX,
                                      N_GAS, N_DM, N_STAR, generator=gen,
                                      device="cuda")
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


# -------------------------------------------------------------------- main
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from cluster_generator_tpu_torch import pipeline as P
    from cluster_generator_tpu_torch import virial as V
    from cluster_generator_tpu_torch.ops import build
    from cluster_generator_tpu_torch.ops import cdf_inverse as K

    print("python", sys.version.split()[0], "torch", torch.__version__,
          "cuda", torch.version.cuda)
    card = nvidia_smi_line()
    print("card (nvidia-smi name, power.limit):", card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    built = build.build_all()
    print(f"built {built} in {time.perf_counter() - t0:.1f} s")

    k1 = check_k1(P, K, V)

    K.invert_cdf_rows.launches = 0
    parts, _, first_s = run_main_path(P)
    launches = K.invert_cdf_rows.launches
    print(f"main path first run: {first_s:.3f} s; K1 launches {launches}")
    check(launches > 0, "the main path never launched K1")
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

    device_agreement(P)

    dm = k1["dm"]
    kernels = [{
        "name": "invert_cdf_rows",
        "route": "cuda",
        "source": "cluster_generator_tpu_torch/ops/csrc/invert_cdf_rows.cu",
        "replaces": "cluster_generator_tpu/ops/pallas_kernels.py:80",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in k1.values()),
        "ms": dm["ms"], "plain_ms": dm["plain_ms"],
        "bound_ms": dm["bound_ms"], "bound_by": dm["bound_by"],
        "library_ms": dm["library_ms"],
        "shape": dm["shape"], "star": k1["star"],
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
