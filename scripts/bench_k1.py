#!/usr/bin/env python3
"""Kernel K1 (inverse of CDF rows) alone, at the shapes of the four main
paths, on one NVIDIA card.

    python3 scripts/bench_k1.py [--other PATH.cu] [--variant NAME]...

For each shape (the class path's 256x512->512 for DM, stars and
Osipkov-Merritt DM of one 4096-point model; merger DM 512x512->512 and
stars 128x256->256; ensemble batch of 256 clusters DM 32768x512->512 and
stars 16384x256->256; merger-scene batch of 64 two-halo scenes DM
32768x512->512 and stars 8192x256->256) the CDF
rows are the ones the port builds (``virial.speed_cdf_rows``), and one JSON
line gives: max |kernel - plain|, device ms per launch by CUDA events over
``--reps`` back-to-back launches of the bare C function (no allocation), the
same through the Python wrapper, the profiler's device time of the kernel
itself, the byte bound, and ``torch.searchsorted`` + lerp as the library
yardstick.  The ensemble buffers (128 MiB and 32 MiB) exceed or fill the
50 MB L2, so back-to-back launches read from HBM; the merger and class
shapes (2 MiB and less) stay resident in L2.

``--other PATH.cu`` builds a second source with the same C entry point
(``cg_invert_cdf_rows``), for instance an earlier revision taken with
``git show <commit>:cluster_generator_tpu_torch/ops/csrc/invert_cdf_rows.cu``,
and times the two in turns (other, this, this, other) inside the one run.
``--variant NAME`` (repeatable) does the same with a variant of the current
source made by the textual substitutions in ``VARIANTS``: experiments that
show what bounds the kernel, not candidates for use (``no_compute`` gives
wrong results on purpose).

Needs a CUDA device and ``nvcc``; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (cuda_ms, k1_bound_ms, k1_edge_cases,  # noqa: E402
                        k1_path_cases, nvidia_smi_line, searchsorted_lerp)
from portbench.yardstick import kernels as yard_kernels  # noqa: E402
from portbench.yardstick import trace as yard_trace  # noqa: E402

ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p]


# name -> [(text in csrc/invert_cdf_rows.cu, its replacement), ...]
VARIANTS = {
    # loads, zeroing and stores only: the floor of the kernel's memory side
    "no_compute": [(
        "    for (int p0 = warp_in_team * kBinsPerWarp; p0 < n_s - 1;\n",
        "    for (int p0 = n_s; p0 < n_s - 1;\n")],
    # the run of quantiles of one bin, not unrolled
    "no_unroll": [(
        "        for (int m = m_lo; m < m_hi; ++m, mf += 1.0f) {",
        "#pragma unroll 1\n"
        "        for (int m = m_lo; m < m_hi; ++m, mf += 1.0f) {")],
    # the count corrected by one predicated step either way, without loops
    # (the estimate is never off by more than 1)
    "one_step_count": [
        ("  while (m > 0.0f && __fmul_rn(m - 1.0f, dq) >= c) m -= 1.0f;\n",
         "  const bool down = m > 0.0f && __fmul_rn(m - 1.0f, dq) >= c;\n"),
        ("  while (m < n_qf && __fmul_rn(m, dq) < c) m += 1.0f;\n",
         "  const bool up = m < n_qf && __fmul_rn(m, dq) < c;\n"
         "  m = down ? m - 1.0f : (up ? m + 1.0f : m);\n")],
}


def build_other(path, label="other"):
    from cluster_generator_tpu_torch.ops import build

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    target = build.BUILD_DIR / f"lib{label}_invert_cdf_rows.so"
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(target),
                    str(path)], check=True)
    fn = ctypes.CDLL(str(target)).cg_invert_cdf_rows
    fn.argtypes, fn.restype = ARGTYPES, ctypes.c_int
    return fn


def build_variant(name):
    from cluster_generator_tpu_torch.ops import build

    src = (build.CSRC / "invert_cdf_rows.cu").read_text()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} is not in the "
                               "source exactly once")
        src = src.replace(old, new)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = build.BUILD_DIR / f"variant_{name}.cu"
    path.write_text(src)
    return build_other(path, name)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", default=None)
    ap.add_argument("--variant", action="append", default=[],
                    choices=sorted(VARIANTS))
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_k1: no CUDA device", file=sys.stderr)
        return 1
    from cluster_generator_tpu_torch import pipeline as P
    from cluster_generator_tpu_torch import virial as V
    from cluster_generator_tpu_torch.ops import build
    from cluster_generator_tpu_torch.ops import cdf_inverse as K
    from cluster_generator_tpu_torch.parallel import ensemble as E

    torch.backends.cuda.matmul.allow_tf32 = False
    card = nvidia_smi_line()
    this = build.entry_point("invert_cdf_rows", K.ARGTYPES)
    # every source timed beside the current one, by label
    others = {"other": build_other(args.other)} if args.other else {}
    others.update((name, build_variant(name)) for name in args.variant)
    contenders = list(others.items()) + [("this", this)]

    def bare_call(fn, cdf, n_q):
        n_rows, n_s = cdf.shape
        ds, dq = K._steps(n_s, n_q)
        out = torch.empty((n_rows, n_q), dtype=torch.float32, device="cuda")
        err = fn(cdf.data_ptr(), out.data_ptr(), n_rows, n_s, n_q, ds, dq,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError_t {err}")
        return out

    edge = {}
    for name, cdf, n_q in k1_edge_cases(torch.device("cuda")):
        want = K.invert_cdf_rows_plain(cdf, n_q)
        for label, fn in contenders:
            got = bare_call(fn, cdf, n_q)
            torch.cuda.synchronize()
            edge[f"{label}/{name}"] = float((got - want).abs().max())
    print(json.dumps({"edge_rows_max_abs_err": edge}))

    for name, cdf, n_q in k1_path_cases(P, V, E):
        n_rows, n_s = cdf.shape
        ds, dq = K._steps(n_s, n_q)
        out = torch.empty((n_rows, n_q), dtype=torch.float32, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def bare(fn):
            err = fn(cdf.data_ptr(), out.data_ptr(), n_rows, n_s, n_q, ds,
                     dq, stream)
            if err:
                raise RuntimeError(f"launch failed: cudaError_t {err}")

        want = K.invert_cdf_rows_plain(cdf, n_q)
        row = {"shape": f"{n_rows}x{n_s}->{n_q}", "name": name, "card": card,
               "reps": args.reps}
        for label, fn in contenders:
            out.zero_()
            bare(fn)
            torch.cuda.synchronize()
            row[f"{label}_max_abs_err"] = float((out - want).abs().max())
        for label, fn in contenders + contenders[::-1]:
            row.setdefault(f"{label}_bare_ms", []).append(
                cuda_ms(lambda: bare(fn), args.reps))
        row["this_wrapper_ms"] = cuda_ms(
            lambda: K.invert_cdf_rows(cdf, n_q), args.reps)
        own_us, n_own = 0.0, 0
        for _ in range(3):  # a trace now and then comes back without kernels
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    K.invert_cdf_rows(cdf, n_q)
                torch.cuda.synchronize()
            events = yard_trace.events_of(prof)
            own_us, n_own = yard_trace.kernel_us(
                events, yard_trace.extent(events), yard_kernels.K1_NAME)
            if n_own:
                break
        row["this_profiler_kernel_ms"] = (own_us / 1e3 / n_own if n_own
                                          else None)
        row["profiler_kernel_launches"] = n_own
        row["library_ms"] = cuda_ms(lambda: searchsorted_lerp(cdf, n_q),
                                    max(10, args.reps // 10))
        bound, by = k1_bound_ms(n_rows, n_s, n_q)
        row["bound_ms"], row["bound_by"] = bound, by
        row["this_over_bound"] = min(row["this_bare_ms"]) / bound
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
