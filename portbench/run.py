"""Run one cell of the benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  Set-up (imports, the CUDA context, the
kernel's build or load from ``build/kernels/``, and the warm-up and capture
of the cell's own programs) counts from the start of this script to the
first timed call.  ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics from a profiled window.  Either way the
window's output is checked against the plain reference once the window has
closed.  The last line of standard output is the result as one JSON object;
the numbers compared, each with its limit, are the last lines of standard
error.  Exits 2, printing no result, without enough CUDA cards, and 3 when
JAX or the JAX package got loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _environment():
    """Build and kernel caches at fixed paths inside the checkout; the
    port's tables at their documented defaults."""
    build = os.path.join(ROOT, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ.pop("CLUSTER_GENERATOR_TPU_CONFIG", None)


def _power_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
        return out.stdout.strip().splitlines()[0].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def _plain(value):
    """``value`` with every non-finite float as a string, so that the line
    stays JSON that any reader takes."""
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, float) and not math.isfinite(value):
        return repr(value)
    return value


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    sys.path.insert(0, ROOT)
    import torch

    from portbench import harness

    _, cell, _, _, _ = harness.cell_of(ROOT, args.workload)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"portbench: {cell['chips']} CUDA card(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " found", file=sys.stderr)
        return 2
    result, lines = harness.run_cell(ROOT, args.workload, args.seed,
                                     args.seconds, bool(args.trace), "cuda",
                                     T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: loaded {found}: the run must not load JAX or "
              "the JAX package", file=sys.stderr)
        return 3
    checks = result.pop("checks")
    result["card"] = _power_line()
    result["checks"] = checks
    print(json.dumps(_plain(result)))
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
