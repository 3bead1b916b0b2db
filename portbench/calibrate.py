"""The readings the limits of ``portbench/checks/<cell>.json`` are set from,
on the card, at the cell's own size, in one process.

    python3 portbench/calibrate.py --workload <name> --seeds S1,S2,... \\
        [--control-seeds S1,S2,...] [--seconds 3]

For each seed, one run of the cell as ``run.py`` makes it (a window of
``--seconds``, then the check): one JSON line with the numbers compared and
the end-to-end metrics.  For each control seed, after the run, the
reference put in the program's place and computed in a lower precision,
held against the reference at the stated one on the same answers: every
float64 step in float32 (``models_f32``), and the float64 DFs alone in
float32 (``dfs_f32``, the step a float32 Abel-sum kernel would take), and
the float32 draws and gas mixing in bfloat16 (``particles_bf16``).  A
control has to fail the limits.  The benchmark's own runs run no control.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def controls():
    """Each control's precision arguments of the reference."""
    import numpy as np
    import torch

    return {"models_f32": {"dt": np.float32},
            "dfs_f32": {"df_dt": np.float32},
            "particles_bf16": {"pdt": torch.bfloat16}}


def control_numbers(driver, **kw):
    """The numbers of a control against the reference on the driver's
    kept answers."""
    import torch

    from portbench.reference import compare

    readings = []
    with torch.no_grad():
        for _, ref in driver.answers():
            readings.append(compare.against(ref(**kw), ref()))
    return compare.worst(readings)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from portbench import harness
    from portbench.run import _environment

    _environment()
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    control_seeds = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in [int(s) for s in args.seeds.split(",")]:
        held = []
        t0 = time.perf_counter()
        result, _ = harness.run_cell(ROOT, args.workload, seed, args.seconds,
                                     False, "cuda", t0,
                                     driver_hook=held.append)
        line = {"workload": args.workload, "seed": seed,
                "correct": result["correct"], "numbers": result["numbers"],
                "metrics": {k: v["value"]
                            for k, v in result["metrics"].items()}}
        if seed in control_seeds:
            for name, kw in controls().items():
                line[name] = control_numbers(held[0], **kw)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
