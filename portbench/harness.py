"""One run of one cell: set-up, the measured window, the correctness check
and the result line.

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json``; its configuration in the file the manifest names; its
traffic in ``portbench/traffic/<traffic>.json``, which names the driver of
its entry point, ``portbench/drivers/<entry>.py``; each metric's reader in
``portbench/metrics/<metric>.py`` (or, for ``<quantity>.<path>``,
``portbench/metrics/<quantity>.py``); the limits of the numbers compared in
``portbench/checks/<cell>.json``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
import time
import types

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "cluster_generator_tpu")
WINDOW = "portbench.window"


def load_json(path):
    with open(path) as f:
        return json.load(f)


def cell_of(root, name):
    """``(manifest, cell, config, traffic, limits)`` of the cell ``name``."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(has {sorted(cells)})")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = load_json(os.path.join(root, conf["file"]))
    traffic = load_json(os.path.join(HERE, "traffic",
                                     cell["traffic"] + ".json"))
    limits = load_json(os.path.join(HERE, "checks", name + ".json"))
    return bench, cell, config, traffic, limits


def metrics_for(bench, cell, trace):
    """The manifest's entries of the metrics this cell reports."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell["name"] in m["workloads"]]


def reader(name):
    """The ``read(ctx)`` of metric ``name``."""
    for stem in (name, name.split(".", 1)[0]):
        path = os.path.join(HERE, "metrics", stem + ".py")
        if os.path.exists(path):
            spec = importlib.util.spec_from_file_location(
                "portbench_metric_" + stem.replace(".", "_"), path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for metric {name!r} in "
                            f"{os.path.join(HERE, 'metrics')}")


def forbidden_modules():
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _traced(drv, dev, seconds, calls, ctx):
    """The traced run's windows: the first ``calls`` calls three times.
    First with no profiler, for the time the calls took on the host clock
    (``ctx.untraced_s``: the union of the calls' spans, each from its start
    to its arrays on the host, so that keeping the checked answers between
    calls does not count).  Then under the profiler's device activity
    alone: the device's events (``ctx.events``, all inside ``ctx.span``)
    and the window's length (``ctx.traced_s``), which the profiler
    stretches where the host's path is short.  Then under host and device
    activity: the host's calls into CUDA (``ctx.host_events`` inside
    ``ctx.host_span``, over ``ctx.host_calls`` calls).  Returns the
    second window's calls."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench.yardstick import trace as T

    cuda = dev.type == "cuda"
    _sync(dev)
    untraced = drv.window(seconds, max_calls=calls)
    _sync(dev)
    ctx.untraced_s = sum(t - s for s, t in T.union(
        (ts, te) for ts, te, _ in untraced))
    device_only = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    with profile(activities=device_only) as prof:
        t0 = time.perf_counter()
        records = drv.window(seconds, max_calls=calls)
        _sync(dev)
        ctx.traced_s = time.perf_counter() - t0
    ctx.events = [e for e in T.events_of(prof) if e.kind in T.DEVICE_KINDS]
    ctx.span = T.extent(ctx.events)
    del prof
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            ctx.host_calls = len(drv.window(seconds, max_calls=calls))
            _sync(dev)
    ctx.host_events = T.events_of(prof)
    ctx.host_span = T.span(ctx.host_events, WINDOW)
    del prof
    return records


def run_cell(root, name, seed, seconds, trace, device="cuda", t_start=None,
             driver_hook=None):
    """One run: returns ``(result dict, check lines)``.  ``t_start``: the
    host clock when the process started (set-up counts from there).
    ``driver_hook(driver)`` may wrap the driver's program calls (the tests
    plant faults with it)."""
    from cluster_generator_tpu_torch.core import compiled

    from portbench.reference import compare

    t_start = time.perf_counter() if t_start is None else t_start
    bench, cell, config, traffic, limits = cell_of(root, name)
    dev = torch.device(device)
    mod = importlib.import_module("portbench.drivers." + traffic["entry"])
    drv = mod.Driver(config, traffic, seed, dev)
    if driver_hook is not None:
        driver_hook(drv)
    drv.setup()
    _sync(dev)
    cuda = dev.type == "cuda"
    peak_setup = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    ctx = types.SimpleNamespace(unit=mod.UNIT, k1_shapes=drv.k1_shapes(),
                                device_name=(torch.cuda.get_device_name(dev)
                                             if cuda else "cpu"))
    t0 = time.perf_counter()
    ctx.setup_s = t0 - t_start
    if trace:
        records = _traced(drv, dev, seconds, traffic["trace_calls"], ctx)
    else:
        records = drv.window(seconds)
        _sync(dev)
    t1 = max(te for _, te, _ in records)
    ctx.records, ctx.window_s = records, t1 - t0
    ctx.n_calls = len(records)
    ctx.peak_bytes = torch.cuda.max_memory_allocated(dev) if cuda else 0

    result = {"correct": False, "attempted": len(records), "failed": 0,
              "metrics": {}, "device": {
                  "platform": "gpu" if cuda else "cpu",
                  "kind": ctx.device_name, "count": 1,
                  "memory_peak_bytes": int(max(peak_setup, ctx.peak_bytes))}}
    for m in metrics_for(bench, cell, trace):
        v = reader(m["name"])(ctx)
        if v is not None:
            result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
    if trace:
        from portbench.yardstick import trace as T

        result["device"]["busy_s"] = T.busy_us(ctx.events, ctx.span) / 1e6
        result["device"]["window_s"] = ctx.traced_s
        result["breakdown"] = {
            "device_ops": T.device_ops(ctx.events, ctx.span),
            "idle_gaps": T.gap_causes(ctx.host_events, ctx.host_span)}
        del ctx.events, ctx.host_events

    # the program's state is freed before the reference runs
    compiled.clear()
    if cuda:
        torch.cuda.empty_cache()
    with torch.no_grad():
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            answers = drv.answers()
            numbers = compare.worst(compare.against(got, ref())
                                    for got, ref in answers)
            n_checked = len(answers)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
    checks, lines = {}, []
    ok = n_checked == traffic["check_answers"] and all(
        math.isfinite(v) for v in numbers.values())
    for key, lim in limits["limits"].items():
        v = numbers.get(key, math.inf)
        passed = v <= lim["limit"]
        ok = ok and passed
        checks[key] = {"value": v, "limit": lim["limit"]}
        lines.append(f"check {key}: {v!r} limit {lim['limit']!r} "
                     f"{'ok' if passed else 'FAILED'}")
    lines.append(f"check answers compared: {n_checked} of "
                 f"{traffic['check_answers']}; every number finite: "
                 f"{all(math.isfinite(v) for v in numbers.values())}")
    result["correct"] = bool(ok)
    result["numbers"] = numbers
    result["checks"] = checks
    return result, lines
