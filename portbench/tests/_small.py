"""The cells at sizes a CPU test run holds: the same configurations,
traffic and limits, with fewer particles and batches."""

from portbench import harness

_CELL_OF = harness.cell_of


def small_cell_of(root, name):
    bench, cell, config, traffic, limits = _CELL_OF(root, name)
    traffic = dict(traffic)
    if traffic["entry"] == "merger_ic_fused":
        traffic.update(particles={"gas": 3000, "dm": 2400, "star": 600},
                       check_within=3, trace_calls=3)
    else:
        traffic.update(batch_size=4,
                       particles={"dm": 500, "gas": 400, "star": 100},
                       ensemble_batches=16, check_within=3, check_clusters=2,
                       trace_calls=3)
    return bench, cell, config, traffic, limits


def run_small(monkeypatch, name, seed=2**31 + 11, trace=False, hook=None,
              seconds=0.5):
    """One run of cell ``name`` on the CPU at the small sizes."""
    monkeypatch.setattr(harness, "cell_of", small_cell_of)
    return harness.run_cell(harness.HERE + "/..", name, seed, seconds, trace,
                            "cpu", driver_hook=hook)
