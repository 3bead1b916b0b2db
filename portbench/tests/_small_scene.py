"""The IC-scene cell at sizes a CPU test run holds: the same
configuration, traffic and limits, with fewer particles, two warm masses
a mass ratio and fewer calls checked and traced."""

from portbench import harness

_CELL_OF = harness.cell_of
NAME = "ic-scene-2h-1e7"


def small_scene_cell_of(root, name):
    bench, cell, config, traffic, limits = _CELL_OF(root, name)
    if traffic["entry"] == "cluster_ics_gadget":
        traffic = dict(traffic, particles={"gas": 3000, "dm": 2400,
                                           "star": 600},
                       warm_masses=2, check_within=3, trace_calls=3)
    return bench, cell, config, traffic, limits


def run_small_scene(monkeypatch, seed=2**31 + 11, trace=False, hook=None,
                    seconds=0.5):
    """One run of the IC-scene cell on the CPU at the small sizes."""
    monkeypatch.setattr(harness, "cell_of", small_scene_cell_of)
    return harness.run_cell(harness.HERE + "/..", NAME, seed, seconds, trace,
                            "cpu", driver_hook=hook)
