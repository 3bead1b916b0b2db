"""The merger-scene cell at sizes a CPU test run holds: the same
configuration, traffic and limits, with fewer scenes a batch, a few
thousand particles a halo and fewer calls checked and traced.  A few
thousand, not a few hundred: ``pos_p999`` is then a 99.9th percentile of
some 8e4 errors, as the cell's is of 8e5, and not the eighth largest of
8e3, which reads up to 1.2e-6 against the limit of 1e-6 where the cell's
own reads 6.9e-7 to 8.4e-7."""

from portbench import harness

_CELL_OF = harness.cell_of
NAME = "scenes-cfg6-b64"


def small_scenes_cell_of(root, name):
    bench, cell, config, traffic, limits = _CELL_OF(root, name)
    if traffic["entry"] == "merger_scene_batches":
        traffic = dict(traffic, batch_size=4,
                       particles={"gas": [4000, 4000], "dm": [5000, 5000],
                                  "star": [1000, 1000]},
                       ensemble_batches=8, check_within=3, check_scenes=2,
                       trace_calls=3)
    return bench, cell, config, traffic, limits


def run_small_scenes(monkeypatch, seed=2**31 + 11, trace=False, hook=None,
                     seconds=0.5):
    """One run of the merger-scene cell on the CPU at the small sizes."""
    monkeypatch.setattr(harness, "cell_of", small_scenes_cell_of)
    return harness.run_cell(harness.HERE + "/..", NAME, seed, seconds, trace,
                            "cpu", driver_hook=hook)
