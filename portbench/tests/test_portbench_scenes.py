"""The merger-scene cell's limits against its controls and two planted
faults: the plain reference put in the program's place and computed in the
precision below the configuration's (every float64 step in float32; the
DFs alone in float32; the draws and the gas mixing in bfloat16) comes out
not correct, and at the stated precision correct; so do a run whose DM
velocities are 0.1% off and one whose scenes mix their gas over the
neighbouring scene's halos.  At small sizes on the CPU;
``portbench/calibrate.py`` reads the same controls on the card at the
cell's own size."""

import pytest
import torch

from cluster_generator_tpu_torch import pipeline
from portbench.calibrate import controls
from portbench.tests._small_scenes import run_small_scenes

torch.set_num_threads(2)

CONTROLS = controls()


def reference_in_place(kw):
    """Each kept answer replaced by the reference at precision ``kw``."""
    def hook(drv):
        answers = drv.answers
        drv.answers = lambda: [(ref(**kw), ref) for _, ref in answers()]
    return hook


@pytest.mark.parametrize("control", sorted(CONTROLS))
def test_the_control_fails_the_scenes_limits(monkeypatch, control):
    result, lines = run_small_scenes(
        monkeypatch, hook=reference_in_place(CONTROLS[control]))
    assert not result["correct"], lines


def test_the_reference_in_the_programs_place_is_correct(monkeypatch):
    result, lines = run_small_scenes(monkeypatch,
                                     hook=reference_in_place({}))
    assert result["correct"], lines


def altered(drv):
    """Every DM velocity of every batch 0.1% off."""
    batches = drv._batches

    def broken(*a, **kw):
        for b0, out in batches(*a, **kw):
            yield b0, dict(out, dm_velocity=out["dm_velocity"] * 1.001)
    drv._batches = broken


def test_dm_velocities_a_tenth_of_a_percent_off_fail(monkeypatch):
    result, lines = run_small_scenes(monkeypatch, hook=altered)
    assert not result["correct"], lines
    assert result["checks"]["vel_p999"]["value"] == pytest.approx(1e-3,
                                                                  rel=0.05)


def test_gas_mixed_over_the_neighbouring_scenes_halos_fails(monkeypatch):
    mix = pipeline._mix_gas

    def neighbours(pos, fields, centers, velocities, dtype):
        # each scene's gas against the halos of the scene before it
        def roll(t):
            return torch.roll(t, 1, dims=0)
        return mix(pos, {k: roll(v) for k, v in fields.items()},
                   roll(centers), roll(velocities), dtype)

    def hook(drv):
        monkeypatch.setattr(pipeline, "_mix_gas", neighbours)

    result, lines = run_small_scenes(monkeypatch, hook=hook)
    assert not result["correct"], lines
    assert result["checks"]["gas_p999"]["value"] > 1.0
