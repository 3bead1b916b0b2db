"""The IC-scene cell's limits against its controls: the plain reference
put in the program's place and computed in the precision below the
configuration's (every float64 step in float32; the DFs alone in float32;
the draws and the gas mixing in bfloat16) comes out not correct, and at
the stated precision correct.  At small sizes on the CPU;
``portbench/calibrate.py`` reads the same controls on the card at the
cell's own size."""

import pytest
import torch

from portbench.calibrate import controls
from portbench.tests._small_scene import run_small_scene

torch.set_num_threads(2)

CONTROLS = controls()


def reference_in_place(kw):
    """Each kept answer replaced by the reference at precision ``kw``."""
    def hook(drv):
        answers = drv.answers
        drv.answers = lambda: [(ref(**kw), ref) for _, ref in answers()]
    return hook


@pytest.mark.parametrize("control", sorted(CONTROLS))
def test_the_control_fails_the_scene_limits(monkeypatch, control):
    result, lines = run_small_scene(
        monkeypatch, hook=reference_in_place(CONTROLS[control]))
    assert not result["correct"], lines


def test_the_reference_in_the_programs_place_is_correct(monkeypatch):
    result, lines = run_small_scene(monkeypatch,
                                    hook=reference_in_place({}))
    assert result["correct"], lines
