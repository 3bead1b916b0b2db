"""The control: the plain reference put in the program's place, computed in
the precision below the configuration's (every float64 step in float32; the
DFs alone in float32, as a float32 Abel-sum kernel would; the float32 draws
and gas mixing in bfloat16), comes out not correct under each cell's
limits.  At small sizes on the CPU;
``portbench/calibrate.py`` reads the same controls on the card at the
cells' own sizes."""

import pytest
import torch

from portbench.calibrate import controls
from portbench.reference import paths
from portbench.tests._small import run_small

torch.set_num_threads(2)

CONTROLS = controls()


def merger_control(kw):
    def hook(drv):
        drv.call = lambda h: drv.reference(h, **kw)
    return hook


def datagen_control(kw):
    def hook(drv):
        cfg = drv.cfg

        def batches(M200, conc, counts, batch_size, num_points, seed,
                    device):
            for b0 in range(0, M200.shape[0], batch_size):
                sl = slice(b0, b0 + batch_size)
                yield b0, paths.datagen_batch(
                    M200[sl].double().numpy(), conc[sl].double().numpy(),
                    counts, seed(b0).initial_seed(), batch_size, num_points,
                    cfg["speed_tables"], cfg["radius_quantiles"], cfg["z"],
                    device, **kw)
        drv._batches = batches
    return hook


@pytest.mark.parametrize("control", sorted(CONTROLS))
@pytest.mark.parametrize("name", ["merger2h-1e5", "datagen-cfg5c-1e6-b64"])
def test_the_control_fails_the_limits(monkeypatch, name, control):
    make = merger_control if name.startswith("merger") else datagen_control
    result, lines = run_small(monkeypatch, name,
                              hook=make(CONTROLS[control]))
    assert not result["correct"], lines


@pytest.mark.parametrize("name", ["merger2h-1e5", "datagen-cfg5c-1e6-b64"])
def test_the_reference_in_the_programs_place_is_correct(monkeypatch, name):
    make = merger_control if name.startswith("merger") else datagen_control
    result, lines = run_small(monkeypatch, name, hook=make({}))
    assert result["correct"], lines
