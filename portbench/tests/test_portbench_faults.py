"""A run with the timed path broken underneath comes out not correct, once
for each fault the cells can have; a sound run comes out correct.  The
harness's look for a card is skipped: the runs are on the CPU, at small
sizes.  (The cells run on one card, so no exchange between cards can be
left out.)"""

import copy

import numpy as np
import pytest
import torch

from portbench.tests._small import run_small

torch.set_num_threads(2)
MERGER, DATAGEN = "merger2h-1e7", "datagen-cfg5c-b256"


def merger_fault(kind):
    """Wrap the driver's program call: ``stale`` hands over the previous
    IC (a program that returns its state unchanged), ``half`` the first half
    of every array twice, ``altered`` every DM velocity 0.1% off."""
    def hook(drv):
        call, last = drv.call, {}

        def broken(h):
            out = call(h)
            if kind == "stale":
                prev = last.get("out")
                last["out"] = copy.deepcopy(out)
                return prev if prev is not None else out
            if kind == "half":
                return {k: _halved(v) for k, v in out.items()}
            out["dm/particle_velocity"] = out["dm/particle_velocity"] * 1.001
            return out
        drv.call = broken
    return hook


def _halved(a):
    if a.shape[0] < 2:
        return a
    n = a.shape[0] // 2
    b = a.copy()
    b[a.shape[0] - n:] = a[:n]
    return b


def datagen_fault(kind):
    """Wrap ``datagen_batches``: ``stale`` yields the previous batch's
    arrays, ``half`` leaves the second half of the batch's clusters out
    (the first half's in their place), ``altered`` moves every gas energy
    by 0.1%."""
    def hook(drv):
        batches = drv._batches

        def broken(*a, **kw):
            prev = None
            for b0, out in batches(*a, **kw):
                if kind == "stale":
                    cur = {sp: tuple(t.clone() for t in v)
                           for sp, v in out.items()}
                    out, prev = (prev if prev is not None else cur), cur
                elif kind == "half":
                    out = {sp: tuple(_halved_t(t) for t in v)
                           for sp, v in out.items()}
                else:
                    pos, e, m = out["gas"]
                    out = dict(out, gas=(pos, e * 1.001, m))
                yield b0, out
        drv._batches = broken
    return hook


def _halved_t(t):
    n = t.shape[0] // 2
    return torch.cat([t[:t.shape[0] - n], t[:n]])


@pytest.mark.parametrize("name", [MERGER, DATAGEN])
def test_a_sound_run_is_correct(monkeypatch, name):
    result, lines = run_small(monkeypatch, name)
    assert result["correct"], lines
    assert list(result)[-1] == "checks"
    assert result["attempted"] >= 1 and result["failed"] == 0


@pytest.mark.parametrize("kind", ["stale", "half", "altered"])
@pytest.mark.parametrize("name", [MERGER, DATAGEN])
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, kind):
    hook = (merger_fault if name == MERGER else datagen_fault)(kind)
    result, lines = run_small(monkeypatch, name, hook=hook)
    assert not result["correct"], lines
    assert any("FAILED" in line for line in lines) or not all(
        np.isfinite(v) for v in result["numbers"].values())
