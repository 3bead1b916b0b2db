"""The port's tooling against the JAX package's, on the CPU: the stage
timers and ``StageTimes``, the profiler trace (a Chrome trace written on
the CPU), ``device_memory_stats``, ``nan_guard`` (raises at the op that
makes a NaN and names it; clean math passes), ``validate_model_fields``
(the JAX package's list and message on the same clean and perturbed
fields) and ``ClusterModel.plot`` (on the Agg backend: the same line data,
limits and labels as the JAX package's plot of the same model)."""

import json
import os

import matplotlib
import numpy as np
import pytest
import torch

from cluster_generator_tpu.core import debug as JDebug
from cluster_generator_tpu_torch.convert import cluster_model_from_numpy
from cluster_generator_tpu_torch.core import debug, profiling
from cluster_generator_tpu_torch.core.interp import cubic_spline, spline_eval

matplotlib.use("Agg")
torch.set_num_threads(1)


def test_stage_accumulates_and_waits_only_for_cuda(monkeypatch):
    def no_sync(*a):
        raise AssertionError("a CPU tensor must not synchronize a card")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    times = profiling.StageTimes()
    for _ in range(2):
        holder = []
        with profiling.stage("spline", holder, accumulate=times, log=False):
            x = torch.linspace(1.0, 2.0, 64, dtype=torch.float64)
            holder.append({"sp": cubic_spline(x, x ** 2),
                           "more": [x, (x, None)]})
        assert len(list(profiling._tensors(holder))) == 7
    with profiling.stage("empty", accumulate=times):
        pass
    rep = times.report()
    assert set(rep) == {"spline", "empty"}
    assert rep["spline"] > 0.0 and rep["empty"] >= 0.0
    assert list(rep) == sorted(rep, key=lambda k: -rep[k])
    # the timer stops (and accumulates) when the stage raises
    with pytest.raises(ValueError):
        with profiling.stage("fails", accumulate=times, log=False):
            raise ValueError
    assert "fails" in times.times


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = tmp_path / "trace"
    with profiling.trace(str(logdir)) as prof:
        a = torch.randn(64, 64, dtype=torch.float64)
        (a @ a).sum()
    path = logdir / "trace.json"
    assert path.exists()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::mm" in names
    assert any(k.key == "aten::mm" for k in prof.key_averages())


def test_device_memory_stats():
    stats = profiling.device_memory_stats()
    if not torch.cuda.is_available():
        assert stats == {"cpu": None}
    else:
        assert set(stats) == {f"cuda:{i}"
                              for i in range(torch.cuda.device_count())}
        assert all("allocated_bytes.all.current" in s
                   for s in stats.values())


def test_nan_guard_raises_at_the_op_and_passes_clean_math():
    x = torch.linspace(1.0, 2.0, 32, dtype=torch.float64)
    with debug.nan_guard():
        sp = cubic_spline(x, torch.log(x))
        clean = spline_eval(sp, x * 1.5)
        assert torch.isfinite(clean).all()
        with pytest.raises(FloatingPointError, match="aten.log"):
            torch.log(x - 1.5)
        with pytest.raises(FloatingPointError, match="aten.sqrt"):
            (1.0 - x).sqrt_()
        # an integer op and a NaN-free inf pass
        torch.arange(4) * 2
        assert torch.isinf(1.0 / (x - 1.0))[0]
    # off outside the scope
    assert torch.isnan(torch.log(x - 1.5)).any()


def test_validate_model_fields_matches_jax(canonical_model):
    fields = {k: np.array(v) for k, v in canonical_model.fields.items()}
    t = {k: torch.as_tensor(v) for k, v in fields.items()}
    assert debug.validate_model_fields(t) == [] \
        == JDebug.validate_model_fields(fields)
    bad = {k: v.copy() for k, v in fields.items()}
    bad["density"][3] = -1.0
    bad["temperature"][5] = np.nan
    bad["total_mass"][10] = bad["total_mass"][9] * 0.5
    bad["gravitational_potential"][0] = 1.0
    bad["dark_matter_density"][7] = -1e-30
    want = JDebug.validate_model_fields(bad, raise_on_error=False)
    assert len(want) == 6
    got = debug.validate_model_fields(
        {k: torch.as_tensor(v) for k, v in bad.items()},
        raise_on_error=False)
    assert got == want
    with pytest.raises(ValueError) as jerr:
        JDebug.validate_model_fields(bad)
    with pytest.raises(ValueError) as terr:
        debug.validate_model_fields(bad)  # numpy arrays work too
    assert str(terr.value) == str(jerr.value)


def test_plot_matches_jax(canonical_model):
    import matplotlib.pyplot as plt

    tm = cluster_model_from_numpy(canonical_model.fields, device="cpu")
    try:
        for field, kw in (("density", {}),
                          ("temperature", {"r_min": 1.0, "r_max": 3000.0}),
                          ("total_mass", {"r_max": 1e4})):
            fig, ax = tm.plot(field, color="C1", **kw)
            jfig, jax_ax = canonical_model.plot(field, color="C1", **kw)
            np.testing.assert_array_equal(ax.lines[0].get_xydata(),
                                          jax_ax.lines[0].get_xydata())
            assert ax.get_xscale() == ax.get_yscale() == "log"
            assert ax.get_xlabel() == jax_ax.get_xlabel() == "Radius (kpc)"
            assert ax.get_ylabel() == jax_ax.get_ylabel()
            assert ax.get_xlim() == jax_ax.get_xlim()
            assert ax.lines[0].get_color() == "C1"
        # onto a given figure and axes
        fig2, ax2 = tm.plot("density", fig=fig, ax=ax)
        assert fig2 is fig and ax2 is ax and len(ax.lines) == 2
        fig.savefig(os.devnull, format="png")
    finally:
        plt.close("all")
