"""The random magnetic fields as the cell ``field-512`` drives them, on the
CPU at small sizes.

* The port's B and A against the benchmark's plain reference
  (``portbench/reference/field.py``: full complex transforms of whole
  components, the rms and the rescale summed in real space), in float64, on
  a cube and on a padded grid with odd and even axes.
* The program's white noise is the reference's redraw from the same seed,
  element for element.
* The stage marks of a field call (noise, fft, kspace, fft, end), the
  radial route's, the marks' numbers in ``stage_marks.cu``, and the host's
  set-up of a field named ``cg.host.inputs``.
* The cell at a small size through the benchmark's harness: correct, while
  each control (the reference in a lower precision) and two planted faults
  (the vector potential's Nyquist rule dropped; the projection left out)
  fail its limit.
* ``ClusterField.write_file`` hands its six arrays over in one
  ``core.staging.to_host`` call and writes the values and attributes it
  wrote before.
"""

import os
import re

import numpy as np
import pytest
import torch
from scipy.io import FortranFile
from torch.profiler import ProfilerActivity, profile

import cluster_generator_tpu_torch as cg
import cluster_generator_tpu_torch.fields.grf as TG
from cluster_generator_tpu_torch.core import profiling
from portbench import harness
from portbench.calibrate import controls
from portbench.reference import compare
from portbench.reference import field as R
from portbench.yardstick import field_bytes
from tests.test_torch_tracing import _no_overlap, _spans

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "field-512"
CONFIG = harness.cell_of(ROOT, CELL)[2]
CLASSES = {"B": cg.RandomMagneticField, "A": cg.RandomMagneticVectorPotential}
GRIDS = {"cube": ((32, 32, 32), 0.0), "padded": ((24, 30, 33), 0.1)}
# half against full spectra and the power sums in another order: each
# component rounds at ~1e-16 per pass, and a row is scaled by its own
# largest value, which can be a few times below the component's
TOL = 1e-12


def _config(dims, padding):
    return dict(CONFIG, ddims=list(dims), padding=padding)


def _field(kind, cfg, seed, **kw):
    return CLASSES[kind](cfg["left_edge_kpc"], cfg["right_edge_kpc"],
                         cfg["ddims"], cfg["l_min_kpc"], cfg["l_max_kpc"],
                         cfg["B_rms_gauss"], padding=cfg["padding"],
                         alpha=cfg["alpha"],
                         prng=torch.Generator().manual_seed(seed),
                         device="cpu", **kw)


def test_the_configuration_states_its_deployment_and_rules():
    """What ``portbench/tests/test_portbench_manifest.py`` checks of a
    cluster model's configuration, for the field's: its manifest entry,
    nothing cut, float64, the grid of bench_configs.py's field, and every
    rule the reference follows stated."""
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    entry, = [c for c in bench["configs"] if c["name"] == "bfield-512"]
    assert entry["file"] == "portbench/configs/bfield-512.json"
    assert CONFIG["name"] == entry["name"] and CONFIG["reduced"] == []
    assert entry["reduced"] == []
    assert CONFIG["precision"] == {"field": "float64",
                                   "spectra": "complex128"}
    assert (CONFIG["ddims"], CONFIG["padding"]) == ([512] * 3, 0.0)
    assert (CONFIG["l_min_kpc"], CONFIG["l_max_kpc"]) == (50.0, 500.0)
    assert CONFIG["alpha"] == -11.0 / 3.0
    assert all(isinstance(CONFIG[k], str) and CONFIG[k] for k in (
        "grid", "noise", "spectrum", "normalisation", "projection",
        "vector_potential", "guarantees"))


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("kind", sorted(CLASSES))
def test_the_port_equals_the_plain_reference(kind, grid):
    cfg = _config(*GRIDS[grid])
    f = _field(kind, cfg, 7)
    got = {f"field/{c}": getattr(f, f"g{c[-1]}").numpy() for c in f.comps}
    want = R.field(cfg, kind == "A", 7, "cpu", f.comps)
    assert all(a.shape == tuple(f.ddims) for a in want.values())
    assert compare.against(got, want)["field_max"] <= TOL


@pytest.mark.parametrize("spectra", [True, False])
def test_the_programs_noise_is_the_references_redraw(spectra):
    cfg = _config(*GRIDS["padded"])
    dims, _ = R.grid(cfg)
    draw = TG._noise_drawer(None, torch.Generator().manual_seed(3), dims,
                            torch.float64, "cpu", spectra=spectra)
    got = TG._head(draw(None), dims)
    assert torch.equal(got, R.noise(cfg, 3, "cpu"))


@pytest.fixture
def marks(monkeypatch):
    got = []
    monkeypatch.setattr(profiling, "_mark",
                        lambda name, device: got.append(name))
    return got


@pytest.mark.parametrize("kind", sorted(CLASSES))
def test_a_field_call_marks_its_stages_in_order(marks, kind):
    _field(kind, _config((16, 16, 16), 0.0), 1)
    _field(kind, _config((16, 16, 16), 0.0), 2)
    assert marks == ["noise", "fft", "kspace", "fft", "end"] * 2
    assert profiling._open_stages() == []


def test_the_radial_route_marks_the_same_stages(marks):
    r = np.logspace(0, 4, 64)
    cg.RadialRandomMagneticVectorPotential(
        [0.0] * 3, [1000.0] * 3, (16, 16, 16), 50.0, 500.0, [500.0] * 3,
        (r, 1e-6 * (1.0 + r / 300.0) ** -1.5), device="cpu")
    assert marks[:3] == ["noise", "kspace", "fft"]
    assert marks[-2:] == ["kspace", "end"] and marks.count("end") == 1
    # six transforms to shape, six to project, six for the potential, each
    # handing back to the arithmetic around it
    assert marks.count("fft") == 18
    assert all(b == "kspace" for a, b in zip(marks, marks[1:]) if a == "fft")


def test_the_marks_keep_their_numbers():
    src = open(os.path.join(ROOT, "cluster_generator_tpu_torch", "ops",
                            "csrc", "stage_marks.cu")).read()
    cases = {int(i): name for i, name in
             re.findall(r"case (\d+): cg_stage_(\w+)<<<", src)}
    assert cases == dict(enumerate(profiling.STAGES))
    assert profiling.STAGES[:7] == ("models", "dfs", "tables", "draws", "mix",
                                    "export", "end")
    for name in ("end", "unknown"):
        with pytest.raises(ValueError):
            profiling.device_mark(name, torch.zeros(1))


def test_a_field_names_its_host_inputs():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _field("B", _config((16, 16, 16), 0.0), 1)
        _field("A", _config((16, 16, 16), 0.0), 2)
    spans = _spans(prof)
    # one for the field's own set-up, one for its program's inputs
    assert [s[0] for s in spans] == ["cg.host.inputs"] * 4
    assert _no_overlap(spans)


def test_the_byte_counts_of_the_cells_grid():
    assert field_bytes.fft_bytes((512,) * 3, 8) == 2 * 3 * (
        512 ** 3 * 8 + 512 * 512 * 257 * 16)
    assert field_bytes.kspace_bytes((512,) * 3, 8) == 6 * 512 * 512 * 257 * 16
    assert round(field_bytes.fft_bytes((512,) * 3, 8) / 1e9, 2) == 12.91
    assert round(field_bytes.kspace_bytes((512,) * 3, 8) / 1e9, 2) == 6.47


# ----------------------------------------------------- the cell, small
def _small_cell_of(root, name):
    bench, cell, config, traffic, limits = _CELL_OF(root, name)
    if name == CELL:
        config = _config((32, 32, 32), config["padding"])
        traffic = dict(traffic, check_within=4, trace_calls=4)
    return bench, cell, config, traffic, limits


_CELL_OF = harness.cell_of


def _run_small(monkeypatch, hook=None, trace=False):
    monkeypatch.setattr(harness, "cell_of", _small_cell_of)
    return harness.run_cell(ROOT, CELL, 2**31 + 11, 0.5, trace, "cpu",
                            driver_hook=hook)


def test_the_cell_at_a_small_size_is_correct(monkeypatch):
    result, lines = _run_small(monkeypatch, trace=True)
    assert result["correct"], lines
    assert result["attempted"] == 4 and result["failed"] == 0
    assert result["numbers"]["field_max"] <= TOL
    assert result["metrics"]["host_ms_per_call.field"]["value"] > 0.0


def _reference_in_place(kw):
    def hook(drv):
        answers = drv.answers
        drv.answers = lambda: [(ref(**kw), ref) for _, ref in answers()]
    return hook


@pytest.mark.parametrize("control", sorted(controls()))
def test_each_control_fails_the_limit(monkeypatch, control):
    result, lines = _run_small(monkeypatch,
                               _reference_in_place(controls()[control]))
    assert not result["correct"], lines


def test_the_reference_in_the_programs_place_is_correct(monkeypatch):
    result, lines = _run_small(monkeypatch, _reference_in_place({}))
    assert result["correct"], lines


FAULTS = {
    # i k g~ at a Nyquist entry kept, where the real field has only the
    # Hermitian part
    "nyquist": ("_odd_waves", lambda k: np.array(k, dtype=np.float64)),
    "projection": ("_div_clean_k", lambda gx, gy, gz, *kd: (gx, gy, gz)),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_fails_the_limit(monkeypatch, fault):
    name, broken = FAULTS[fault]
    monkeypatch.setattr(TG, name, broken)
    result, lines = _run_small(monkeypatch)
    assert not result["correct"], lines
    assert result["numbers"]["field_max"] > 1e3 * TOL


# ----------------------------------------------------------- the files
@pytest.mark.parametrize("fmt", ["hdf5", "fortran"])
def test_write_file_hands_over_once_and_writes_the_same(tmp_path, monkeypatch,
                                                        fmt):
    handed = []
    to_host = TG.to_host

    def counted(tensors):
        handed.append(len(tensors))
        return to_host(tensors)

    monkeypatch.setattr(TG, "to_host", counted)
    f = _field("A", _config((12, 10, 9), 0.1), 4)
    kw = dict(length_unit="Mpc", field_unit="uG")
    path = str(tmp_path / f"a.{fmt}")
    f.write_file(path, format=fmt, **kw)
    assert handed == [6]
    names = ["x", "y", "z"] + f.comps
    want = {n: f._output_value(n, kw["length_unit"], kw["field_unit"])
            for n in names}
    if fmt == "hdf5":
        import h5py

        with h5py.File(path, "r") as h:
            for n in names:
                a, unit = want[n]
                assert np.array_equal(h[n][()], a.numpy())
                assert h[n].attrs["units"] == unit
            assert h.attrs["name"] == "magnetic_vector_potential"
            assert h.attrs["units"] == f.units
            assert h.attrs["vector_potential"] == 1
            assert h.attrs["divergence_clean"] == 1
    else:
        with FortranFile(path, "r") as h:
            assert h.read_ints(np.int64)[0] == f.x.numel()
            for n in names:
                assert np.array_equal(h.read_reals(np.float64),
                                      want[n][0].numpy().reshape(-1))
